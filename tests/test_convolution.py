"""FFT convolution wrappers (ops/convolution.py) against numpy.fft, on the
shapes the padded convolutions and the fused multiscale loop use."""

import numpy as np
import jax.numpy as jnp
import pytest

from radler_tpu.ops import convolution as conv

SHAPES = [
    (64, 64),
    (128, 96),
    (256, 256),
    (3, 300, 288),  # batched, mixed radix
    (2, 2, 160, 128),
    (2400, 300),  # 7-smooth sizes used by padded convolutions
]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_numpy(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = np.asarray(conv.forward_fft2(jnp.asarray(x)))
    ref = np.fft.rfft2(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-6


@pytest.mark.parametrize("shape", SHAPES)
def test_inverse_matches_numpy(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    spec = np.fft.rfft2(x).astype(np.complex64)
    got = np.asarray(conv.inverse_fft2_real(jnp.asarray(spec), shape[-2:]))
    ref = np.fft.irfft2(spec, s=shape[-2:])
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-6


@pytest.mark.parametrize(
    "shape,padded",
    [
        ((100, 120), (189, 210)),
        ((64, 64), (126, 150)),
        ((200, 200), (250, 250)),
        ((50, 60), (90, 90)),
    ],
)
def test_forward_padded_matches_numpy(shape, padded):
    H, W = shape
    Ph, Pw = padded
    top, left = Ph // 2 - H // 2, Pw // 2 - W // 2
    x = np.random.default_rng(2).standard_normal((3, H, W)).astype(np.float32)
    xp = np.zeros((3, Ph, Pw), np.float32)
    xp[:, top : top + H, left : left + W] = x
    ref = np.fft.rfft2(xp)
    got = np.asarray(conv.forward_fft2_padded(jnp.asarray(x), padded))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-6


@pytest.mark.parametrize(
    "shape,padded", [((100, 120), (189, 210)), ((50, 60), (90, 90))]
)
def test_inverse_trimmed_matches_numpy(shape, padded):
    H, W = shape
    Ph, Pw = padded
    top, left = Ph // 2 - H // 2, Pw // 2 - W // 2
    spec = np.fft.rfft2(
        np.random.default_rng(3).standard_normal((2, Ph, Pw))
    ).astype(np.complex64)
    ref = np.fft.irfft2(spec, s=(Ph, Pw))[:, top : top + H, left : left + W]
    got = np.asarray(
        conv.inverse_fft2_real_trimmed(jnp.asarray(spec), padded, shape)
    )
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-6


def _np_centered_conv(img, ker):
    h, w = img.shape[-2:]
    k = np.roll(ker, (-(h // 2), -(w // 2)), axis=(-2, -1))
    return np.fft.irfft2(np.fft.rfft2(img) * np.fft.rfft2(k), s=(h, w))


def test_convolve_same_matches_numpy():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 96, 80)).astype(np.float32)
    ker = rng.normal(size=(96, 80)).astype(np.float32)
    got = np.asarray(conv.convolve_same(jnp.asarray(img), jnp.asarray(ker)))
    ref = _np_centered_conv(img, ker)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_padded_convolve_matches_numpy():
    rng = np.random.default_rng(5)
    img = rng.normal(size=(60, 70)).astype(np.float32)
    ker = np.zeros((60, 70), np.float32)
    ker[30, 35] = 1.0
    ker[28:33, 33:38] += 0.1
    got = np.asarray(
        conv.padded_convolve(jnp.asarray(img), jnp.asarray(ker), padded_shape=(90, 98))
    )
    ip = np.zeros((90, 98), np.float32)
    kp = np.zeros((90, 98), np.float32)
    ip[15:75, 14:84] = img
    kp[15:75, 14:84] = ker
    ref = _np_centered_conv(ip, kp)[15:75, 14:84]
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_batched_inverse_matches_per_plane():
    """The batched inverse equals inverses taken plane by plane (the
    property probe_batched_fft_accuracy checks on a device)."""
    rec = conv.probe_batched_fft_accuracy(n=3, size=64)
    assert rec["forward_rel_err"] < 1e-6
    assert rec["inverse_rel_err"] < 1e-6


def test_identity_spectrum_is_delta_kernel():
    spec = conv.identity_spectrum(32, 40)
    delta = np.zeros((32, 40), np.float32)
    delta[16, 20] = 1.0
    ref = np.asarray(conv.centered_embed_kernel_fft(jnp.asarray(delta), (32, 40)))
    np.testing.assert_allclose(np.asarray(spec), ref, atol=1e-6)
