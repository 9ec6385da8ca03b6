"""The XLA à-trous decomposition (ops/iuwt.decompose) against a plain NumPy
à-trous reference (``iuwt_decomposition.h:100-119,199-261``: the 5-tap
B3-spline with tap spacing 2^scale - 1 and zero boundary)."""

import numpy as np
import jax.numpy as jnp
import pytest

from radler_tpu.ops.iuwt import decompose, iuwt_convolve

_H = np.array([1, 4, 6, 4, 1], np.float64) / 16.0


def _np_conv_axis(img, scale, axis):
    dist = (1 << scale) - 1
    out = np.zeros_like(img)
    n = img.shape[axis]
    for k, h in enumerate(_H):
        shift = (k - 2) * dist
        src = np.take(img, np.clip(np.arange(n) + shift, 0, n - 1), axis=axis)
        valid = (np.arange(n) + shift >= 0) & (np.arange(n) + shift < n)
        shape = [1] * img.ndim
        shape[axis] = n
        out += h * src * valid.reshape(shape)
    return out


def _np_convolve(img, scale):
    return _np_conv_axis(_np_conv_axis(img, scale, 1), scale, 0)


def _np_decompose(img, n_scales):
    coeffs = []
    i0 = img.astype(np.float64)
    i1 = i0
    for s in range(n_scales):
        i1 = _np_convolve(i0, s + 1)
        i2 = _np_convolve(i1, s + 1)
        coeffs.append(i0 - i2)
        i0 = i1
    coeffs.append(i1)
    return np.stack(coeffs)


@pytest.mark.parametrize("n_scales", [1, 3, 5])
@pytest.mark.parametrize("shape", [(200, 300), (256, 256)])
def test_decompose_matches_numpy(n_scales, shape):
    img = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got = np.asarray(decompose(jnp.asarray(img), n_scales))
    ref = _np_decompose(img, n_scales)
    assert got.shape == (n_scales + 1,) + shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_convolve_matches_numpy_at_large_dilation():
    img = np.random.default_rng(4).standard_normal((64, 80)).astype(np.float32)
    for scale in (1, 4, 6):  # tap spacing 1, 15, 63: taps leave the image
        got = np.asarray(iuwt_convolve(jnp.asarray(img), scale))
        np.testing.assert_allclose(got, _np_convolve(img, scale), atol=1e-5)
