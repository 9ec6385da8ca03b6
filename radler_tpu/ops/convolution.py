"""FFT convolution primitives.

TPU-native equivalent of the schaapcommon FFTW path used by the reference
(``PrepareConvolutionKernel`` + ``Convolve`` + ``PaddedConvolution``, called
from e.g. ``cpp/algorithms/subminor_loop.cc:195-218`` and
``cpp/algorithms/multiscale/multiscale_transforms.cc:11-23``).

All convolutions here are *centered*: the kernel's origin is pixel
``(H//2, W//2)``, matching the reference's PSF conventions.  Images are
zero-padded to a 7-smooth size (same policy as
``cpp/utils/fft_size_calculations.h``) to avoid wrap-around, convolved via
``jnp.fft.rfft2`` (XLA's batched FFT), and trimmed back.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.fft_size import calculate_good_fft_size


def forward_fft2(x: jnp.ndarray) -> jnp.ndarray:
    """rfft2 half-plane spectrum of a real image stack [..., H, W]."""
    return jnp.fft.rfft2(x)


def inverse_fft2_real(spec: jnp.ndarray, shape: Tuple[int, int]) -> jnp.ndarray:
    """Real inverse of a spectrum produced by :func:`forward_fft2`, batched
    over the leading dims (its accuracy against per-plane inverses is
    checked by :func:`probe_batched_fft_accuracy`).  Written as a complex
    inverse over rows followed by a real inverse over columns: XLA's CPU
    backend rejects a fused 2-D inverse whose operand arrives row-sharded
    with a transposed layout, and the two 1-D passes partition cleanly."""
    h, w = shape
    return jnp.fft.irfft(jnp.fft.ifft(spec, n=h, axis=-2), n=w, axis=-1)


def forward_fft2_padded(
    x: jnp.ndarray, padded_shape: Tuple[int, int]
) -> jnp.ndarray:
    """Spectrum of ``untrim(x, Ph, Pw)`` (centered zero-pad)."""
    if x.shape[-2:] == tuple(padded_shape):
        return forward_fft2(x)
    return jnp.fft.rfft2(untrim(x, *padded_shape))


def inverse_fft2_real_trimmed(
    spec: jnp.ndarray,
    padded_shape: Tuple[int, int],
    out_shape: Tuple[int, int],
) -> jnp.ndarray:
    """``trim(inverse_fft2_real(spec, (Ph, Pw)), H, W)``."""
    out = inverse_fft2_real(spec, padded_shape)
    if tuple(out_shape) == tuple(padded_shape):
        return out
    return trim(out, *out_shape)


def probe_batched_fft_accuracy(
    n: int = 8, size: int = 2048, seed: int = 0
) -> dict:
    """Measure batched-vs-per-plane FFT agreement on the live backend.

    :func:`inverse_fft2_real` runs batched inverses in one call; this probe
    checks that a batched transform agrees with the same transform mapped
    plane by plane.  Returns ``{"forward_rel_err": float,
    "inverse_rel_err": float}``: the max relative error of the batched op
    against the per-plane op on an [n, size, size] float32 stack.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, size, size)), jnp.float32)

    batched_f = jax.jit(jnp.fft.rfft2)(x)
    per_plane_f = jax.jit(lambda v: jax.lax.map(jnp.fft.rfft2, v))(x)
    scale_f = jnp.max(jnp.abs(per_plane_f))
    fwd_err = float(jnp.max(jnp.abs(batched_f - per_plane_f)) / scale_f)

    spec = per_plane_f
    batched_i = jax.jit(lambda s: jnp.fft.irfft2(s, s=(size, size)))(spec)
    per_plane_i = jax.jit(
        lambda s: jax.lax.map(lambda f: jnp.fft.irfft2(f, s=(size, size)), s)
    )(spec)
    scale_i = jnp.max(jnp.abs(per_plane_i))
    inv_err = float(jnp.max(jnp.abs(batched_i - per_plane_i)) / scale_i)
    return {"forward_rel_err": fwd_err, "inverse_rel_err": inv_err}


def identity_spectrum(h: int, w: int) -> jnp.ndarray:
    """Spectrum of the centered delta kernel (= flat ones) for (h, w)."""
    return jnp.ones((h, w // 2 + 1), jnp.complex64)


def untrim(image: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """Zero-pad ``image`` centered into a (height, width) canvas.

    Equivalent of ``aocommon::Image::Untrim``: the input center pixel
    ``(h//2, w//2)`` lands on the output center pixel ``(H//2, W//2)``.
    """
    h, w = image.shape[-2:]
    top = height // 2 - h // 2
    left = width // 2 - w // 2
    pad = [(0, 0)] * (image.ndim - 2) + [
        (top, height - h - top),
        (left, width - w - left),
    ]
    return jnp.pad(image, pad)


def trim(image: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """Extract the centered (height, width) region (``aocommon::Image::Trim``)."""
    h, w = image.shape[-2:]
    top = h // 2 - height // 2
    left = w // 2 - width // 2
    return image[..., top : top + height, left : left + width]


def _centered_kernel_fft(kernel: jnp.ndarray, shape: Tuple[int, int]) -> jnp.ndarray:
    """Spectrum of the kernel re-origined so its center pixel is at (0, 0).

    Equivalent of ``schaapcommon::math::PrepareConvolutionKernel``.
    """
    h, w = kernel.shape[-2:]
    k = jnp.roll(kernel, (-(h // 2), -(w // 2)), axis=(-2, -1))
    return jnp.fft.rfft2(k, s=shape)


def convolve_same(image: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Circular centered convolution at the image's own size.

    Equivalent of ``schaapcommon::math::Convolve`` on pre-padded buffers:
    out[p] = sum_q image[q] * kernel[p - q + center].  Batched over leading
    dims of ``image``; ``kernel`` must have the same spatial size, with
    matching/broadcastable leading dims.
    """
    h, w = image.shape[-2:]
    assert kernel.shape[-2:] == (h, w), (
        "convolve_same requires an image-sized (embedded) kernel"
    )
    lead = jnp.broadcast_shapes(image.shape[:-2], kernel.shape[:-2])
    spec = jnp.fft.rfft2(image) * _centered_kernel_fft(kernel, (h, w))
    spec = jnp.broadcast_to(spec, lead + spec.shape[-2:])
    return inverse_fft2_real(spec, (h, w)).astype(image.dtype)


def convolve_one_with_many(
    image: jnp.ndarray, kernels: jnp.ndarray
) -> jnp.ndarray:
    """Convolve one [H, W] image with a [S, H, W] kernel bank, computing the
    image transform once (used by the multiscale scale-peak search)."""
    h, w = image.shape
    assert kernels.shape[-2:] == (h, w)
    spec = jnp.fft.rfft2(image)[None] * _centered_kernel_fft(kernels, (h, w))
    return inverse_fft2_real(spec, (h, w)).astype(image.dtype)


@partial(jax.jit, static_argnames=("shape",))
def centered_embed_kernel_fft(
    kernel: jnp.ndarray, shape: Tuple[int, int]
) -> jnp.ndarray:
    """Centered-embed ``kernel`` into ``shape`` and return its origin-rolled
    spectrum, as one jitted call.  Batched over leading dims."""
    h, w = kernel.shape[-2:]
    if (h, w) != tuple(shape):
        kernel = untrim(kernel, *shape)
    return _centered_kernel_fft(kernel, tuple(shape))


@jax.jit
def prepare_kernel_fft(kernel: jnp.ndarray) -> jnp.ndarray:
    """rfft2 of a centered kernel (batched over leading dims), for reuse
    across many :func:`convolve_same_prefft` calls — e.g. the fixed
    multiscale kernel bank, whose transforms would otherwise be recomputed
    on every outer iteration."""
    return _centered_kernel_fft(kernel, kernel.shape[-2:])


@jax.jit
def convolve_same_prefft(image: jnp.ndarray, ker_f: jnp.ndarray) -> jnp.ndarray:
    """Centered circular convolution with a pre-transformed kernel spectrum
    (shared across every leading plane)."""
    h, w = image.shape[-2:]
    spec = jnp.fft.rfft2(image) * ker_f
    return inverse_fft2_real(spec, (h, w)).astype(image.dtype)


@partial(jax.jit, static_argnames=("padded_height", "padded_width"))
def _padded_convolve_impl(
    image: jnp.ndarray,
    kernel: jnp.ndarray,
    padded_height: int,
    padded_width: int,
) -> jnp.ndarray:
    h, w = image.shape[-2:]
    img_p = untrim(image, padded_height, padded_width)
    ker_p = untrim(kernel, padded_height, padded_width)
    out = convolve_same(img_p, ker_p)
    return trim(out, h, w)


def padded_convolve(
    image: jnp.ndarray,
    kernel: jnp.ndarray,
    padding: float = 1.1,
    padded_shape: Optional[Tuple[int, int]] = None,
) -> jnp.ndarray:
    """Zero-padded centered convolution returning the input-sized result.

    Equivalent of ``schaapcommon::math::PaddedConvolution`` and of the
    manual untrim/convolve/trim dance in ``cpp/algorithms/subminor_loop.cc:
    195-218``.  ``padded_shape`` overrides the automatically chosen 7-smooth
    padded size.
    """
    h, w = image.shape[-2:]
    if padded_shape is None:
        ph = calculate_good_fft_size(int(padding * h))
        pw = calculate_good_fft_size(int(padding * w))
    else:
        ph, pw = padded_shape
    return _padded_convolve_impl(image, kernel, ph, pw)
