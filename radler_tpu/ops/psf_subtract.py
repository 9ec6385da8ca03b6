"""PSF-shift and PSF-patch subtraction.

TPU-native equivalent of the reference's SIMD subtraction kernels
(``cpp/algorithms/simple_clean.cc``): instead of a scalar patch loop, the PSF
is shifted to the component position with a roll and the wrapped region is
masked off, producing exactly the clipped patch semantics of
``simple_clean::PartialSubtractImage`` as one fused elementwise pass.  The
full residual-cube update ``residual -= value * shifted_psf`` then runs at
device-memory bandwidth with no host involvement, and vmaps over the image
axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def shift_psf(psf: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Shift a centered PSF so its center lands on (x, y), zeroing wrapped
    pixels.

    Output[py, px] = psf[py - y + H//2, px - x + W//2] where the index is in
    bounds, else 0 — the same clipping as the reference patch subtraction
    (``cpp/algorithms/simple_clean.cc:61-96``).  ``x`` / ``y`` may be traced
    scalars.
    """
    h, w = psf.shape[-2:]
    dy = y - h // 2
    dx = x - w // 2
    shifted = jnp.roll(psf, (dy, dx), axis=(-2, -1))
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid = (rows >= dy) & (rows < h + dy) & (cols >= dx) & (cols < w + dx)
    return jnp.where(valid, shifted, jnp.zeros((), dtype=psf.dtype))


def subtract_psf_from_cube(
    cube: jnp.ndarray,
    psfs: jnp.ndarray,
    psf_indices: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    factors: jnp.ndarray,
) -> jnp.ndarray:
    """``cube[i] -= factors[i] * psfs[psf_indices[i]]`` shifted to (x, y).

    Equivalent of the per-image ``tools.SubtractImage`` loop in
    ``cpp/algorithms/generic_clean.cc:188-196``, fused into one pass over the
    ``[n_images, H, W]`` cube.  ``psfs`` is ``[n_channels, H, W]``.
    """
    shifted = shift_psf(psfs, x, y)  # [n_channels, H, W]
    per_image = shifted[psf_indices]  # [n_images, H, W]
    return cube - factors[:, None, None] * per_image
