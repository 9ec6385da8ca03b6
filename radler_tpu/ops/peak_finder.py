"""Masked / bordered peak (argmax) search, jit-friendly.

Behavioral equivalent of ``cpp/math/peak_finder.{h,cc}``.  Instead of the
reference's AVX scan, the image is reduced with a single fused masked argmax
that XLA runs as one reduction at device-memory bandwidth; on a device mesh the same
function composes with ``jax.lax.pmax`` for the global facet reduction.

Semantics preserved from the reference:

* ``allow_negative`` compares absolute values but returns the signed value.
* Borders shrink the search window on each side; a border given as a ratio is
  rounded like the reference (``round(width * border_ratio)``).
* A peak is "found" only if its comparison value exceeds ``FLT_MIN``
  (``std::numeric_limits<float>::min()``, see ``cpp/math/peak_finder.cc:25``):
  an all-zero or all-negative (when negatives are disallowed) image yields no
  peak.
* Ties resolve to the first row-major occurrence, like the scalar reference.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

_FLT_MIN = np.float32(1.1754943508222875e-38)


class PeakResult(NamedTuple):
    """Device-side peak-search result (all 0-d arrays)."""

    value: jnp.ndarray  # signed peak value (float32)
    x: jnp.ndarray  # int32
    y: jnp.ndarray  # int32
    found: jnp.ndarray  # bool


def border_from_ratio(width: int, height: int, border_ratio: float):
    return int(round(width * border_ratio)), int(round(height * border_ratio))


def window_mask(
    height: int,
    width: int,
    horizontal_border: int,
    vertical_border: int,
    start_y: int = 0,
    end_y: Optional[int] = None,
) -> np.ndarray:
    """Static bool mask of the searchable window (``peak_finder.cc:28-32``)."""
    if end_y is None:
        end_y = height
    xi_start, xi_end = horizontal_border, width - horizontal_border
    yi_start = max(start_y, vertical_border)
    yi_end = min(end_y, height - vertical_border)
    xi_end = max(xi_end, xi_start)
    yi_end = max(yi_end, yi_start)
    mask = np.zeros((height, width), dtype=bool)
    mask[yi_start:yi_end, xi_start:xi_end] = True
    return mask


@partial(
    jax.jit,
    static_argnames=(
        "allow_negative",
        "horizontal_border",
        "vertical_border",
        "has_mask",
    ),
)
def _find_peak_impl(
    image: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    allow_negative: bool,
    horizontal_border: int,
    vertical_border: int,
    has_mask: bool,
) -> PeakResult:
    height, width = image.shape
    value = jnp.abs(image) if allow_negative else image
    valid = jnp.asarray(
        window_mask(height, width, horizontal_border, vertical_border)
    )
    if has_mask:
        valid = valid & mask
    neg_inf = jnp.float32(-jnp.inf)
    masked = jnp.where(valid, value, neg_inf)
    flat_idx = jnp.argmax(masked.reshape(-1))
    peak_cmp = masked.reshape(-1)[flat_idx]
    found = peak_cmp > _FLT_MIN
    x = (flat_idx % width).astype(jnp.int32)
    y = (flat_idx // width).astype(jnp.int32)
    signed = image.reshape(-1)[flat_idx]
    return PeakResult(value=signed, x=x, y=y, found=found)


_DUMMY_MASKS = {}


def _dummy_mask(shape):
    # Host-side numpy constant: safe to cache across jit traces (a jnp
    # array created under a trace would leak a tracer).
    if shape not in _DUMMY_MASKS:
        _DUMMY_MASKS[shape] = np.ones(shape, bool)
    return _DUMMY_MASKS[shape]


def find_peak(
    image: jnp.ndarray,
    allow_negative: bool,
    horizontal_border: int = 0,
    vertical_border: int = 0,
    mask: Optional[jnp.ndarray] = None,
) -> PeakResult:
    """Find the (masked, bordered) peak of a 2-D image.

    Equivalent of ``math::peak_finder::Find`` / ``FindWithMask``.
    ``mask`` is an optional bool array; ``horizontal_border`` /
    ``vertical_border`` are static ints.  One jitted dispatch instead of
    ~8 eager ops, each of which is a separate launch.
    """
    if mask is None:
        mask_in, has_mask = _dummy_mask(image.shape), False
    else:
        mask_in, has_mask = mask, True
    return _find_peak_impl(
        image,
        mask_in,
        allow_negative=allow_negative,
        horizontal_border=horizontal_border,
        vertical_border=vertical_border,
        has_mask=has_mask,
    )


def find_peak_with_ratio(
    image: jnp.ndarray,
    allow_negative: bool,
    border_ratio: float,
    mask: Optional[jnp.ndarray] = None,
) -> PeakResult:
    """Peak search with a relative border (``cpp/math/peak_finder.h:99-107``)."""
    height, width = image.shape
    hb, vb = border_from_ratio(width, height, border_ratio)
    return find_peak(image, allow_negative, hb, vb, mask)
