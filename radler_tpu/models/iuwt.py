"""IUWT (MORESANE-like) wavelet-sparsity deconvolution.

Behavioral equivalent of ``cpp/algorithms/iuwt_deconvolution_algorithm.{h,cc}``
and the facade ``cpp/algorithms/iuwt_deconvolution.h``:

per iteration — decompose the integrated residual, derive per-scale MAD
thresholds, pick the most significant scale/peak with PSF-response
normalization, flood-fill a cross-scale structure mask, optionally trim to a
bounding box, solve the masked conjugate-gradient system so that the masked
IUWT of (model ⊛ PSF) matches the masked dirty image, guard against RMS
increase, refit per-image flux factors, apply the gain-scaled model, and
escalate scales on failure.

TPU mapping: the wavelet transform, circular FFT convolutions, CG iterations
and reductions run as jitted device code; the (inherently sequential)
flood-fill structure selection reduces to thresholding + connected-component
labeling, done host-side with ``scipy.ndimage`` on bitmasks.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import iuwt as iuwt_ops
from ..ops.convolution import convolve_same
from ..image_set import get_linear_integrated, get_integrated_psf
from ..utils import logging as log
from .base import DeconvolutionAlgorithm, DeconvolutionResult

_linear_integrated = jax.jit(get_linear_integrated, static_argnums=1)
_integrated_psf = jax.jit(get_integrated_psf, static_argnums=1)


@partial(jax.jit, static_argnames=("meta",))
def _apply_structure_update(
    model_data, dirty_data, structure, psfs, gain, meta
):
    """Accepted-structure update (``iuwt_deconvolution_algorithm.cc:862-877``)
    in one dispatch: model += gain*structure; dirty -= (gain*structure) ⊛ psf
    per channel; return the re-integrated dirty."""
    structure_scaled = structure * gain
    model_data = model_data + structure_scaled
    n, height, width = dirty_data.shape
    c = meta.n_channels
    p = meta.n_polarizations
    conv = convolve_same(
        structure_scaled.reshape(c, p, height, width), psfs[:, None, :, :]
    )
    dirty_data = dirty_data - conv.reshape(n, height, width)
    return (
        model_data,
        dirty_data,
        get_linear_integrated(dirty_data, meta),
    )

try:
    from scipy import ndimage as _ndimage
except Exception:  # pragma: no cover
    _ndimage = None


class _IuwtEngine:
    """One ``IuwtDeconvolutionAlgorithm`` run (reference class of the same
    name); holds per-run geometry + PSF response state."""

    def __init__(
        self,
        width: int,
        height: int,
        minor_loop_gain: float,
        major_loop_gain: float,
        clean_border: float,
        allow_negative_components: bool,
        mask: Optional[np.ndarray],
        absolute_threshold: float,
        threshold_sigma_level: float = 4.0,
        tolerance: float = 0.75,
        mesh=None,
    ):
        self.width = width
        self.height = height
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.minor_loop_gain = minor_loop_gain
        self.major_loop_gain = major_loop_gain
        self.clean_border = clean_border
        self.mask = mask
        self.absolute_threshold = absolute_threshold
        self.threshold_sigma_level = threshold_sigma_level
        self.tolerance = tolerance
        self.allow_negative = allow_negative_components
        self.psf_rms: Optional[np.ndarray] = None
        self.psf_peak_response: Optional[np.ndarray] = None
        self.psf_peak_response_to_next: Optional[np.ndarray] = None
        self.rmses: Optional[np.ndarray] = None
        # Current bounding box during trimmed recursion.
        self.box = (0, 0, width, height)
        # Keys: (width, height) for the peak-search window, and
        # ("sel", width, height, box, prior_is_none) for selection windows.
        self._window_cache: Dict[Tuple, jnp.ndarray] = {}

    # -- mesh sharding -----------------------------------------------------
    def _shard_rows(self, arr: jnp.ndarray, row_axis: int = 0) -> jnp.ndarray:
        """Lay image rows over the device mesh so XLA partitions the jitted
        IUWT programs (the à-trous decompose is separable shifts — perfectly
        row-parallel; the CG's FFT convolutions become distributed FFTs).

        The IUWT working set is mostly single-plane [H, W] images and
        [S+1, H, W] coefficient stacks, so rows take the whole flattened
        mesh when divisible (falling back to the "tile" axis, then to
        leaving the array unsharded).  Ref:
        ``iuwt_decomposition.cc:9-53`` (the reference's thread-split of the
        same separable convolutions)."""
        if self.mesh is None:
            return arr
        from jax.sharding import NamedSharding, PartitionSpec as P

        n = arr.shape[row_axis]
        if n % self.mesh.size == 0:
            axes = ("chan", "tile")
        elif n % self.mesh.shape["tile"] == 0:
            axes = "tile"
        else:
            return arr
        spec = [None] * arr.ndim
        spec[row_axis] = axes
        return jax.device_put(arr, NamedSharding(self.mesh, P(*spec)))

    # -- PSF characterization (``MeasureRMSPerScale``) -------------------
    def measure_rms_per_scale(self, psf: jnp.ndarray, end_scale: int) -> None:
        stats = np.asarray(iuwt_ops.psf_response_stats(psf, end_scale))
        self.psf_rms = stats[0]
        self.psf_peak_response = stats[1]
        self.psf_peak_response_to_next = stats[2]

    # -- peak search ------------------------------------------------------
    def _border_window(self, width: int, height: int) -> np.ndarray:
        """Host-side clean-border window (``GetMaxAbs`` border semantics)."""
        x_border = int(self.clean_border * width)
        y_border = int(self.clean_border * height)
        window = np.zeros((height, width), dtype=bool)
        window[
            y_border : height - y_border, x_border : width - x_border
        ] = True
        return window

    def _cached_window(self, key, build) -> jnp.ndarray:
        cached = self._window_cache.get(key)
        if cached is None:
            cached = jnp.asarray(build())
            self._window_cache[key] = cached
        return cached

    def _search_window(self, width: int, height: int) -> jnp.ndarray:
        """Border + user-mask search window, cached per shape (device)."""

        def build():
            window = self._border_window(width, height)
            if self.mask is not None and self.mask.shape == (height, width):
                window &= self.mask
            return window

        return self._cached_window((width, height), build)

    def _select_window(
        self, prior_mask, width: int, height: int
    ) -> jnp.ndarray:
        """Border + prior-mask window for structure selection, cached on
        device per (shape, current box) so repeated structure iterations do
        not re-upload a full-size bool image every time.  The prior mask is
        fully determined by (self.mask, current box), so the box is a sound
        cache key."""

        def build():
            window = self._border_window(width, height)
            if prior_mask is not None:
                window = window & np.asarray(prior_mask)
            return window

        return self._cached_window(
            ("sel", width, height, self.box, prior_mask is None), build
        )

    # -- structure selection ---------------------------------------------
    def _select_structures(
        self,
        coeffs: jnp.ndarray,  # [S+1, H, W] (device)
        thresholds: np.ndarray,
        min_scale: int,
        end_scale: int,
        prior_mask: Optional[np.ndarray],
        width: int,
        height: int,
    ) -> Tuple[jnp.ndarray, int]:
        """``image_analysis::SelectStructures`` (``image_analysis.cc:217-249``).

        Because every above-threshold pixel seeds a flood fill bounded to
        above-threshold pixels, the resulting mask is exactly the windowed
        threshold-exceedance set; no sequential walk is needed, and the whole
        selection stays on-device (one count scalar comes back).
        """
        window = self._select_window(prior_mask, width, height)
        mask, count = iuwt_ops.select_structures(
            coeffs,
            jnp.asarray(thresholds[:end_scale], jnp.float32),
            window,
            jnp.int32(min_scale),
        )
        # The count is informational; pulling it eagerly costs a round trip
        # per structure iteration.
        return mask, count

    # -- bounding boxes ----------------------------------------------------
    @staticmethod
    def _adjust_box(
        x1: int, y1: int, x2: int, y2: int, width: int, height: int,
        end_scale: int,
    ) -> Tuple[int, int, int, int]:
        """Pad the box by 50%, enforce a minimum size and /8 alignment
        (``AdjustBox``, ``iuwt_deconvolution_algorithm.cc:217-262``)."""
        min_box_size = max(
            128, iuwt_ops.min_image_dimension(end_scale) * 3 // 2
        )
        box_width = x2 - x1
        box_height = y2 - y1
        new_x1 = int(x1 - 0.5 * box_width)
        new_x2 = int(x2 + 0.5 * box_width)
        new_y1 = int(y1 - 0.5 * box_height)
        new_y2 = int(y2 + 0.5 * box_height)
        if new_x2 - new_x1 < min_box_size:
            mid = (x1 + x2) // 2
            new_x1 = mid - min_box_size // 2
            new_x2 = mid + min_box_size // 2
        if new_y2 - new_y1 < min_box_size:
            mid = (y1 + y2) // 2
            new_y1 = mid - min_box_size // 2
            new_y2 = mid + min_box_size // 2
        x1 = new_x1 if new_x1 >= 0 else 0
        x2 = new_x2 if new_x2 < width else width
        y1 = new_y1 if new_y1 >= 0 else 0
        y2 = new_y2 if new_y2 < height else height
        # The reference aligns the box to /8 (AdjustBox); on TPU every
        # distinct box shape is a separate XLA compilation of the whole
        # masked-CG pipeline, so round the box *up* to a power of two
        # instead: at most log2(width/128) shapes ever compile, and the
        # enlarged box only reduces trim-induced boundary effects (the
        # structure mask still restricts the solve).
        x1, x2 = _IuwtEngine._grow_to_pow2(x1, x2, width)
        y1, y2 = _IuwtEngine._grow_to_pow2(y1, y2, height)
        return x1, y1, x2, y2

    @staticmethod
    def _grow_to_pow2(lo: int, hi: int, limit: int) -> Tuple[int, int]:
        """Expand [lo, hi) to the next power-of-two length, kept inside
        [0, limit); falls back to the full axis when it cannot fit."""
        size = hi - lo
        target = 1 << max(size - 1, 1).bit_length()
        if target >= limit:
            return 0, limit
        grow = target - size
        lo = max(0, lo - grow // 2)
        hi = lo + target
        if hi > limit:
            hi = limit
            lo = hi - target
        return lo, hi

    # -- structure find+deconvolve ----------------------------------------
    def find_and_deconvolve_structure(
        self,
        dirty: jnp.ndarray,
        psf: jnp.ndarray,
        psfs: jnp.ndarray,  # [C, H, W]
        structure_model_full: jnp.ndarray,  # [N, H, W]
        dirty_set,
        cur_end_scale: int,
        cur_min_scale: int,
        max_components: List,
    ) -> Tuple[bool, jnp.ndarray]:
        """``FindAndDeconvolveStructure``
        (``iuwt_deconvolution_algorithm.cc:414-498``)."""
        width, height = self.width, self.height
        max_components.clear()
        # The whole front half — decompose + per-scale stats + the
        # significant-scale choice + adjusted thresholds + structure mask +
        # bounding box — runs as ONE dispatch with ONE host pull
        # (``ops/iuwt.py::structure_stats_select``; each separate pull is a
        # device-to-host round trip).  The mask
        # and bbox are speculative when the early-outs below fire.
        S = cur_end_scale
        coeffs, mask_pre, blob_dev = iuwt_ops.structure_stats_select(
            dirty,
            self._search_window(width, height),
            self._select_window(self.mask, width, height),
            jnp.asarray(np.asarray(self.psf_rms[:S], np.float32)),
            jnp.float32(
                self.psf_peak_response[1] / self.psf_peak_response_to_next[0]
            ),
            jnp.float32(self.threshold_sigma_level),
            jnp.float32(self.absolute_threshold),
            jnp.float32(self.tolerance),
            jnp.int32(cur_min_scale),
            S,
            self.allow_negative,
        )
        blob = np.asarray(blob_dev)
        stats = blob[: 5 * S].reshape(5, S)
        area_size = int(blob[5 * S])
        bbox = tuple(int(v) for v in blob[5 * S + 1 : 5 * S + 5])
        max_val_scale = int(blob[5 * S + 5])
        max_val = float(blob[5 * S + 6])
        self.rmses, vals = stats[0], stats[1]
        xs = stats[2].astype(np.int32)
        ys = stats[3].astype(np.int32)
        thresholds = self.rmses * (self.threshold_sigma_level * 4.0 / 5.0)
        for scale in range(cur_end_scale):
            max_components.append(
                {
                    "x": int(xs[scale]),
                    "y": int(ys[scale]),
                    "scale": scale,
                    "val": float(vals[scale]),
                }
            )

        if max_val_scale == -1:
            log.debug("No significant pixel found.")
            return False, structure_model_full
        max_x = int(xs[max_val_scale])
        max_y = int(ys[max_val_scale])
        log.debug(
            f"Most significant pixel: {max_x},{max_y}={max_val} "
            f"({max_val / self.rmses[max_val_scale]} sigma) on scale "
            f"{max_val_scale}"
        )
        if abs(max_val) < thresholds[max_val_scale]:
            log.debug("Most significant pixel is in the noise, stopping.")
            return False, structure_model_full

        scale_max_abs = abs(max_val)
        thresholds = np.maximum(thresholds, self.tolerance * scale_max_abs)
        if max_val < 0.0:
            thresholds = -thresholds

        return self._fill_and_deconvolve_structure(
            coeffs,
            dirty,
            structure_model_full,
            psf,
            psfs,
            dirty_set,
            cur_end_scale,
            cur_min_scale,
            width,
            height,
            thresholds,
            (max_x, max_y, max_val_scale),
            allow_trimming=True,
            prior_mask=self.mask,
            precomputed=(mask_pre, bbox, area_size),
        )

    def _fill_and_deconvolve_structure(
        self,
        coeffs: jnp.ndarray,
        dirty: jnp.ndarray,
        structure_model_full: jnp.ndarray,
        psf: jnp.ndarray,
        psfs: jnp.ndarray,
        dirty_set,
        cur_end_scale: int,
        cur_min_scale: int,
        width: int,
        height: int,
        thresholds: np.ndarray,
        max_comp: Tuple[int, int, int],
        allow_trimming: bool,
        prior_mask: Optional[np.ndarray],
        precomputed=None,  # (mask, raw bbox, area) from structure_stats_select
    ) -> Tuple[bool, jnp.ndarray]:
        """``FillAndDeconvolveStructure``
        (``iuwt_deconvolution_algorithm.cc:500-626``)."""
        if precomputed is not None:
            mask, raw_box, area_size = precomputed
        else:
            mask, area_size = self._select_structures(
                coeffs,
                thresholds,
                cur_min_scale,
                cur_end_scale,
                prior_mask,
                width,
                height,
            )
            raw_box = None
        if log.is_enabled("debug"):
            log.debug(
                f"Flood-filled area contains {int(area_size)} significant "
                "components."
            )
        if allow_trimming:
            if raw_box is None:
                raw_box = tuple(
                    int(v)
                    for v in np.asarray(
                        iuwt_ops.masked_recompose_bbox(
                            coeffs, mask, cur_end_scale
                        )
                    )
                )
            x1, y1, x2, y2 = self._adjust_box(
                *raw_box, width, height, max_comp[2] + 1
            )
        else:
            x1, y1, x2, y2 = 0, 0, width, height
        if allow_trimming and ((x2 - x1) < width or (y2 - y1) < height):
            self.box = (x1, y1, x2, y2)
            new_width, new_height = x2 - x1, y2 - y1
            small_dirty = iuwt_ops.slice_box2(
                dirty, y1, x1, new_height, new_width
            )
            small_psf = self._trim_psf(psf, new_width, new_height)
            max_scale = max(
                iuwt_ops.end_scale(min(new_width, new_height)),
                max_comp[2] + 1,
            )
            if max_scale < cur_end_scale:
                log.debug(
                    f"Bounding box too small for largest scale of "
                    f"{cur_end_scale} -- ignoring scales>={max_scale}."
                )
                cur_end_scale = max_scale
            trimmed_coeffs = iuwt_ops.trim_coeffs_box(
                coeffs, y1, x1, cur_end_scale, new_height, new_width
            )
            trimmed_model = iuwt_ops.slice_box3(
                structure_model_full, y1, x1, new_height, new_width
            )
            trimmed_prior = (
                None
                if prior_mask is None
                else np.asarray(prior_mask)[y1:y2, x1:x2]
            )
            success, trimmed_model = self._fill_and_deconvolve_structure(
                trimmed_coeffs,
                small_dirty,
                trimmed_model,
                small_psf,
                psfs,
                dirty_set,
                cur_end_scale,
                cur_min_scale,
                new_width,
                new_height,
                thresholds,
                (max_comp[0] - x1, max_comp[1] - y1, max_comp[2]),
                allow_trimming=False,
                prior_mask=trimmed_prior,
            )
            padded = iuwt_ops.embed_box3_zeros(
                trimmed_model, y1, x1, height, width
            )
            self.box = (0, 0, width, height)
            return success, padded

        # Un-trimmed path: masked CG solve + RMS guard as one program with
        # ONE host pull for both decisions (each pull is a device-to-host
        # round trip).
        masked_dirty_scales, masked_dirty = iuwt_ops.masked_dirty_of(
            dirty, mask, cur_end_scale
        )
        structure_model, status = iuwt_ops.conjugate_gradient_guarded(
            self._shard_rows(masked_dirty_scales, row_axis=1),
            self._shard_rows(mask, row_axis=1),
            self._shard_rows(masked_dirty),
            self._shard_rows(dirty),
            self._shard_rows(psf),
            jnp.float32(self.minor_loop_gain),
            cur_end_scale,
        )
        succ_f, snr_f, rms_before, rms_after = np.asarray(status).tolist()
        if not bool(succ_f):
            log.debug(f"CG failed to converge (SNR={snr_f}).")
            return False, structure_model_full
        log.debug(f"CG solve finished (SNR={snr_f}).")
        if rms_after > rms_before:
            log.debug(f"RMS got worse: {rms_before} -> {rms_after}")
            return False, structure_model_full

        structure_model_full = self._perform_sub_image_fit_all(
            mask,
            structure_model,
            max_comp,
            structure_model_full,
            psf,
            psfs,
            dirty,
            dirty_set,
            cur_end_scale,
            width,
            height,
        )
        return True, structure_model_full

    @staticmethod
    def _trim_psf(psf: jnp.ndarray, new_width: int, new_height: int):
        """``TrimPsf`` — centered trim (``iuwt_deconvolution_algorithm.h``),
        as one jitted dynamic-slice dispatch."""
        h, w = psf.shape
        top = h // 2 - new_height // 2
        left = w // 2 - new_width // 2
        return iuwt_ops.slice_box2(psf, top, left, new_height, new_width)

    # -- per-image flux refits --------------------------------------------
    def _perform_sub_image_fit_all(
        self,
        mask: jnp.ndarray,  # [S, H, W] bool (device)
        structure_model: jnp.ndarray,
        max_comp: Tuple[int, int, int],
        fitted_model_full: jnp.ndarray,  # [N, H_full, W_full]
        psf: jnp.ndarray,
        psfs: jnp.ndarray,
        dirty: jnp.ndarray,
        dirty_set,
        n_scales: int,
        width: int,
        height: int,
    ) -> jnp.ndarray:
        """``PerformSubImageFitAll``
        (``iuwt_deconvolution_algorithm.cc:628-671``)."""
        # The box locates this (possibly trimmed) working area inside the
        # full-size dirty_set; fitted_model_full is already working-area-sized.
        x1, y1, x2, y2 = self.box
        n_images = fitted_model_full.shape[0]
        if n_images == 1:
            return iuwt_ops.expand_single_plane(structure_model, 1)

        components = self._label_components(
            structure_model, max_comp, n_scales, width, height
        )
        correction_factors = self._fit_components(
            components, mask, structure_model, psf, dirty, n_scales,
            width, height,
        )
        out = jnp.zeros_like(fitted_model_full)
        meta = dirty_set.meta
        for img_index in range(n_images):
            sub_psf_full = psfs[meta.psf_index(img_index)]
            sub_dirty = dirty_set.data[img_index][y1:y2, x1:x2]
            if sub_psf_full.shape != (height, width):
                sub_psf = self._trim_psf(sub_psf_full, width, height)
            else:
                sub_psf = sub_psf_full
            factors = self._fit_components(
                components, mask, structure_model, sub_psf, sub_dirty,
                n_scales, width, height,
            )
            # fitted = structure_model scaled per component by
            # factor/integrated_factor (components are disjoint, so the
            # per-component adds collapse to one ratio image).
            ratio_img = np.zeros((height, width), np.float32)
            for comp, factor, integrated_factor in zip(
                components, factors, correction_factors
            ):
                if (
                    math.isfinite(factor)
                    and math.isfinite(integrated_factor)
                    and integrated_factor != 0.0
                ):
                    ratio_img[comp["area"]] = factor / integrated_factor
            fitted = structure_model * jnp.asarray(ratio_img)
            out = out.at[img_index].set(fitted)
        return out

    def _label_components(
        self,
        structure_model: jnp.ndarray,
        max_comp: Tuple[int, int, int],
        n_scales: int,
        width: int,
        height: int,
    ) -> List[dict]:
        """Connected components of the structure model with adjusted boxes,
        in the reference's raster-seed order
        (``PerformSubImageFitSingle``, ``iuwt_deconvolution_algorithm.cc:
        673-742``).  Labeling runs once per fit-all call — the model, and
        hence the component set, is identical for every image."""
        model_host = np.asarray(structure_model)
        peak_level = abs(model_host[max_comp[1], max_comp[0]])
        threshold = peak_level * 1e-4
        significant = np.abs(model_host) > threshold
        if _ndimage is None:
            raise RuntimeError("scipy is required for IUWT component labeling")
        labels, _ = _ndimage.label(significant)
        components: List[dict] = []
        seen = set()
        ys_all, xs_all = np.nonzero(significant)
        order = np.argsort(ys_all * width + xs_all, kind="stable")
        for k in order:
            lbl = labels[ys_all[k], xs_all[k]]
            if lbl in seen:
                continue
            seen.add(lbl)
            area = labels == lbl
            ys, xs = np.nonzero(area)
            bx1, bx2 = int(xs.min()), int(xs.max())
            by1, by2 = int(ys.min()), int(ys.max())
            bx1, by1, bx2, by2 = self._adjust_box(
                bx1, by1, bx2, by2, width, height, n_scales
            )
            components.append(
                {
                    "area": area,
                    "box": (bx1, by1, bx2, by2),
                    "size": (by2 - by1, bx2 - bx1),
                }
            )
        return components

    def _fit_components(
        self,
        components: List[dict],
        mask: jnp.ndarray,
        structure_model: jnp.ndarray,
        psf: jnp.ndarray,
        sub_dirty: jnp.ndarray,
        n_scales: int,
        width: int,
        height: int,
    ) -> List[float]:
        """Per-component flux factors through the masked-IUWT operator
        (``PerformSubImageComponentFitBoxed`` + ``...Fit``,
        ``iuwt_deconvolution_algorithm.cc:744-801``).

        Components are grouped by adjusted-box size (already power-of-two
        bucketed by ``_adjust_box``) and each bucket runs as ONE device
        dispatch (:func:`radler_tpu.ops.iuwt.component_fit_ratio_batched`)
        instead of one dispatch + host round trip per component."""
        _, masked_dirty = iuwt_ops.masked_dirty_of(sub_dirty, mask, n_scales)
        factors = [0.0] * len(components)
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for idx, comp in enumerate(components):
            buckets.setdefault(comp["size"], []).append(idx)
        for (bh, bw), idxs in buckets.items():
            if (bh, bw) == (height, width):
                psf_trimmed = psf
            else:
                psf_trimmed = self._trim_psf(psf, bw, bh)
            areas = np.stack(
                [
                    components[i]["area"][
                        components[i]["box"][1] : components[i]["box"][3],
                        components[i]["box"][0] : components[i]["box"][2],
                    ]
                    for i in idxs
                ]
            )
            y1s = np.asarray([components[i]["box"][1] for i in idxs], np.int32)
            x1s = np.asarray([components[i]["box"][0] for i in idxs], np.int32)
            sums = np.asarray(
                iuwt_ops.component_fit_ratio_batched(
                    mask,
                    structure_model,
                    masked_dirty,
                    psf_trimmed,
                    jnp.asarray(areas),
                    jnp.asarray(y1s),
                    jnp.asarray(x1s),
                    n_scales,
                    bh,
                    bw,
                )
            )
            for row, i in enumerate(idxs):
                model_sum, dirty_sum = float(sums[row, 0]), float(sums[row, 1])
                if (
                    model_sum == 0.0
                    or not math.isfinite(dirty_sum)
                    or not math.isfinite(model_sum)
                ):
                    factors[i] = 0.0
                else:
                    factors[i] = dirty_sum / model_sum
        return factors

    # -- the major iteration ----------------------------------------------
    def perform_major_iteration(
        self,
        iter_counter: int,
        n_iter: int,
        model_set,
        dirty_set,
        psfs: jnp.ndarray,
    ) -> Tuple[float, bool, int]:
        """``PerformMajorIteration``
        (``iuwt_deconvolution_algorithm.cc:803-918``).
        Returns (max_value, reached_major_threshold, iter_counter)."""
        reached_major_threshold = False
        if iter_counter == n_iter:
            return 0.0, False, iter_counter
        meta = dirty_set.meta
        width, height = self.width, self.height

        if self.mesh is not None:
            # Row-shard the cube and every derived image over the mesh; XLA
            # propagates the layout through decompose/stats/CG and inserts
            # the halo exchanges and reductions.
            dirty_set.data = self._shard_rows(dirty_set.data, row_axis=1)
            psfs = self._shard_rows(psfs, row_axis=1)
        dirty = self._shard_rows(_linear_integrated(dirty_set.data, meta))
        psf = self._shard_rows(_integrated_psf(psfs, meta))

        max_scale = iuwt_ops.end_scale(min(width, height))
        cur_end_scale = 2

        log.debug("Measuring PSF...")
        self.measure_rms_per_scale(psf, max_scale)

        structure_model = jnp.zeros_like(dirty_set.data)
        max_value = 0.0
        cur_min_scale = 0
        do_continue = True
        initial_components: List[dict] = []
        while True:
            log.debug(f"*** Deconvolution iteration {iter_counter} ***")
            dirty_before = dirty
            max_components: List[dict] = []
            succeeded, new_structure = self.find_and_deconvolve_structure(
                dirty,
                psf,
                psfs,
                structure_model,
                dirty_set,
                cur_end_scale,
                cur_min_scale,
                max_components,
            )
            if succeeded:
                # Accepted structure: one fused dispatch updates the model,
                # subtracts structure (x) psf per channel, and re-integrates.
                model_set.data, dirty_set.data, dirty = (
                    _apply_structure_update(
                        model_set.data,
                        dirty_set.data,
                        new_structure,
                        psfs,
                        jnp.float32(self.minor_loop_gain),
                        meta,
                    )
                )

                while len(max_components) > len(initial_components):
                    initial_components.append(
                        max_components[len(initial_components)]
                    )
                max_value = 0.0
                for c in range(len(initial_components)):
                    max_value = max(max_value, max_components[c]["val"])
                    if abs(max_components[c]["val"]) < abs(
                        initial_components[c]["val"]
                    ) * (1.0 - self.major_loop_gain):
                        reached_major_threshold = True
                if reached_major_threshold:
                    # NB: the reference's break skips the counter increment
                    # (iuwt_deconvolution_algorithm.cc:895,915).
                    break
            else:
                if cur_min_scale + 1 < cur_end_scale:
                    cur_min_scale += 1
                    log.debug(f"=> Min scale now {cur_min_scale}")
                else:
                    cur_min_scale = 0
                    if cur_end_scale != max_scale:
                        cur_end_scale += 1
                        log.debug(f"=> Scale now {cur_end_scale}.")
                    else:
                        log.debug(
                            "Max scale reached: finished all scales, quiting."
                        )
                        do_continue = False
                dirty = dirty_before
            iter_counter += 1
            if iter_counter == n_iter or not do_continue:
                break
        return max_value, reached_major_threshold, iter_counter


class IuwtDeconvolution(DeconvolutionAlgorithm):
    """Facade adapting the IUWT engine to the algorithm interface
    (``cpp/algorithms/iuwt_deconvolution.h:19-43``)."""

    def execute_major_iteration(
        self, dirty_set, model_set, psfs: jnp.ndarray
    ) -> DeconvolutionResult:
        engine = _IuwtEngine(
            dirty_set.width,
            dirty_set.height,
            self.minor_loop_gain,
            self.major_loop_gain,
            self.clean_border_ratio,
            self.allow_negative_components,
            self.clean_mask,
            self.threshold,
            mesh=self.device_mesh,
        )
        result = DeconvolutionResult()
        if self.max_iterations <= self.iteration_number:
            # Peak-only pass (the parallel engine's phase 1,
            # ``parallel_deconvolution.cc:582-599``): report the starting
            # peak of the integrated dirty so the facet's divergence
            # rollback compares against a real baseline.
            from ..image_set import get_linear_integrated

            integ = get_linear_integrated(dirty_set.data, dirty_set.meta)
            if self.clean_mask is not None:
                integ = integ * jnp.asarray(self.clean_mask, integ.dtype)
            peak = float(jnp.max(jnp.abs(integ)))
            result.starting_peak_value = peak
            result.final_peak_value = peak
            result.another_iteration_required = False
            return result
        final_peak, another, iters = engine.perform_major_iteration(
            self.iteration_number,
            self.max_iterations,
            model_set,
            dirty_set,
            psfs,
        )
        result.final_peak_value = final_peak
        result.another_iteration_required = another
        self.iteration_number = iters
        if self.iteration_number >= self.max_iterations:
            result.another_iteration_required = False
        return result
