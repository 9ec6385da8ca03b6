"""Multiscale CLEAN (Offringa & Smirnov 2017).

Behavioral equivalent of ``cpp/algorithms/multiscale_algorithm.{h,cc}``,
redesigned TPU-first:

* The per-scale convolved-peak search — one thread per scale with its own
  image copy in the reference (``threaded_deconvolution_tools.cc:30-50``) —
  becomes a single *batched FFT* of the integrated image against the whole
  embedded kernel bank, followed by per-scale masked argmaxes.
* The fixed-scale fast subminor loop reuses :class:`SubMinorLoop`
  (``radler_tpu/models/subminor.py``) on the scale-convolved cube with
  twice-convolved PSFs, exactly like ``multiscale_algorithm.cc:377-461``.
* Scale state (bias factors, activation, per-scale masks and cleaning
  statistics) persists across major iterations, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..image_set import CubeMeta, get_integrated_psf, get_linear_integrated
from ..component_list import ComponentList
from ..ops.convolution import (
    convolve_same_prefft,
    forward_fft2,
    inverse_fft2_real,
    prepare_kernel_fft,
)
from ..ops.multiscale_kernels import (
    embedded_kernel,
    kernel_peak_value,
    make_shape_function,
    add_shape_component,
)
from ..ops.peak_finder import _FLT_MIN, find_peak, window_mask
from ..ops.psf_subtract import subtract_psf_from_cube
from ..settings import (
    MultiscaleSettings,
    MultiscaleShape,
    OptimizationAlgorithm,
    SpectralFittingMode,
)
from ..utils.device_memory import fits_device_memory
from ..utils.fft_size import get_convolution_size
from ..utils import logging as log
from .base import DeconvolutionAlgorithm, DeconvolutionResult
from .subminor import SubMinorLoop


# Optional wall-clock phase breakdown of the minor loop, enabled with
# RADLER_TPU_PROFILE=1 (see utils/profiling.PhaseTimer).  Each phase syncs on
# its outputs, so the breakdown is accurate but the run slightly slower.
_PROFILE = bool(os.environ.get("RADLER_TPU_PROFILE"))
_TIMER = None
if _PROFILE:
    from ..utils.profiling import PhaseTimer

    _TIMER = PhaseTimer()


def _phase(name: str, sync=None):
    if _TIMER is None:
        return contextlib.nullcontext()
    return _TIMER.phase(name, sync=sync)


def _timed(name: str, fn, *args, **kwargs):
    """Call ``fn`` and attribute its wall time (synced on array outputs)."""
    if _TIMER is None:
        return fn(*args, **kwargs)
    import time as _time

    t0 = _time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    dt = _time.perf_counter() - t0
    _TIMER.totals[name] = _TIMER.totals.get(name, 0.0) + dt
    _TIMER.counts[name] = _TIMER.counts.get(name, 0) + 1
    return out


def profile_report() -> str:
    """The accumulated phase breakdown (empty unless RADLER_TPU_PROFILE)."""
    return _TIMER.report() if _TIMER is not None else ""


@dataclasses.dataclass
class ScaleInfo:
    """Mirrors ``MultiScaleAlgorithm::ScaleInfo``."""

    scale: float = 0.0
    kernel_peak: float = 0.0
    psf_peak: float = 0.0
    bias_factor: float = 1.0
    gain: float = 1.0
    is_active: bool = True
    n_components_cleaned: int = 0
    total_flux_cleaned: float = 0.0
    max_unnormalized_image_value: float = 0.0
    max_normalized_image_value: float = 0.0
    max_image_value_x: int = 0
    max_image_value_y: int = 0
    rms: float = -1.0


# (key, psfs array (strong ref), peaks, banks) — see _prepare_fused_banks.
_FUSED_BANK_CACHE: list = []

# id(mesh) -> (bank arrays (identity key), their mesh-placed twins, mesh
# strong ref) — see the mesh branch of _execute_fused.
_MESH_PLACEMENT_CACHE: dict = {}


def initialize_scales(
    scales: List[ScaleInfo],
    beam_size_in_pixels: float,
    min_width_height: int,
    shape: MultiscaleShape,
    max_scales: int,
    scale_list: List[float],
) -> None:
    """Beam-derived geometric scale series {0, 2b, 4b, ...} capped at half the
    image (``multiscale_algorithm.cc:90-131``)."""
    if not scale_list:
        if not scales:
            scale_index = 0
            scale = beam_size_in_pixels * 2.0
            while True:
                entry = ScaleInfo()
                entry.scale = 0.0 if scale_index == 0 else scale
                entry.kernel_peak = kernel_peak_value(
                    scale, min_width_height, shape
                )
                scales.append(entry)
                scale *= 2.0
                scale_index += 1
                if not (
                    scale < min_width_height * 0.5
                    and (max_scales == 0 or scale_index < max_scales)
                ):
                    break
        else:
            while scales and scales[-1].scale >= min_width_height * 0.5:
                scales.pop()
    elif not scales:
        for scale in sorted(scale_list):
            entry = ScaleInfo()
            entry.scale = scale
            entry.kernel_peak = kernel_peak_value(scale, min_width_height, shape)
            scales.append(entry)


_VALID_STACK_CACHE = {}


@jax.jit
def _scale_convolved_center_values(
    psf: jnp.ndarray, kimg_f: jnp.ndarray
) -> jnp.ndarray:
    """Center pixel of ``psf ⊛ kernel_s`` for every scale, one dispatch
    (the psf_peak values of ``ConvolvePsfs``, multiscale_algorithm.cc:44)."""
    h, w = psf.shape
    pf = forward_fft2(psf)
    conv = inverse_fft2_real(pf[None] * kimg_f, (h, w))
    return conv[:, h // 2, w // 2]


@jax.jit
def _twice_convolved_stack(
    psfs: jnp.ndarray, kimg_f: jnp.ndarray
) -> jnp.ndarray:
    """[S, C, H, W] twice-convolved PSF stack in one dispatch:
    ``ifft(fft(psf_c) * kernel_f[s]^2)`` (the per-scale double convolution
    of ``multiscale_algorithm.cc:331-344``)."""
    h, w = psfs.shape[-2:]
    pf = forward_fft2(psfs)  # [C, ...]
    spec = pf[None, :] * (kimg_f[:, None] * kimg_f[:, None])
    out = inverse_fft2_real(spec, (h, w))
    return out.astype(psfs.dtype)


@partial(jax.jit, donate_argnums=(0,))
def _accum_scale_mask(mask_acc, comp, s):
    """OR the nonzero footprint of a component image into mask_acc[s]
    (device-resident form of ``SubMinorLoop``'s auto-mask update)."""
    nonzero = jnp.any(comp != 0.0, axis=0)
    return mask_acc.at[s].set(mask_acc[s] | nonzero)


def select_maximum_scale(scales: List[ScaleInfo]) -> Optional[int]:
    """Bias-weighted argmax over active scales
    (``multiscale_algorithm.cc:133-151``)."""
    best: Optional[int] = None
    best_val = -1.0
    for i, s in enumerate(scales):
        if s.is_active:
            val = abs(s.max_unnormalized_image_value * s.bias_factor)
            if best is None or val > best_val:
                # Ties keep the lowest scale index: the reference's
                # map::insert keeps the first insertion for a duplicate key.
                best, best_val = i, val
    return best


@partial(
    jax.jit, static_argnames=("perm", "allow_negative", "use_rms")
)
def _scale_maxima_jit(
    integrated: jnp.ndarray,  # [H, W]
    bank_f: jnp.ndarray,  # [S_conv, H, W//2+1] kernel spectra (nonzero scales)
    valid: jnp.ndarray,  # [S, H, W] bool searchable windows
    rms_factor: jnp.ndarray,  # [H, W] (scalar dummy when use_rms=False)
    *,
    perm: Tuple[int, ...],  # per-scale source slot: 0=raw, 1+i=bank[i]
    allow_negative: bool,
    use_rms: bool,
):
    """Fused scale-bank convolution + per-scale masked argmax.

    One device round-trip per outer multiscale iteration instead of one
    dispatch and ~4 scalar transfers *per scale*.  The kernel spectra
    arrive precomputed, so each
    call costs one forward FFT plus one inverse FFT per scale."""
    h, w = integrated.shape
    if bank_f.shape[0]:
        from ..ops.convolution import forward_fft2, inverse_fft2_real

        img_f = forward_fft2(integrated)
        conv = inverse_fft2_real(img_f[None] * bank_f, (h, w)).astype(
            integrated.dtype
        )
        sources = jnp.concatenate([integrated[None], conv])
    else:
        sources = integrated[None]
    images = sources[jnp.asarray(perm)]  # [S, H, W], scale_infos order
    weighted = images * rms_factor if use_rms else images
    cmp = jnp.abs(weighted) if allow_negative else weighted
    masked = jnp.where(valid, cmp, -jnp.inf).reshape(len(perm), h * w)
    idx = jnp.argmax(masked, axis=1)
    peak_cmp = jnp.take_along_axis(masked, idx[:, None], axis=1)[:, 0]
    found = peak_cmp > _FLT_MIN
    xs = (idx % w).astype(jnp.int32)
    ys = (idx // w).astype(jnp.int32)
    signed = jnp.take_along_axis(
        (weighted if use_rms else images).reshape(len(perm), h * w),
        idx[:, None],
        axis=1,
    )[:, 0]
    normalized = signed / rms_factor[ys, xs] if use_rms else signed
    rms = jnp.sqrt(jnp.mean(images * images, axis=(1, 2)))
    return signed, xs, ys, found, normalized, rms


class MultiScaleAlgorithm(DeconvolutionAlgorithm):
    """``cpp/algorithms/multiscale_algorithm.{h,cc}``."""

    def __init__(
        self,
        settings: MultiscaleSettings,
        beam_size: float,
        pixel_scale_x: float,
        pixel_scale_y: float,
        track_components: bool = False,
    ):
        super().__init__()
        self.ms_settings = settings
        pixel_scale = max(pixel_scale_x, pixel_scale_y)
        self.beam_size_in_pixels = (
            beam_size / pixel_scale if pixel_scale > 0.0 else 0.0
        )
        if self.beam_size_in_pixels <= 0.0:
            self.beam_size_in_pixels = 1.0
        self.track_per_scale_masks = False
        self.use_per_scale_masks = False
        self.track_components = track_components
        self.scale_infos: List[ScaleInfo] = []
        self.scale_masks: List[np.ndarray] = []
        self._component_list: Optional[ComponentList] = None
        self._kernel_cache: Dict[Tuple, jnp.ndarray] = {}
        self._valid_stack_cache: Optional[jnp.ndarray] = None
        # Device-resident per-major-iteration tracking state: auto-mask and
        # component updates accumulate on device and flush to host ONCE per
        # major iteration (a per-outer-iteration pull would stall the device
        # every outer iteration).  Sound because masks are written during
        # the tracking phase and read during the (later) use phase, never
        # both within one major iteration (cpp/radler.cc:170-238).
        self._mask_acc: Optional[jnp.ndarray] = None  # [S, H, W] bool
        self._comp_acc: Dict[int, jnp.ndarray] = {}  # scale -> [N, H, W]
        self._weight_cache: Dict[int, jnp.ndarray] = {}

    # -- plumbing used by ParallelDeconvolution ------------------------
    def set_auto_mask_mode(self, track: bool, use: bool) -> None:
        self.track_per_scale_masks = track
        self.use_per_scale_masks = use

    @property
    def scale_count(self) -> int:
        return len(self.scale_infos)

    def scale_size(self, index: int) -> float:
        return self.scale_infos[index].scale

    def get_scale_mask_count(self) -> int:
        return len(self.scale_masks)

    def set_scale_mask_count(self, n: int) -> None:
        while len(self.scale_masks) < n:
            self.scale_masks.append(None)

    def get_scale_mask(self, index: int) -> np.ndarray:
        return self.scale_masks[index]

    def set_scale_mask(self, index: int, mask: np.ndarray) -> None:
        self.scale_masks[index] = mask

    def get_component_list(self) -> ComponentList:
        return self._component_list

    def clear_component_list(self) -> None:
        # The reference resets the list entirely
        # (``multiscale_algorithm.h:46``): a fresh one is allocated with the
        # current (sub-)image dimensions on the next run, so facet boxes may
        # change between major iterations.
        self._component_list = None

    def clone(self) -> "MultiScaleAlgorithm":
        c = super().clone()
        c.scale_infos = []
        c.scale_masks = []
        c._component_list = None
        c._kernel_cache = {}
        c._valid_stack_cache = None
        c._mask_acc = None
        c._comp_acc = {}
        c._weight_cache = {}
        return c

    # -- kernels -------------------------------------------------------
    def _kernel(self, scale: float, height: int, width: int) -> jnp.ndarray:
        key = (round(scale, 6), height, width, self.ms_settings.shape)
        if key not in self._kernel_cache:
            self._kernel_cache[key] = jnp.asarray(
                embedded_kernel(scale, height, width, self.ms_settings.shape)
            )
        return self._kernel_cache[key]

    def _kernel_fft(self, scale: float, height: int, width: int) -> jnp.ndarray:
        """Cached kernel spectrum: the scale kernels are fixed for a run, so
        their transforms are computed once and reused by every convolution
        (the reference re-runs the kernel FFT inside each Convolve call)."""
        key = ("fft", round(scale, 6), height, width, self.ms_settings.shape)
        if key not in self._kernel_cache:
            self._kernel_cache[key] = prepare_kernel_fft(
                self._kernel(scale, height, width)
            )
        return self._kernel_cache[key]

    def _scale_convolve(self, images: jnp.ndarray, scale: float) -> jnp.ndarray:
        if scale == 0.0:
            return images
        h, w = images.shape[-2:]
        return convolve_same_prefft(images, self._kernel_fft(scale, h, w))

    # -- PSF preparation (``ConvolvePsfs``, multiscale_algorithm.cc:29-88) --
    def _convolve_psfs(
        self, psf: jnp.ndarray, is_integrated: bool
    ) -> List[jnp.ndarray]:
        h, w = psf.shape
        convolved = []
        first_auto_scale_size = self.beam_size_in_pixels * 2.0
        for i, entry in enumerate(self.scale_infos):
            cp = (
                self._scale_convolve(psf, entry.scale)
                if entry.scale != 0.0
                else psf
            )
            convolved.append(cp)
            if is_integrated:
                entry.psf_peak = float(cp[h // 2, w // 2])
                if entry.scale == 0.0 or len(self.scale_infos) < 2:
                    exp_term = 0.0
                else:
                    exp_term = math.log2(entry.scale / first_auto_scale_size)
                entry.bias_factor = self.ms_settings.scale_bias ** (-exp_term)
                entry.gain = self.minor_loop_gain / entry.psf_peak
                entry.is_active = True
                log.info(
                    f"- Scale {round(entry.scale)}, bias factor="
                    f"{round(entry.bias_factor * 10.0) / 10.0}, "
                    f"psfpeak={entry.psf_peak}, gain={entry.gain}"
                )
        return convolved

    # -- peak search over all scales -------------------------------------
    def _scale_valid_stack(self, height: int, width: int) -> jnp.ndarray:
        """[S, H, W] bool stack of searchable windows per scale: the
        scale-dependent border (``multiscale_algorithm.cc:597-603``) ANDed
        with the per-scale auto-mask or the clean mask.  Masks and borders
        are fixed within a major iteration, so the stack is cached and
        invalidated at the top of :meth:`execute_major_iteration`."""
        if self._valid_stack_cache is not None:
            return self._valid_stack_cache
        # Mask-free stacks depend only on (scales, shape, border): share the
        # device array across algorithm instances (a fresh Radler per major
        # iteration otherwise re-uploads ~40 MB of windows each perform).
        global_key = None
        if not (self.use_per_scale_masks and self.scale_masks) and (
            self.clean_mask is None
        ):
            global_key = (
                tuple(round(e.scale, 6) for e in self.scale_infos),
                height,
                width,
                round(self.clean_border_ratio, 9),
            )
            cached = _VALID_STACK_CACHE.get(global_key)
            if cached is not None:
                self._valid_stack_cache = cached
                return cached
        stack = np.zeros((len(self.scale_infos), height, width), dtype=bool)
        for i, entry in enumerate(self.scale_infos):
            x_border = int(round(width * self.clean_border_ratio))
            y_border = int(round(height * self.clean_border_ratio))
            if entry.scale != 0.0:
                # FindPeakDirect (scale 0) uses the plain border ratio only.
                border_scale = int(math.ceil(entry.scale * 0.5))
                x_border = max(x_border, border_scale)
                y_border = max(y_border, border_scale)
            m = window_mask(height, width, x_border, y_border)
            if self.use_per_scale_masks and self.scale_masks:
                m = m & np.asarray(self.scale_masks[i])
            elif self.clean_mask is not None:
                m = m & np.asarray(self.clean_mask)
            stack[i] = m
        self._valid_stack_cache = jnp.asarray(stack)
        if global_key is not None:
            if len(_VALID_STACK_CACHE) > 8:
                _VALID_STACK_CACHE.clear()
            _VALID_STACK_CACHE[global_key] = self._valid_stack_cache
        return self._valid_stack_cache

    def _find_active_scale_convolved_maxima(
        self, integrated: jnp.ndarray, report_rms: bool
    ) -> None:
        """Batched equivalent of ``FindActiveScaleConvolvedMaxima``
        (``multiscale_algorithm.cc:578-634``) +
        ``FindSingleScalePeak`` (``threaded_deconvolution_tools.cc:52-107``).

        One jitted call convolves the integrated image with the full scale
        kernel bank (shared image FFT) and reduces every scale's masked
        argmax on-device; a single small host transfer then updates all
        ``ScaleInfo`` entries.  Unlike the reference, *inactive* scales are
        refreshed too — ``select_maximum_scale`` and ``_activate_scales``
        filter on ``is_active``, so this only makes reactivation decisions
        use current rather than stale peaks, and it keeps the compiled
        computation shape-stable across outer iterations (no recompiles
        when the active set changes)."""
        h, w = integrated.shape
        entries = self.scale_infos
        conv_idx = [i for i, s in enumerate(entries) if s.scale != 0.0]
        bank_key = ("bankf", h, w, tuple(entries[i].scale for i in conv_idx))
        if bank_key not in self._kernel_cache:
            self._kernel_cache[bank_key] = (
                jnp.stack(
                    [self._kernel_fft(entries[i].scale, h, w) for i in conv_idx]
                )
                if conv_idx
                else jnp.zeros((0, h, w // 2 + 1), jnp.complex64)
            )
        bank_f = self._kernel_cache[bank_key]
        # Source permutation: slot 0 is the unconvolved image (scale 0),
        # slots 1.. are the bank outputs in ``conv_idx`` order.
        perm = np.zeros(len(entries), np.int32)
        for pos, i in enumerate(conv_idx):
            perm[i] = pos + 1
        use_rms = self.rms_factor_image is not None
        rms_factor = (
            self.rms_factor_image
            if use_rms
            else jnp.ones((), jnp.float32)
        )
        out = _scale_maxima_jit(
            integrated,
            bank_f,
            self._scale_valid_stack(h, w),
            rms_factor,
            perm=tuple(int(p) for p in perm),
            allow_negative=self.allow_negative_components,
            use_rms=use_rms,
        )
        values, xs, ys, found, normalized, rms = jax.device_get(out)
        for i, entry in enumerate(entries):
            if report_rms:
                entry.rms = float(rms[i])
            if bool(found[i]):
                entry.max_unnormalized_image_value = float(values[i])
                entry.max_normalized_image_value = float(normalized[i])
                entry.max_image_value_x = int(xs[i])
                entry.max_image_value_y = int(ys[i])
            else:
                entry.max_unnormalized_image_value = 0.0
                entry.max_normalized_image_value = 0.0

    def _activate_scales(self, scale_with_last_peak: int) -> None:
        """``multiscale_algorithm.cc:636-656``."""
        ref = self.scale_infos[scale_with_last_peak]
        threshold = (
            abs(ref.max_unnormalized_image_value)
            * (1.0 - self.minor_loop_gain)
            * ref.bias_factor
        )
        for i, s in enumerate(self.scale_infos):
            do_activate = (
                i == scale_with_last_peak
                or abs(s.max_unnormalized_image_value) * s.bias_factor
                > threshold
            )
            s.is_active = do_activate

    # -- the major iteration -------------------------------------------
    def execute_major_iteration(
        self, dirty_set, model_set, psfs: jnp.ndarray
    ) -> DeconvolutionResult:
        meta: CubeMeta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        if self.stop_on_negative_components:
            self.allow_negative_components = True
        # Masks/borders may have changed between major iterations.
        self._valid_stack_cache = None
        self._weight_cache = {}
        self._mask_acc = None
        self._comp_acc = {}

        initialize_scales(
            self.scale_infos,
            self.beam_size_in_pixels,
            min(width, height),
            self.ms_settings.shape,
            self.ms_settings.max_scales,
            self.ms_settings.scale_list,
        )

        if self.track_per_scale_masks:
            for mask in self.scale_masks:
                if mask is not None and mask.shape != (height, width):
                    raise RuntimeError(
                        "Invalid automask size in multiscale algorithm"
                    )
            while len(self.scale_masks) < len(self.scale_infos):
                self.scale_masks.append(None)
            for i, mask in enumerate(self.scale_masks):
                if mask is None:
                    self.scale_masks[i] = np.zeros((height, width), dtype=bool)
        if self.track_components:
            if self._component_list is None:
                self._component_list = ComponentList(
                    width,
                    height,
                    len(self.scale_infos),
                    dirty_set.n_images,
                )
            elif (
                self._component_list.width != width
                or self._component_list.height != height
            ):
                raise RuntimeError("Error in component list dimensions!")

        result = DeconvolutionResult()
        if self.component_optimization_algorithm != OptimizationAlgorithm.CLEAN:
            self._run_full_component_fitter(dirty_set, model_set, psfs)
            return result

        if self._fused_eligible(meta, width, height):
            return self._execute_fused(dirty_set, model_set, psfs, result)

        has_hit_threshold_in_sub_loop = False
        threshold_countdown = max(8, len(self.scale_infos) * 3 // 2)

        # Convolved PSF banks: convolvedPSFs[chan][scale].
        integrated_psf = get_integrated_psf(psfs, meta)
        convolved_psfs: List[List[jnp.ndarray]] = [
            self._convolve_psfs(integrated_psf, True)
        ]
        if meta.n_channels > 1:
            convolved_psfs = [
                self._convolve_psfs(psfs[c], False)
                for c in range(meta.n_channels)
            ]

        # Per-scale twice-convolved PSF stacks are invariant within a major
        # iteration; cache them across outer-loop iterations (the reference
        # recomputes them every minor loop, multiscale_algorithm.cc:331-344).
        twice_convolved_cache = {}
        single_convolved_cache = {}

        integrated = get_linear_integrated(dirty_set.data, meta)
        self._find_active_scale_convolved_maxima(integrated, report_rms=True)
        scale_with_peak = select_maximum_scale(self.scale_infos)
        if scale_with_peak is None:
            log.warn("No peak found during multi-scale cleaning! Aborting.")
            result.another_iteration_required = False
            return result

        is_final_threshold = False
        peak_entry = self.scale_infos[scale_with_peak]
        initial_peak_value = abs(
            peak_entry.max_unnormalized_image_value * peak_entry.bias_factor
        )
        m_gain_threshold = initial_peak_value * (1.0 - self.major_loop_gain)
        m_gain_threshold = max(m_gain_threshold, self.major_iteration_threshold)
        first_threshold = m_gain_threshold
        if self.threshold > first_threshold:
            first_threshold = self.threshold
            is_final_threshold = True

        diverging = False

        def current_biased_peak() -> float:
            e = self.scale_infos[scale_with_peak]
            return e.max_unnormalized_image_value * e.bias_factor

        while (
            self.iteration_number < self.max_iterations
            and abs(current_biased_peak()) > first_threshold
            and (
                not self.stop_on_negative_components
                or self.scale_infos[scale_with_peak].max_unnormalized_image_value
                >= 0.0
            )
            and threshold_countdown > 0
            and not diverging
        ):
            entry = self.scale_infos[scale_with_peak]
            scale = entry.scale

            # Twice-convolved PSFs + scale-convolved residual cube
            # (multiscale_algorithm.cc:331-354); PSF stacks are cached per
            # scale for the whole major iteration.
            if scale_with_peak not in twice_convolved_cache:
                twice_convolved_cache[scale_with_peak] = _timed(
                    "twice_convolve_psfs",
                    lambda: jnp.stack(
                        [
                            self._scale_convolve(
                                convolved_psfs[min(c, len(convolved_psfs) - 1)][
                                    scale_with_peak
                                ],
                                scale,
                            )
                            for c in range(meta.n_channels)
                        ]
                    ),
                )
            twice_convolved_psfs = twice_convolved_cache[scale_with_peak]
            individual_convolved = _timed(
                "scale_convolve_residual", self._scale_convolve, dirty_set.data, scale
            )

            sub_gain_threshold = abs(current_biased_peak()) * (
                1.0 - self.ms_settings.sub_minor_loop_gain
            )
            first_sub_threshold = sub_gain_threshold
            if first_threshold > first_sub_threshold:
                first_sub_threshold = first_threshold
                if not has_hit_threshold_in_sub_loop:
                    log.info(
                        "Subminor loop is near minor loop threshold. "
                        "Initiating countdown."
                    )
                    has_hit_threshold_in_sub_loop = True
                threshold_countdown -= 1

            if self.ms_settings.fast_sub_minor_loop:
                diverging = self._run_fast_sub_loop(
                    dirty_set,
                    model_set,
                    meta,
                    convolved_psfs,
                    twice_convolved_psfs,
                    individual_convolved,
                    scale_with_peak,
                    first_sub_threshold,
                    sub_gain_threshold,
                    initial_peak_value,
                    width,
                    height,
                    single_convolved_cache,
                )
                if diverging is None:
                    # Subminor loop found no components (see reference error
                    # message at multiscale_algorithm.cc:417-424).
                    diverging = False
                    break
            else:
                diverging = self._run_slow_sub_loop(
                    dirty_set,
                    model_set,
                    meta,
                    convolved_psfs,
                    twice_convolved_psfs,
                    individual_convolved,
                    scale_with_peak,
                    first_sub_threshold,
                    initial_peak_value,
                )

            self._activate_scales(scale_with_peak)
            integrated = _timed(
                "linear_integrate", get_linear_integrated, dirty_set.data, meta
            )
            _timed(
                "find_scale_maxima",
                self._find_active_scale_convolved_maxima,
                integrated,
                report_rms=False,
            )
            scale_with_peak = select_maximum_scale(self.scale_infos)
            if scale_with_peak is None:
                log.warn(
                    "No peak found in main loop of multi-scale cleaning! "
                    "Aborting deconvolution."
                )
                self._flush_device_tracking()
                result.another_iteration_required = False
                return result
            log.info(
                f"Iteration {self.iteration_number}, scale "
                f"{round(self.scale_infos[scale_with_peak].scale)} px : "
                f"{current_biased_peak():.6g} at "
                f"{self.scale_infos[scale_with_peak].max_image_value_x},"
                f"{self.scale_infos[scale_with_peak].max_image_value_y}"
            )

        self._flush_device_tracking()

        # Stop-reason reporting (multiscale_algorithm.cc:545-575).
        max_iter_reached = self.iteration_number >= self.max_iterations
        negative_reached = (
            self.stop_on_negative_components
            and self.scale_infos[scale_with_peak].max_unnormalized_image_value
            < 0.0
        )
        result.is_diverging = diverging
        result.another_iteration_required = (
            not max_iter_reached
            and not is_final_threshold
            and not negative_reached
            and not diverging
        )
        result.final_peak_value = current_biased_peak()
        return result

    # -- fused on-device path ---------------------------------------------
    def _fused_eligible(self, meta: CubeMeta, width: int, height: int) -> bool:
        """Use the single-program minor loop (``multiscale_fused.py``) when no
        host-side per-outer-iteration state is requested and the precomputed
        per-scale stacks fit comfortably in device memory."""
        if os.environ.get("RADLER_TPU_NO_FUSED_MS"):
            return False
        if not self.ms_settings.fast_sub_minor_loop:
            return False
        if not self.scale_infos:
            return False
        S = len(self.scale_infos)
        split, (ph, pw), (phl, pwl) = self._correction_split(width, height)
        N, C = meta.n_images, meta.n_channels
        # The working set of the spectral-residual fused loop (see
        # multiscale_fused.py): correction spectra are factorized into
        # S + C planes instead of the S*C bank a naive port would hold.
        est = (
            2 * S * C * height * width * 4  # single + twice PSF stacks
            + (S + C) * ph * pw * 8  # kernel + PSF spectra (small bucket)
            + (S - split + C) * phl * pwl * 8  # large bucket spectra
            + N * ph * pw * 8  # spectral residual res_f
            + 2 * N * ph * pw * 8  # spectral-subtract temporaries
            + 2 * max(S, N) * ph * pw * 4  # maxima / cube inverse transients
            + S * height * width  # search windows
            + 6 * N * height * width * 4  # cube copies + padded PSF transient
        )
        # Auto-mask / component accumulators carried through the loop
        # (tracked device-side, flushed once per major iteration).
        if self.track_per_scale_masks:
            est += S * height * width
        if self.track_components:
            est += 2 * S * N * height * width * 4
        return fits_device_memory(est, 0.5)

    def _correction_split(self, width: int, height: int):
        """Partition the (ascending) scale set into a small and a large
        correction-size bucket.

        The reference pads each scale's correction FFT to its OWN
        convolution size (``fft_size_calculations.h:39-50``).  The fused
        loop's spectral residual lives at ONE unified padded size, which
        every outer iteration's maxima refresh and subminor cube pay — so
        that size should stay close to the smallest scale's convolution
        size.  Scales whose own convolution size is much larger (rarely
        selected after the first iterations) take a ``lax.cond`` branch
        that corrects at the large padded size.

        Returns (split, (pa_h, pa_w), (pb_h, pb_w)): scales [0, split) use
        the small (unified) size, [split, S) the large one; split == S
        means one bucket."""
        pad = self.ms_settings.convolution_padding
        sizes = [
            (
                get_convolution_size(e.scale, height, pad),
                get_convolution_size(e.scale, width, pad),
            )
            for e in self.scale_infos
        ]
        pb = sizes[-1]
        # RADLER_TPU_MS_BUCKETS=1 opts out of the two-bucket lax.cond (one
        # unified size = the largest scale's; smaller program, slower).
        n_buckets = int(os.environ.get("RADLER_TPU_MS_BUCKETS", "2"))
        if n_buckets < 2:
            return len(sizes), pb, pb
        # Largest prefix whose padded area stays within 30% of the smallest
        # scale's — the per-outer-iteration tax every scale pays.
        base = sizes[0][0] * sizes[0][1]
        split = len(sizes)
        for i, (sh, sw) in enumerate(sizes):
            if sh * sw > 1.30 * base:
                split = i
                break
        if split == 0 or split == len(sizes):
            return len(sizes), pb, pb
        pa = sizes[split - 1]
        return split, pa, pb

    def _prepare_fused_banks(
        self, meta: CubeMeta, width: int, height: int, psfs: jnp.ndarray
    ):
        """Per-scale PSF/kernel banks for the fused minor loop; shared by the
        single-image path and the batched-facet path (the banks depend only
        on the box size and the PSF, not on the residual).

        Results are cached at module level keyed by the PSF array identity
        (a strong reference is held, so ``is`` comparison cannot alias a
        recycled id) plus every config input: serial facet clones and
        successive major iterations stop rebuilding — and stop holding
        duplicate copies of — the multi-GB bank set.

        Correction spectra are FACTORIZED: the reference prepares the
        single-convolved PSFs ``kernel_s ⊛ psf_c`` as an S x C bank
        (``ConvolvePsfs``, ``multiscale_algorithm.cc:29-88``); spectrally
        that product is ``kernel_f[s] * psf_f[c]``, so only S kernel planes
        and C PSF planes are stored per padded-size bucket and the product
        fuses into the loop's spectral subtraction (the only deviation is
        that the factorized product is the clean linear convolution at the
        padded size, where the reference's bank carries the image-size
        circular wrap of kernel ⊛ psf — a tolerance-level tail difference).
        """
        from ..ops.convolution import centered_embed_kernel_fft

        S = len(self.scale_infos)

        split, (pa_h, pa_w), (pb_h, pb_w) = self._correction_split(
            width, height
        )
        cache_key = (
            width,
            height,
            meta,
            tuple(e.scale for e in self.scale_infos),
            self.ms_settings.shape,
            self.ms_settings.scale_bias,
            self.minor_loop_gain,
            split,
            (pa_h, pa_w),
            (pb_h, pb_w),
        )
        for key, psfs_ref, peaks_c, value in _FUSED_BANK_CACHE:
            if key == cache_key and psfs_ref is psfs:
                # bias/gain side effects must still land on THIS clone.
                self._apply_psf_peaks(peaks_c)
                return value

        # Compact host-side kernel stack [S, kmax, kmax]: the scale kernels
        # have small support (tapered-quadratic: scale+1 pixels), so a few
        # MB travel to the device and ONE jitted call embeds + transforms a
        # whole bank — full-canvas embedded kernels would be 100s of MB of
        # zeros to copy from host to device.
        compact = _timed(
            "bank_kernel_stack_host", self._compact_kernel_stack, width, height
        )
        compact_dev = jnp.asarray(compact)

        # Integrated-PSF pass: per-scale convolved PSF peaks set
        # psf_peak/bias/gain (``ConvolvePsfs``, multiscale_algorithm.cc:
        # 29-88) — one dispatch, one [S]-vector fetch (the host path's
        # per-scale float() pulls are S device-to-host round trips).
        integrated_psf = get_integrated_psf(psfs, meta)
        kimg_f = centered_embed_kernel_fft(compact_dev, (height, width))
        peaks = np.asarray(
            _timed(
                "bank_integrated_peaks",
                _scale_convolved_center_values,
                integrated_psf,
                kimg_f,
            )
        )
        self._apply_psf_peaks(peaks)

        # Per-channel correction PSFs (the integrated PSF for single-channel
        # runs, matching the host path's single_convolved_cache source).
        corr_psfs = (
            psfs
            if meta.n_channels > 1
            else integrated_psf[None]
        )

        # [S, C, H, W] twice-convolved PSF stack for the subminor's patch
        # subtraction (image size, as in the reference): one dispatch,
        # twice[s, c] = ifft(fft(psf_c) * kernel_f[s]^2).
        twice = _timed(
            "bank_twice_psfs", _twice_convolved_stack, corr_psfs, kimg_f
        )

        kernel_f = _timed(
            "bank_kernel_spectra",
            centered_embed_kernel_fft,
            compact_dev,
            (pa_h, pa_w),
        )
        psf_f = _timed(
            "bank_psf_spectra",
            centered_embed_kernel_fft,
            jnp.asarray(corr_psfs),
            (pa_h, pa_w),
        )
        if split < S:
            kernel_f_large = _timed(
                "bank_kernel_spectra",
                centered_embed_kernel_fft,
                compact_dev[split:],
                (pb_h, pb_w),
            )
            psf_f_large = _timed(
                "bank_psf_spectra",
                centered_embed_kernel_fft,
                jnp.asarray(corr_psfs),
                (pb_h, pb_w),
            )
        else:
            # Single bucket: 1-row placeholders keep the pytree static.
            kernel_f_large = kernel_f[:1]
            psf_f_large = psf_f[:1]

        bias = jnp.asarray(
            [e.bias_factor for e in self.scale_infos], jnp.float32
        )
        gain_arr = jnp.asarray(
            [e.gain for e in self.scale_infos], jnp.float32
        )
        value = (
            kernel_f,
            twice,
            psf_f,
            kernel_f_large,
            psf_f_large,
            bias,
            gain_arr,
            split,
            (pa_h, pa_w),
            (pb_h, pb_w),
        )
        if len(_FUSED_BANK_CACHE) >= 3:
            _FUSED_BANK_CACHE.pop(0)
        _FUSED_BANK_CACHE.append((cache_key, psfs, peaks, value))
        return value

    def _compact_kernel_stack(self, width: int, height: int) -> np.ndarray:
        """[S, kmax, kmax] stack of centered scale kernels (scale 0 = a
        centered delta, whose origin-rolled spectrum is exactly flat)."""
        kernels = []
        for e in self.scale_infos:
            if e.scale == 0.0:
                kernels.append(np.ones((1, 1), np.float32))
            else:
                kernels.append(
                    make_shape_function(
                        e.scale, min(width, height), self.ms_settings.shape
                    )
                )
        kmax = max(k.shape[0] for k in kernels)
        stack = np.zeros((len(kernels), kmax, kmax), np.float32)
        for i, k in enumerate(kernels):
            n = k.shape[0]
            oy = kmax // 2 - n // 2
            ox = kmax // 2 - n // 2
            stack[i, oy : oy + n, ox : ox + n] = k
        return stack

    def _apply_psf_peaks(self, peaks: np.ndarray) -> None:
        """Set psf_peak/bias_factor/gain per scale from the fetched
        convolved-PSF center values (``ConvolvePsfs`` side effects,
        multiscale_algorithm.cc:29-88)."""
        first_auto_scale_size = self.beam_size_in_pixels * 2.0
        for i, entry in enumerate(self.scale_infos):
            entry.psf_peak = float(peaks[i])
            if entry.scale == 0.0 or len(self.scale_infos) < 2:
                exp_term = 0.0
            else:
                exp_term = math.log2(entry.scale / first_auto_scale_size)
            entry.bias_factor = self.ms_settings.scale_bias ** (-exp_term)
            entry.gain = self.minor_loop_gain / entry.psf_peak
            entry.is_active = True
            log.info(
                f"- Scale {round(entry.scale)}, bias factor="
                f"{round(entry.bias_factor * 10.0) / 10.0}, "
                f"psfpeak={entry.psf_peak}, gain={entry.gain}"
            )

    @staticmethod
    def _forced_terms_or_dummy(fitter) -> jnp.ndarray:
        """The FORCED-mode term images for the fused loop, or the unused
        [1,1,1] placeholder for other fitting modes.  FORCED mode with no
        term images set raises like the host path
        (``spectral_fitting.py::_forced_fit``) instead of silently fitting
        flat spectra off the zero dummy's clamped indexing."""
        if (
            fitter is not None
            and fitter.mode == SpectralFittingMode.FORCED_TERMS
        ):
            if fitter._forced_terms is None:
                raise RuntimeError("Forced terms have not been set")
            return fitter._forced_terms
        return jnp.zeros((1, 1, 1), jnp.float32)

    def _execute_fused(
        self, dirty_set, model_set, psfs: jnp.ndarray, result
    ) -> DeconvolutionResult:
        """One fully on-device major iteration (see ``multiscale_fused.py``)."""
        from .multiscale_fused import fused_multiscale_minor_loop

        meta: CubeMeta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        S = len(self.scale_infos)

        (
            kernel_f,
            twice,
            psf_f,
            kernel_f_large,
            psf_f_large,
            bias,
            gain_arr,
            split,
            padded_small,
            padded_large,
        ) = _timed(
            "fused_banks_total",
            self._prepare_fused_banks,
            meta,
            width,
            height,
            psfs,
        )

        valid_stack = _timed(
            "valid_stack", self._scale_valid_stack, height, width
        )
        use_rms = self.rms_factor_image is not None
        rms_factor = (
            self.rms_factor_image
            if use_rms
            else jnp.ones((height, width), jnp.float32)
        )
        fitter = (
            self.spectral_fitter
            if (
                self.spectral_fitter is not None
                and self.spectral_fitter.is_active
            )
            else None
        )
        residual_in = dirty_set.data
        model_in = model_set.data
        # An explicitly-requested 1-device mesh runs the identical
        # partitioned program with degenerate collectives
        # (benchmarks/config5_proxy.py --mesh).
        if self.device_mesh is not None:
            # Multi-chip: lay the cube and the per-scale banks over the
            # ("chan", "tile") mesh and let XLA partition the whole minor
            # loop — the scale-bank FFTs batch across devices and the
            # maxima search becomes a tile max-reduce (the reference's
            # per-scale threads, threaded_deconvolution_tools.cc:30-50).
            from ..parallel.mesh import shard_multiscale_inputs

            # The bank arrays are stable across major iterations (module
            # bank cache) — memoize their mesh placement by identity so
            # every major after the first re-places only the per-major
            # residual/model/rms (an unplaced->NamedSharding device_put is
            # a real reshard dispatch per array per major otherwise).
            bank_key = (kernel_f, twice, psf_f, kernel_f_large,
                        psf_f_large, valid_stack)
            memo = _MESH_PLACEMENT_CACHE.get(id(self.device_mesh))
            if memo is not None and all(
                a is b for a, b in zip(memo[0], bank_key)
            ):
                placed_banks = memo[1]
                (
                    residual_in,
                    model_in,
                    _kf,
                    _tw,
                    _pf,
                    _kfl,
                    _pfl,
                    _vs,
                    rms_factor,
                ) = shard_multiscale_inputs(
                    self.device_mesh,
                    residual_in,
                    model_in,
                    *placed_banks[:5],
                    placed_banks[5],
                    rms_factor,
                )
                (kernel_f, twice, psf_f, kernel_f_large, psf_f_large,
                 valid_stack) = placed_banks
            else:
                (
                    residual_in,
                    model_in,
                    kernel_f,
                    twice,
                    psf_f,
                    kernel_f_large,
                    psf_f_large,
                    valid_stack,
                    rms_factor,
                ) = shard_multiscale_inputs(
                    self.device_mesh,
                    residual_in,
                    model_in,
                    kernel_f,
                    twice,
                    psf_f,
                    kernel_f_large,
                    psf_f_large,
                    valid_stack,
                    rms_factor,
                )
                _MESH_PLACEMENT_CACHE[id(self.device_mesh)] = (
                    bank_key,
                    (kernel_f, twice, psf_f, kernel_f_large, psf_f_large,
                     valid_stack),
                    self.device_mesh,  # strong ref keeps id() valid
                )

        out = _timed(
            "fused_minor_loop",
            fused_multiscale_minor_loop,
            residual_in,
            model_in,
            kernel_f,
            twice,
            psf_f,
            kernel_f_large,
            psf_f_large,
            valid_stack,
            rms_factor,
            bias,
            gain_arr,
            jnp.float32(self.threshold),
            jnp.float32(self.major_iteration_threshold),
            jnp.float32(self.major_loop_gain),
            jnp.float32(self.ms_settings.sub_minor_loop_gain),
            jnp.float32(self.minor_loop_gain),
            jnp.float32(self.divergence_limit),
            jnp.int32(self.iteration_number),
            jnp.int32(self.max_iterations),
            jnp.int32(max(8, S * 3 // 2)),
            self._forced_terms_or_dummy(fitter),
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fitter,
            use_rms=use_rms,
            split=split,
            padded_small=padded_small,
            padded_large=padded_large,
            track_masks=self.track_per_scale_masks,
            track_components=self.track_components,
        )
        dirty_set.data = out.residual
        model_set.data = out.model
        (it, peak, any_found, diverging, no_components, is_final, ncomp,
         flux) = jax.device_get(
            (
                out.iteration_number,
                out.final_biased_peak,
                out.any_peak_found,
                out.diverging,
                out.no_components,
                out.is_final_threshold,
                out.components_per_scale,
                out.flux_per_scale,
            )
        )
        self.iteration_number = int(it)
        for i, e in enumerate(self.scale_infos):
            e.n_components_cleaned += int(ncomp[i])
            e.total_flux_cleaned += float(flux[i])
        # Flush the on-device auto-mask / component accumulators to host
        # state — one transfer per major iteration, as in the host path.
        if self.track_per_scale_masks:
            self._mask_acc = out.mask_acc
        if self.track_components:
            self._comp_acc = {
                i: out.comp_acc[i]
                for i in range(len(self.scale_infos))
                if int(ncomp[i]) > 0
            }
        self._flush_device_tracking()
        result.final_peak_value = float(peak)
        if not bool(any_found):
            log.warn("No peak found during multi-scale cleaning! Aborting.")
            result.another_iteration_required = False
            return result
        # Stop-reason reporting (multiscale_algorithm.cc:545-575); a subminor
        # pass that cleaned nothing breaks the loop like the host path's
        # error break (multiscale_algorithm.cc:417-424).
        max_iter_reached = self.iteration_number >= self.max_iterations
        negative_reached = (
            self.stop_on_negative_components and float(peak) < 0.0
        )
        result.is_diverging = bool(diverging)
        result.another_iteration_required = (
            not max_iter_reached
            and not bool(is_final)
            and not negative_reached
            and not bool(diverging)
        )
        if bool(no_components):
            log.error(
                "Could not continue multi-scale clean, because the sub-minor "
                "loop failed to find components."
            )
        return result

    # -- batched facet execution ------------------------------------------
    def batched_facets_eligible(
        self,
        meta: CubeMeta,
        box_w: int,
        box_h: int,
        n_facets: int,
        n_unique_psfs: int = 1,
    ) -> bool:
        """Whether the vmapped fused loop can run ``n_facets`` facets of
        ``box_h x box_w`` in one program (``ParallelDeconvolution`` checks
        the cross-facet conditions; this checks per-algorithm state and
        device memory)."""
        initialize_scales(
            self.scale_infos,
            self.beam_size_in_pixels,
            min(box_w, box_h),
            self.ms_settings.shape,
            self.ms_settings.max_scales,
            self.ms_settings.scale_list,
        )
        if not self._fused_eligible(meta, box_w, box_h):
            return False
        # The per-facet state multiplies by F where the banks stay shared.
        # The dominant per-facet terms of the spectral-residual loop
        # (multiscale_fused.py): the complex res_f at the unified padded
        # size (x2: while-loop carries double-buffer), the padded PSF for
        # the dense subtraction, the spectral-subtract temporaries, and the
        # maxima/cube inverse transients.  Vmapped facets must stay well
        # under the device budget, or the serial loop wins by actually
        # running.
        N, C = meta.n_images, meta.n_channels
        S = max(len(self.scale_infos), 1)
        split, (ph, pw), (phl, pwl) = self._correction_split(box_w, box_h)
        per_facet = (
            2 * N * ph * pw * 8  # res_f carry (double-buffered)
            + 2 * N * ph * pw * 8  # spectral-subtract temporaries
            + 2 * N * box_h * box_w * 4  # comp carry
            + max(S, N) * ph * pw * 4  # maxima / cube inverse transients
            + 6 * N * box_h * box_w * 4  # residual/model carries + psf_pad
        )
        if self.track_per_scale_masks or self.use_per_scale_masks:
            per_facet += 2 * S * box_h * box_w
        if self.track_components:
            per_facet += 2 * S * N * box_h * box_w * 4
        extra = n_facets * per_facet
        if n_unique_psfs > 1:
            # Direction-dependent PSFs: the twice-convolved stacks and
            # per-facet PSF spectra are gathered per facet.
            extra += n_facets * S * C * box_h * box_w * 4
            extra += n_facets * C * (ph * pw + phl * pwl) * 8
        return fits_device_memory(extra, 0.5)

    def execute_batched_facets(
        self,
        facet_residual: jnp.ndarray,  # [F, N, Hb, Wb]
        facet_model: jnp.ndarray,  # [F, N, Hb, Wb]
        psfs: jnp.ndarray,  # [C, Hb, Wb] shared, or [U, C, Hb, Wb] DD banks
        facet_boxes,  # list of (sw, sh) true facet sizes, top-left placed
        facet_masks: np.ndarray,  # [F, Hb, Wb] bool search masks
        facet_rms: Optional[jnp.ndarray],  # [F, Hb, Wb] or None
        major_iteration_threshold: float,
        start_iterations: np.ndarray,  # [F] int
        find_peak_only: bool,
        meta: CubeMeta,
        facet_psf_slot=None,  # [F] index into the U axis (DD PSFs)
        facet_scale_masks=None,  # [F, S, Hb, Wb] bool loaded per-scale masks
        facet_forced_terms=None,  # [F, T-1, Hb, Wb] (FORCED-mode fitter)
    ):
        """All facets' minor loops as ONE vmapped device program.

        The reference farms facets to threads
        (``parallel_deconvolution.cc:606-617``, ``RecursiveFor::NestedRun``);
        here the facet axis is a vmap batch axis of the fused multiscale
        minor loop: the scale banks are shared (facets are padded to a
        common box), the per-facet while-loops run in lockstep until every
        facet reaches its threshold, and the host sees one dispatch per
        phase instead of one per facet.  With direction-dependent PSFs
        (``psfs`` 4-D + ``facet_psf_slot``) the PSF-dependent banks are
        built per unique PSF and gathered along the facet axis, so per-facet
        bias/gain schedules match the serial path's per-clone state
        (``parallel_deconvolution.cc:229-242``).  Returns ``(residual
        [F,N,Hb,Wb], model [F,N,Hb,Wb], results, iterations, mask_acc,
        comp_acc)`` where the last two are the per-facet tracking
        accumulators ([F,S,Hb,Wb] / [F,S,N,Hb,Wb], dummies when untracked).
        """
        from functools import partial as _partial

        from .multiscale_fused import fused_multiscale_minor_loop

        if (
            self.spectral_fitter is not None
            and self.spectral_fitter.mode == SpectralFittingMode.FORCED_TERMS
            and facet_forced_terms is None
        ):
            raise RuntimeError("Forced terms have not been set")
        F, N, Hb, Wb = facet_residual.shape
        initialize_scales(
            self.scale_infos,
            self.beam_size_in_pixels,
            min(Wb, Hb),
            self.ms_settings.shape,
            self.ms_settings.max_scales,
            self.ms_settings.scale_list,
        )
        S = len(self.scale_infos)
        per_facet_psfs = psfs.ndim == 4
        if per_facet_psfs:
            # Build banks per unique PSF; the scale-kernel spectra are
            # PSF-independent (identical every call), the PSF stacks and
            # bias/gain schedules differ.
            twice_u, pf_u, pfl_u, bias_u, gain_u = [], [], [], [], []
            for u in range(psfs.shape[0]):
                (
                    kernel_f,
                    twice_1,
                    pf_1,
                    kernel_f_large,
                    pfl_1,
                    bias_1,
                    gain_1,
                    split,
                    padded_small,
                    padded_large,
                ) = self._prepare_fused_banks(meta, Wb, Hb, psfs[u])
                twice_u.append(twice_1)
                pf_u.append(pf_1)
                pfl_u.append(pfl_1)
                bias_u.append(bias_1)
                gain_u.append(gain_1)
            slot = jnp.asarray(np.asarray(facet_psf_slot, np.int32))
            twice = jnp.stack(twice_u)[slot]  # [F, S, C, Hb, Wb]
            psf_f = jnp.stack(pf_u)[slot]  # [F, C, PHa, ...]
            psf_f_large = jnp.stack(pfl_u)[slot]
            bias = jnp.stack(bias_u)[slot]  # [F, S]
            gain_arr = jnp.stack(gain_u)[slot]  # [F, S]
        else:
            (
                kernel_f,
                twice,
                psf_f,
                kernel_f_large,
                psf_f_large,
                bias,
                gain_arr,
                split,
                padded_small,
                padded_large,
            ) = self._prepare_fused_banks(meta, Wb, Hb, psfs)

        # Per-facet searchable windows: the scale-dependent border applies
        # to the TRUE facet box (multiscale_algorithm.cc:597-603), not the
        # padded canvas; padding stays unsearchable via the facet mask.
        stacks = np.zeros((F, S, Hb, Wb), dtype=bool)
        for f, (sw, sh) in enumerate(facet_boxes):
            for i, entry in enumerate(self.scale_infos):
                xb = int(round(sw * self.clean_border_ratio))
                yb = int(round(sh * self.clean_border_ratio))
                if entry.scale != 0.0:
                    border_scale = int(math.ceil(entry.scale * 0.5))
                    xb = max(xb, border_scale)
                    yb = max(yb, border_scale)
                stacks[f, i, :sh, :sw] = window_mask(sh, sw, xb, yb)
            stacks[f] &= facet_masks[f][None]
        if self.use_per_scale_masks and facet_scale_masks is not None:
            # Phase-2 auto-masking: each scale searches only its own tracked
            # positions (the serial path's per-facet mask load,
            # ``parallel_deconvolution.cc:359-390``).
            stacks &= np.asarray(facet_scale_masks, dtype=bool)

        use_rms = facet_rms is not None
        rms = (
            jnp.asarray(facet_rms)
            if use_rms
            else jnp.ones((F, Hb, Wb), jnp.float32)
        )
        fitter = (
            self.spectral_fitter
            if (
                self.spectral_fitter is not None
                and self.spectral_fitter.is_active
            )
            else None
        )
        starts = jnp.asarray(start_iterations, jnp.int32)
        if find_peak_only:
            max_iters = starts  # zero remaining iterations -> peak only
        else:
            max_iters = jnp.full((F,), self.max_iterations, jnp.int32)

        loop = _partial(
            fused_multiscale_minor_loop,
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fitter,
            use_rms=use_rms,
            split=split,
            padded_small=padded_small,
            padded_large=padded_large,
            track_masks=self.track_per_scale_masks,
            track_components=self.track_components,
        )
        psf_axis = 0 if per_facet_psfs else None
        in_axes = (
            0,  # residual
            0,  # model
            None,  # kernel_f
            psf_axis,  # twice_psfs
            psf_axis,  # psf_f
            None,  # kernel_f_large
            psf_axis,  # psf_f_large
            0,  # valid_stack
            0,  # rms_factor
            psf_axis,  # bias
            psf_axis,  # gain_arr
            None,  # threshold
            None,  # major_iteration_threshold
            None,  # major_loop_gain
            None,  # sub_loop_gain
            None,  # minor_loop_gain
            None,  # divergence_limit
            0,  # start_iteration
            0,  # max_iterations
            None,  # countdown0
            0 if facet_forced_terms is not None else None,  # forced_terms
        )
        inputs = [
            facet_residual,
            facet_model,
            kernel_f,
            twice,
            psf_f,
            kernel_f_large,
            psf_f_large,
            jnp.asarray(stacks),
            rms,
            bias,
            gain_arr,
            jnp.float32(self.threshold),
            jnp.float32(major_iteration_threshold),
            jnp.float32(self.major_loop_gain),
            jnp.float32(self.ms_settings.sub_minor_loop_gain),
            jnp.float32(self.minor_loop_gain),
            jnp.float32(self.divergence_limit),
            starts,
            max_iters,
            jnp.int32(max(8, S * 3 // 2)),
            (
                jnp.asarray(facet_forced_terms)
                if facet_forced_terms is not None
                else jnp.zeros((1, 1, 1), jnp.float32)
            ),
        ]
        if self.device_mesh is not None and self.device_mesh.size > 1:
            # Facet x mesh composition: the F axis is embarrassingly
            # parallel — shard it over the mesh so F facets on F devices
            # cost one facet's wall time (parallel_deconvolution.cc:606-617
            # farmed to ICI instead of threads).
            from ..parallel.mesh import shard_facet_inputs

            inputs = shard_facet_inputs(self.device_mesh, inputs, in_axes)
        out = jax.vmap(loop, in_axes=in_axes)(*inputs)

        (it, peak, any_found, diverging, no_components, is_final, ncomp) = (
            jax.device_get(
                (
                    out.iteration_number,
                    out.final_biased_peak,
                    out.any_peak_found,
                    out.diverging,
                    out.no_components,
                    out.is_final_threshold,
                    out.components_per_scale,
                )
            )
        )
        results = []
        for f in range(F):
            result = DeconvolutionResult()
            result.final_peak_value = float(peak[f])
            if not find_peak_only:
                for i, e in enumerate(self.scale_infos):
                    e.n_components_cleaned += int(ncomp[f, i])
            if not bool(any_found[f]):
                result.another_iteration_required = False
            else:
                max_iter_reached = int(it[f]) >= self.max_iterations
                negative_reached = (
                    self.stop_on_negative_components and float(peak[f]) < 0.0
                )
                result.is_diverging = bool(diverging[f])
                result.another_iteration_required = (
                    not max_iter_reached
                    and not bool(is_final[f])
                    and not negative_reached
                    and not bool(diverging[f])
                )
            if bool(no_components[f]) and not find_peak_only:
                log.error(
                    "Could not continue multi-scale clean in facet %d: the "
                    "sub-minor loop failed to find components." % f
                )
            results.append(result)
        return out.residual, out.model, results, it, out.mask_acc, out.comp_acc

    def _flush_device_tracking(self) -> None:
        """Pull the device-accumulated auto-mask / component updates to host
        state — ONE transfer per major iteration instead of one per outer
        iteration (``SubMinorLoop``'s update hooks, ``subminor_loop.cc:
        220-246``; duplicate component entries merge exactly as
        ``ComponentList::MergeDuplicates`` would)."""
        if self._mask_acc is not None:
            acc = np.asarray(self._mask_acc)
            for i in range(min(len(self.scale_masks), acc.shape[0])):
                self.scale_masks[i] |= acc[i]
            self._mask_acc = None
        if self._comp_acc:
            for scale_index, comp in sorted(self._comp_acc.items()):
                comp_h = np.asarray(comp)
                ys, xs = np.nonzero(np.any(comp_h != 0.0, axis=0))
                for j in range(xs.size):
                    self._component_list.add(
                        int(xs[j]),
                        int(ys[j]),
                        scale_index,
                        comp_h[:, ys[j], xs[j]],
                    )
            self._comp_acc = {}

    # -- fast (subminor) path -------------------------------------------
    def _run_fast_sub_loop(
        self,
        dirty_set,
        model_set,
        meta: CubeMeta,
        convolved_psfs,
        twice_convolved_psfs,
        individual_convolved,
        scale_with_peak: int,
        first_sub_threshold: float,
        sub_gain_threshold: float,
        initial_peak_value: float,
        width: int,
        height: int,
        single_convolved_cache,
    ):
        """``multiscale_algorithm.cc:377-461``.  Returns diverging flag, or
        ``None`` when the subminor loop found no components."""
        if height * width <= 4096 * 4096 and not os.environ.get(
            "RADLER_TPU_NO_DENSE_SUBMINOR"
        ):
            # The dense masked clean (no K-gather, no per-capacity-bucket
            # recompiles) matches the sparse candidate set to fp tolerance;
            # see multiscale_fused.py's module docstring.
            return self._run_fast_sub_loop_dense(
                dirty_set,
                model_set,
                meta,
                convolved_psfs,
                twice_convolved_psfs,
                individual_convolved,
                scale_with_peak,
                first_sub_threshold,
                sub_gain_threshold,
                initial_peak_value,
                width,
                height,
                single_convolved_cache,
            )
        entry = self.scale_infos[scale_with_peak]
        sub_start_iteration = self.iteration_number
        conv_w = get_convolution_size(
            entry.scale, width, self.ms_settings.convolution_padding
        )
        conv_h = get_convolution_size(
            entry.scale, height, self.ms_settings.convolution_padding
        )
        sub = SubMinorLoop(width, height, conv_w, conv_h)
        sub.set_iteration_info(self.iteration_number, self.max_iterations)
        sub.set_threshold(
            first_sub_threshold / entry.bias_factor,
            sub_gain_threshold / entry.bias_factor,
        )
        sub.set_gain(entry.gain)
        sub.divergence_limit = self.divergence_limit
        sub.allow_negative_components = self.allow_negative_components
        sub.stop_on_negative_component = self.stop_on_negative_components
        scale_border = int(math.ceil(entry.scale * 0.5))
        sub.set_clean_borders(
            max(int(round(width * self.clean_border_ratio)), scale_border),
            max(int(round(height * self.clean_border_ratio)), scale_border),
        )
        if self.rms_factor_image is not None:
            sub.rms_factor_image = self.rms_factor_image
        if self.use_per_scale_masks and self.scale_masks:
            sub.mask = self.scale_masks[scale_with_peak]
        elif self.clean_mask is not None:
            sub.mask = self.clean_mask

        diverging, peak_value = _timed(
            "subminor_run",
            sub.run,
            individual_convolved,
            meta,
            twice_convolved_psfs,
            self.spectral_fitter,
        )
        if self.divergence_limit != 0.0 and peak_value is not None:
            diverging = diverging or (
                abs(peak_value) > initial_peak_value * self.divergence_limit
            )
        if peak_value is None:
            log.error(
                "Could not continue multi-scale clean, because the sub-minor "
                "loop failed to find components."
            )
            return None

        self.iteration_number = sub.current_iteration
        entry.n_components_cleaned += (
            self.iteration_number - sub_start_iteration
        )
        entry.total_flux_cleaned += sub.flux_cleaned

        # Residual correction with the single-convolved PSFs + model add-back
        # of the scale-convolved sparse model (multiscale_algorithm.cc:432-461).
        if scale_with_peak not in single_convolved_cache:
            single_convolved_cache[scale_with_peak] = jnp.stack(
                [
                    convolved_psfs[min(c, len(convolved_psfs) - 1)][
                        scale_with_peak
                    ]
                    for c in range(meta.n_channels)
                ]
            )
        single_psfs = single_convolved_cache[scale_with_peak]
        new_residual, full_model = _timed(
            "correct_residual",
            sub.correct_residual_dirty,
            dirty_set.data,
            single_psfs,
        )
        dirty_set.data = new_residual
        if self.track_per_scale_masks:
            _timed(
                "update_auto_mask",
                sub.update_auto_mask,
                self.scale_masks[scale_with_peak],
            )
        if self.track_components:
            _timed(
                "update_component_list",
                sub.update_component_list,
                self._component_list,
                scale_with_peak,
            )
        model_add = _timed(
            "model_add_convolve", self._scale_convolve, full_model, entry.scale
        )
        model_set.data = model_set.data + model_add
        return diverging

    def _run_fast_sub_loop_dense(
        self,
        dirty_set,
        model_set,
        meta: CubeMeta,
        convolved_psfs,
        twice_convolved_psfs,  # [C, H, W]
        individual_convolved,  # [N, H, W]
        scale_with_peak: int,
        first_sub_threshold: float,
        sub_gain_threshold: float,
        initial_peak_value: float,
        width: int,
        height: int,
        single_convolved_cache,
    ):
        """Dense-kernel variant of :meth:`_run_fast_sub_loop` (same contract).

        The Clark candidate set becomes a dense masked clean over the
        scale-convolved cube; auto-mask and component tracking read the
        resulting component image instead of a sparse coordinate buffer.
        """
        from .multiscale_fused import dense_subminor_loop, pad_psf_planes
        from .subminor import _correct_residual

        entry = self.scale_infos[scale_with_peak]
        sub_start_iteration = self.iteration_number
        conv_w = get_convolution_size(
            entry.scale, width, self.ms_settings.convolution_padding
        )
        conv_h = get_convolution_size(
            entry.scale, height, self.ms_settings.convolution_padding
        )
        # Search weight: scale border window x (per-scale or clean mask) x
        # rms factor — identical to the sparse path's selection inputs.
        use_rms = self.rms_factor_image is not None
        rms = (
            self.rms_factor_image
            if use_rms
            else jnp.ones((height, width), jnp.float32)
        )
        weight = self._weight_cache.get(scale_with_peak)
        if weight is None:
            # Masks/borders/rms are fixed within a major iteration, so the
            # search weight is built (and uploaded) once per scale.
            scale_border = int(math.ceil(entry.scale * 0.5))
            hb = max(
                int(round(width * self.clean_border_ratio)), scale_border
            )
            vb = max(
                int(round(height * self.clean_border_ratio)), scale_border
            )
            host_weight = window_mask(height, width, hb, vb).astype(
                np.float32
            )
            if self.use_per_scale_masks and self.scale_masks:
                host_weight *= np.asarray(
                    self.scale_masks[scale_with_peak], np.float32
                )
            elif self.clean_mask is not None:
                host_weight *= np.asarray(self.clean_mask, np.float32)
            weight = jnp.asarray(host_weight)
            if use_rms:
                weight = weight * rms
            self._weight_cache[scale_with_peak] = weight

        psf_pad = pad_psf_planes(
            twice_convolved_psfs[jnp.asarray(meta.psf_indices)]
        )
        fitter = (
            self.spectral_fitter
            if (
                self.spectral_fitter is not None
                and self.spectral_fitter.is_active
            )
            else None
        )
        _conv_res, comp, it_d, value_d, found_d, div_d = dense_subminor_loop(
            individual_convolved,
            psf_pad,
            weight,
            rms,
            jnp.float32(first_sub_threshold / entry.bias_factor),
            jnp.float32(entry.gain),
            jnp.int32(self.iteration_number),
            jnp.int32(self.max_iterations),
            jnp.float32(self.divergence_limit),
            jnp.float32(entry.max_unnormalized_image_value),
            jnp.int32(entry.max_image_value_x),
            jnp.int32(entry.max_image_value_y),
            jnp.asarray(True),
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fitter,
            use_rms=use_rms,
        )
        it_f, val_f, _found_f, div_f = np.asarray(
            jnp.stack(
                [
                    it_d.astype(jnp.float32),
                    value_d,
                    found_d.astype(jnp.float32),
                    div_d.astype(jnp.float32),
                ]
            )
        ).tolist()
        self.iteration_number = int(it_f)
        if self.iteration_number == sub_start_iteration:
            log.error(
                "Could not continue multi-scale clean, because the sub-minor "
                "loop failed to find components."
            )
            return None
        diverging = bool(div_f)
        if self.divergence_limit != 0.0:
            diverging = diverging or (
                abs(val_f) > initial_peak_value * self.divergence_limit
            )
        entry.n_components_cleaned += (
            self.iteration_number - sub_start_iteration
        )

        # Residual correction + model add-back, as in the sparse path
        # (multiscale_algorithm.cc:432-461).
        if scale_with_peak not in single_convolved_cache:
            single_convolved_cache[scale_with_peak] = jnp.stack(
                [
                    convolved_psfs[min(c, len(convolved_psfs) - 1)][
                        scale_with_peak
                    ]
                    for c in range(meta.n_channels)
                ]
            )
        single_psfs = single_convolved_cache[scale_with_peak]
        dirty_set.data = _correct_residual(
            dirty_set.data, comp, single_psfs, conv_h, conv_w, meta.n_channels
        )
        if self.track_per_scale_masks:
            # Device-resident accumulation; flushed to self.scale_masks once
            # per major iteration (_flush_device_tracking).
            if self._mask_acc is None:
                self._mask_acc = jnp.zeros(
                    (len(self.scale_infos), height, width), bool
                )
            self._mask_acc = _accum_scale_mask(
                self._mask_acc, comp, jnp.int32(scale_with_peak)
            )
        if self.track_components:
            prev = self._comp_acc.get(scale_with_peak)
            self._comp_acc[scale_with_peak] = (
                comp if prev is None else prev + comp
            )
        model_add = self._scale_convolve(comp, entry.scale)
        model_set.data = model_set.data + model_add
        return diverging

    # -- slow (per-component) path --------------------------------------
    def _run_slow_sub_loop(
        self,
        dirty_set,
        model_set,
        meta: CubeMeta,
        convolved_psfs,
        twice_convolved_psfs,
        individual_convolved,
        scale_with_peak: int,
        first_sub_threshold: float,
        initial_peak_value: float,
    ) -> bool:
        """``multiscale_algorithm.cc:463-519``: one component per iteration at
        the fixed scale."""
        entry = self.scale_infos[scale_with_peak]
        psf_indices = jnp.asarray(meta.psf_indices)
        single_psfs = jnp.stack(
            [
                convolved_psfs[min(c, len(convolved_psfs) - 1)][scale_with_peak]
                for c in range(meta.n_channels)
            ]
        )
        diverging = False
        while (
            self.iteration_number < self.max_iterations
            and abs(entry.max_unnormalized_image_value * entry.bias_factor)
            > first_sub_threshold
            and (
                not self.stop_on_negative_components
                or entry.max_unnormalized_image_value >= 0.0
            )
            and not diverging
        ):
            x = entry.max_image_value_x
            y = entry.max_image_value_y
            component_values = individual_convolved[:, y, x]
            if self.spectral_fitter is not None and self.spectral_fitter.is_active:
                vals = component_values.reshape(
                    meta.n_channels, meta.n_polarizations
                )
                component_values = self.spectral_fitter.fit_and_evaluate(
                    vals, x, y
                ).reshape(-1)
            component_values = component_values * entry.gain
            dirty_set.data = subtract_psf_from_cube(
                dirty_set.data,
                single_psfs,
                psf_indices,
                jnp.int32(x),
                jnp.int32(y),
                component_values,
            )
            individual_convolved = subtract_psf_from_cube(
                individual_convolved,
                twice_convolved_psfs,
                psf_indices,
                jnp.int32(x),
                jnp.int32(y),
                component_values,
            )
            host_values = np.asarray(component_values)
            new_model = []
            for img_index in range(meta.n_images):
                if entry.scale == 0.0:
                    new_model.append(
                        model_set.data[img_index]
                        .at[y, x]
                        .add(host_values[img_index])
                    )
                else:
                    new_model.append(
                        add_shape_component(
                            model_set.data[img_index],
                            entry.scale,
                            x,
                            y,
                            float(host_values[img_index]),
                            self.ms_settings.shape,
                        )
                    )
            model_set.data = jnp.stack(new_model)
            entry.n_components_cleaned += 1
            entry.total_flux_cleaned += float(host_values.sum())
            if self.track_per_scale_masks:
                self.scale_masks[scale_with_peak][y, x] = True
            if self.track_components:
                self._component_list.add(x, y, scale_with_peak, host_values)

            integrated = get_linear_integrated(individual_convolved, meta)
            self._find_peak_direct(integrated, scale_with_peak)
            abs_peak = abs(
                entry.max_unnormalized_image_value * entry.bias_factor
            )
            if self.divergence_limit != 0.0:
                diverging = abs_peak > initial_peak_value * self.divergence_limit
            self.iteration_number += 1
        return diverging

    def _find_peak_direct(self, image: jnp.ndarray, scale_index: int) -> None:
        """``multiscale_algorithm.cc:700-748``."""
        entry = self.scale_infos[scale_index]
        h, w = image.shape
        hb = int(round(w * self.clean_border_ratio))
        vb = int(round(h * self.clean_border_ratio))
        weighted = image
        if self.rms_factor_image is not None:
            weighted = image * self.rms_factor_image
        if self.use_per_scale_masks and self.scale_masks:
            mask = jnp.asarray(self.scale_masks[scale_index])
        elif self.clean_mask is not None:
            mask = jnp.asarray(self.clean_mask)
        else:
            mask = None
        pk = find_peak(
            weighted, self.allow_negative_components, hb, vb, mask
        )
        if bool(pk.found):
            entry.max_unnormalized_image_value = float(pk.value)
            entry.max_image_value_x = int(pk.x)
            entry.max_image_value_y = int(pk.y)
            if self.rms_factor_image is not None:
                entry.max_normalized_image_value = float(pk.value) / float(
                    self.rms_factor_image[int(pk.y), int(pk.x)]
                )
            else:
                entry.max_normalized_image_value = float(pk.value)
        else:
            entry.max_unnormalized_image_value = 0.0
            entry.max_normalized_image_value = 0.0

    # -- component optimization (multiscale_algorithm.cc:750-931) --------
    def _run_full_component_fitter(self, dirty_set, model_set, psfs) -> None:
        from ..ops import component_optimization as comp_opt

        if self._component_list is None:
            raise RuntimeError(
                "Component optimization in multiscale requires a tracked "
                "component list (save_source_list)"
            )
        meta = dirty_set.meta
        for image_index in range(dirty_set.n_images):
            self._fit_components_single_image(
                dirty_set, model_set, psfs, image_index, comp_opt
            )
        self.apply_spectral_constraints_to_components(self._component_list)

    def _fit_components_single_image(
        self, dirty_set, model_set, psfs, image_index: int, comp_opt
    ) -> None:
        """Joint gradient-descent refinement of all components of one image
        over all scales at once (``RunFullComponentFitter``,
        ``multiscale_algorithm.cc:837-918``): each scale's components are
        convolved with the scale-convolved PSF and solved together with
        :func:`gradient_descent_with_variable_psf`."""
        meta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        psf = psfs[meta.psf_index(image_index)]
        residual = dirty_set.data[image_index]
        model = model_set.data[image_index]

        supports = []
        conv_psfs = []
        active_scales = []
        for scale_index, entry in enumerate(self.scale_infos):
            positions = self._component_list.get_positions(scale_index)
            if not positions:
                continue
            support = jnp.zeros((height, width), jnp.float32)
            xs = jnp.asarray([p[0] for p in positions])
            ys = jnp.asarray([p[1] for p in positions])
            supports.append(support.at[ys, xs].set(1.0))
            conv_psfs.append(self._scale_convolve(psf, entry.scale))
            active_scales.append(scale_index)
        if not supports:
            return
        max_scale = self.scale_infos[-1].scale
        pad_w = get_convolution_size(
            max_scale, width, self.ms_settings.convolution_padding
        )
        pad_h = get_convolution_size(
            max_scale, height, self.ms_settings.convolution_padding
        )
        deltas = comp_opt.gradient_descent_with_variable_psf(
            supports, residual, conv_psfs, padded_shape=(pad_h, pad_w)
        )
        for delta, scale_index in zip(deltas, active_scales):
            entry = self.scale_infos[scale_index]
            positions = self._component_list.get_positions(scale_index)
            delta_host = np.asarray(delta)
            for i, (px, py) in enumerate(positions):
                _, _, vals = self._component_list.get_component(scale_index, i)
                vals[image_index] += float(delta_host[py, px])
            delta_conv = self._scale_convolve(delta, entry.scale)
            model = model + delta_conv
            residual = residual - comp_opt.padded_convolve(
                delta_conv, psf, padded_shape=(pad_h, pad_w)
            )
        model_set.data = model_set.data.at[image_index].set(model)
        dirty_set.data = dirty_set.data.at[image_index].set(residual)
