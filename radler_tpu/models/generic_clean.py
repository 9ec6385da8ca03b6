"""Generic (Högbom/Clark) CLEAN with joined channels & polarizations.

Behavioral equivalent of ``cpp/algorithms/generic_clean.{h,cc}``, redesigned
for an accelerator:

* The plain Högbom minor loop becomes a single jit-compiled
  ``lax.while_loop`` whose body does: joined integration → masked argmax →
  spectral fit (tiny matmul) → model update → shifted-PSF subtraction over the
  whole cube.  XLA fuses the subtraction, integration and argmax into one
  device-memory pass plus a few small kernels; no host transfer happens
  inside the loop besides the loop predicate.
* The Clark-style optimization delegates to :class:`SubMinorLoop`
  (``radler_tpu/models/subminor.py``; one Pallas program on a GPU), then
  corrects the full residual with one batched FFT convolution.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..image_set import (
    CubeMeta,
    get_linear_integrated,
    get_square_integrated,
)
from ..ops.peak_finder import border_from_ratio, find_peak
from ..ops.psf_subtract import subtract_psf_from_cube
from ..ops.convolution import untrim
from .base import DeconvolutionAlgorithm, DeconvolutionResult
from .subminor import SubMinorLoop, choose_padded_size
from ..settings import OptimizationAlgorithm, SpectralFittingMode


@partial(
    jax.jit,
    static_argnames=(
        "meta",
        "allow_negative",
        "stop_on_negative",
        "fitter",
        "border_h",
        "border_v",
        "use_rms",
        "use_mask",
    ),
)
def _hogbom_loop(
    residual: jnp.ndarray,  # [N, H, W]
    model: jnp.ndarray,  # [N, H, W]
    psfs: jnp.ndarray,  # [C, H, W] padded to image size
    rms_factor: jnp.ndarray,  # [H, W] (ones if unused)
    mask: jnp.ndarray,  # [H, W] bool (all-true if unused)
    peak0_value: jnp.ndarray,
    peak0_x: jnp.ndarray,
    peak0_y: jnp.ndarray,
    peak0_found: jnp.ndarray,
    first_threshold: jnp.ndarray,
    gain: jnp.ndarray,
    initial_abs_peak: jnp.ndarray,
    divergence_limit: jnp.ndarray,
    start_iteration: jnp.ndarray,
    max_iterations: jnp.ndarray,
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    border_h: int,
    border_v: int,
    use_rms: bool,
    use_mask: bool,
    forced_terms: Optional[jnp.ndarray] = None,  # [T-1, H, W] (FORCED mode
    # inside a vmapped facet program, whose local coordinates cannot
    # address the fitter's global term images)
):
    """The non-subminor minor loop (``generic_clean.cc:163-206``)."""
    psf_indices = jnp.asarray(meta.psf_indices)
    use_forced = (
        fitter is not None
        and fitter.mode == SpectralFittingMode.FORCED_TERMS
        and forced_terms is not None
    )

    def refind(res):
        integrated = get_square_integrated(res, meta)
        if use_rms:
            integrated = integrated * rms_factor
        return find_peak(
            integrated,
            allow_negative,
            border_h,
            border_v,
            mask if use_mask else None,
        )

    def cond(state):
        res, mod, it, value, x, y, found, diverging = state
        ok = found & (jnp.abs(value) > first_threshold)
        ok &= it < max_iterations
        if stop_on_negative:
            ok &= value >= 0.0
        return ok & ~diverging

    def body(state):
        res, mod, it, value, x, y, found, _ = state
        peak_values = res[:, y, x]  # [N]
        if fitter is not None:
            vals = peak_values.reshape(meta.n_channels, meta.n_polarizations)
            tv = forced_terms[:, y, x] if use_forced else None
            peak_values = fitter.fit_and_evaluate(
                vals, x, y, forced_terms=tv
            ).reshape(-1)
        peak_values = peak_values * gain
        mod = mod.at[:, y, x].add(peak_values)
        res = subtract_psf_from_cube(res, psfs, psf_indices, x, y, peak_values)
        pk = refind(res)
        diverging = jnp.where(
            divergence_limit != 0.0,
            pk.found & (jnp.abs(pk.value) > initial_abs_peak * divergence_limit),
            False,
        )
        return res, mod, it + 1, pk.value, pk.x, pk.y, pk.found, diverging

    init = (
        residual,
        model,
        start_iteration,
        peak0_value,
        peak0_x,
        peak0_y,
        peak0_found,
        jnp.asarray(False),
    )
    res, mod, it, value, x, y, found, diverging = jax.lax.while_loop(
        cond, body, init
    )
    return res, mod, it, value, found, diverging


@partial(
    jax.jit,
    static_argnames=(
        "meta",
        "allow_negative",
        "stop_on_negative",
        "fitter",
        "use_rms",
    ),
)
def _facet_hogbom_program(
    residual: jnp.ndarray,  # [N, H, W]
    model: jnp.ndarray,  # [N, H, W]
    psfs: jnp.ndarray,  # [C, H, W] at the facet canvas size
    rms_factor: jnp.ndarray,  # [H, W]
    valid_mask: jnp.ndarray,  # [H, W] bool: border window ∧ facet mask
    threshold: jnp.ndarray,
    major_iteration_threshold: jnp.ndarray,
    major_loop_gain: jnp.ndarray,
    gain: jnp.ndarray,
    divergence_limit: jnp.ndarray,
    start_iteration: jnp.ndarray,
    max_iterations: jnp.ndarray,
    forced_terms: jnp.ndarray,  # [T-1, H, W] (FORCED mode) or [1, 1, 1]
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    use_rms: bool,
):
    """One facet's full generic-clean pass, fully on device: initial peak,
    per-facet threshold logic (``generic_clean.cc:100-112``), and the dense
    Högbom while-loop.  vmapped over the facet axis by
    :meth:`GenericClean.execute_batched_facets`; the per-facet border
    window rides ``valid_mask`` so every facet shares one compiled shape."""
    integrated = get_square_integrated(residual, meta)
    if use_rms:
        integrated = integrated * rms_factor
    pk = find_peak(integrated, allow_negative, 0, 0, valid_mask)
    initial_abs = jnp.abs(pk.value)
    m_thr = jnp.maximum(
        major_iteration_threshold, initial_abs * (1.0 - major_loop_gain)
    )
    first_threshold = jnp.maximum(threshold, m_thr)
    res, mod, it, value, found, diverging = _hogbom_loop(
        residual,
        model,
        psfs,
        rms_factor,
        valid_mask,
        pk.value,
        pk.x,
        pk.y,
        pk.found,
        first_threshold,
        gain,
        initial_abs,
        divergence_limit,
        start_iteration,
        max_iterations,
        meta=meta,
        allow_negative=allow_negative,
        stop_on_negative=stop_on_negative,
        fitter=fitter,
        border_h=0,
        border_v=0,
        use_rms=use_rms,
        use_mask=True,
        forced_terms=(
            forced_terms
            if (
                fitter is not None
                and fitter.mode == SpectralFittingMode.FORCED_TERMS
            )
            else None
        ),
    )
    return res, mod, it, value, found, diverging, pk.value, pk.found, m_thr


_ONES_PLANES = {}


def _ones_plane(height: int, width: int) -> jnp.ndarray:
    """Cached all-ones [H, W] plane (avoids an eager op on every call)."""
    key = (height, width)
    if key not in _ONES_PLANES:
        _ONES_PLANES[key] = jnp.ones((height, width), jnp.float32)
    return _ONES_PLANES[key]


@partial(
    jax.jit, static_argnames=("n_tile", "allow_negative", "use_rms")
)
def _mesh_tile_max_count(
    residual: jnp.ndarray,  # [N, H, W]
    lin: jnp.ndarray,  # [N]
    rms: jnp.ndarray,  # [H, W]
    window: jnp.ndarray,  # [H, W] bool
    considered_threshold: jnp.ndarray,
    *,
    n_tile: int,
    allow_negative: bool,
    use_rms: bool,
) -> jnp.ndarray:
    """Largest per-tile candidate count for the sharded subminor's static
    capacity (``subminor_loop.cc:143-184`` selection, counted per row
    shard)."""
    integ = jnp.einsum("n,nhw->hw", lin, residual)
    if use_rms:
        integ = integ * rms
    value = jnp.abs(integ) if allow_negative else integ
    selectable = (value >= considered_threshold) & window
    per_tile = jnp.sum(selectable.reshape(n_tile, -1), axis=1)
    return jnp.max(per_tile)


class GenericClean(DeconvolutionAlgorithm):
    """``cpp/algorithms/generic_clean.{h,cc}``."""

    def __init__(self, use_sub_minor_optimization: bool = True):
        super().__init__()
        self.convolution_padding = 1.1
        self.use_sub_minor_optimization = use_sub_minor_optimization

    # ------------------------------------------------------------------
    def _find_peak(self, integrated: jnp.ndarray):
        """``GenericClean::FindPeak`` (``generic_clean.cc:255-277``)."""
        img = integrated
        if self.rms_factor_image is not None:
            img = integrated * self.rms_factor_image
        h, w = img.shape
        hb, vb = border_from_ratio(w, h, self.clean_border_ratio)
        mask = (
            jnp.asarray(self.clean_mask) if self.clean_mask is not None else None
        )
        return find_peak(img, self.allow_negative_components, hb, vb, mask)

    # ------------------------------------------------------------------
    def execute_major_iteration(
        self, dirty_set, model_set, psfs: jnp.ndarray
    ) -> DeconvolutionResult:
        meta: CubeMeta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        iteration_counter_at_start = self.iteration_number
        if self.stop_on_negative_components:
            self.allow_negative_components = True

        padded_h, padded_w = choose_padded_size(
            width, height, self.convolution_padding
        )

        integrated = get_linear_integrated(dirty_set.data, meta)
        pk = self._find_peak(integrated)
        # One batched host transfer for the peak scalars (x/y stay on device
        # for the loop; each separate pull is a device-to-host round trip).
        pk_value, pk_found = np.asarray(
            jnp.stack([pk.value, pk.found.astype(jnp.float32)])
        ).tolist()
        found = bool(pk_found)
        result = DeconvolutionResult()
        result.starting_peak_value = pk_value if found else None
        result.final_peak_value = pk_value if found else 0.0
        if not found:
            return result
        if self.iteration_number >= self.max_iterations:
            # Enables the facet layer's peak-only phase-1 pass
            # (generic_clean.cc:83-88).
            return result

        if self.component_optimization_algorithm != OptimizationAlgorithm.CLEAN:
            from ..ops import component_optimization as comp_opt

            comp_opt.run_component_optimization(
                dirty_set,
                model_set,
                psfs,
                self.component_optimization_algorithm,
            )
            self._fit_model_spectra(model_set)
            return result

        initial_max_value = abs(pk_value)
        first_threshold = self.threshold
        major_iter_threshold = max(
            self.major_iteration_threshold,
            initial_max_value * (1.0 - self.major_loop_gain),
        )
        if major_iter_threshold > first_threshold:
            first_threshold = major_iter_threshold

        diverging = False
        max_value: Optional[float] = pk_value
        # Routing: with the sub-minor ("Clark") optimization on, the sparse
        # candidate-set loop always runs (the one-program kernel or the XLA
        # loop, chosen by SubMinorLoop.fused_qualifies); without it, the
        # dense Högbom while loop.  The candidate selection is only an
        # optimization (generic_clean.cc:115-162) — both paths subtract the
        # same shifted PSF and stop at the same threshold.
        mesh_active = (
            self.device_mesh is not None and self.device_mesh.size > 1
        )
        if (
            mesh_active
            and self.use_sub_minor_optimization
            and self._mesh_subminor_eligible(meta, height, width)
        ):
            # Sharded Clark subminor: each tile shard cleans its own
            # candidate set to the shared threshold in lockstep (the
            # reference's per-sub-image fast path,
            # parallel_deconvolution.cc:606-617 + subminor_loop.cc:62-115).
            return self._run_mesh_subminor(
                dirty_set,
                model_set,
                psfs,
                pk,
                first_threshold,
                initial_max_value,
                iteration_counter_at_start,
                major_iter_threshold,
                result,
                padded_h,
                padded_w,
            )
        if self.use_sub_minor_optimization and not mesh_active:
            sub = SubMinorLoop(width, height, padded_w, padded_h)
            sub.set_iteration_info(self.iteration_number, self.max_iterations)
            sub.set_threshold(first_threshold, first_threshold * 0.99)
            sub.set_gain(self.minor_loop_gain)
            sub.allow_negative_components = self.allow_negative_components
            sub.stop_on_negative_component = self.stop_on_negative_components
            sub.divergence_limit = self.divergence_limit
            if self.rms_factor_image is not None:
                sub.rms_factor_image = self.rms_factor_image
            if self.clean_mask is not None:
                sub.mask = self.clean_mask
            hor_border = int(round(width * self.clean_border_ratio))
            vert_border = int(round(height * self.clean_border_ratio))
            sub.set_clean_borders(hor_border, vert_border)
            diverging, max_value = sub.run(
                dirty_set.data, meta, psfs, self.spectral_fitter
            )
            self.iteration_number = sub.current_iteration

            if max_value is not None:
                new_residual, full_model = sub.correct_residual_dirty(
                    dirty_set.data, psfs
                )
                dirty_set.data = new_residual
                model_set.data = model_set.data + full_model
            # When the subminor loop selected no pixels, the reference's
            # fallback FindPeak runs over a zeroed scratch buffer and finds
            # nothing (generic_clean.cc:156-162): max_value stays unset.
        else:
            use_rms = self.rms_factor_image is not None
            use_mask = self.clean_mask is not None
            hb, vb = border_from_ratio(width, height, self.clean_border_ratio)
            psfs_padded = untrim(psfs, height, width) if psfs.shape[-2:] != (
                height,
                width,
            ) else psfs
            fit = (
                self.spectral_fitter
                if (
                    self.spectral_fitter is not None
                    and self.spectral_fitter.is_active
                )
                else None
            )
            if mesh_active:
                # Shard the cube and let XLA partition the jitted dense
                # minor loop (the joined integration becomes a channel
                # psum, the argmax a max-reduce over tiles, the peak update
                # a broadcast — the reference's thread-pool exchanges,
                # SURVEY.md §2.2).
                from ..parallel.mesh import shard_clean_inputs

                (
                    res_in,
                    mod_in,
                    psfs_padded,
                    rms_in,
                    mask_in,
                ) = shard_clean_inputs(
                    self.device_mesh,
                    dirty_set.data,
                    model_set.data,
                    psfs_padded,
                    self.rms_factor_image
                    if use_rms
                    else jnp.ones((height, width), jnp.float32),
                    jnp.asarray(self.clean_mask)
                    if use_mask
                    else jnp.ones((height, width), bool),
                )
            else:
                res_in = dirty_set.data
                mod_in = model_set.data
                rms_in = (
                    self.rms_factor_image
                    if use_rms
                    else jnp.ones((height, width), jnp.float32)
                )
                mask_in = (
                    jnp.asarray(self.clean_mask)
                    if use_mask
                    else jnp.ones((height, width), bool)
                )
            res, mod, it, value, found_f, diverging_f = _hogbom_loop(
                res_in,
                mod_in,
                psfs_padded,
                rms_in,
                mask_in,
                pk.value,
                pk.x,
                pk.y,
                pk.found,
                jnp.float32(first_threshold),
                jnp.float32(self.minor_loop_gain),
                jnp.float32(initial_max_value),
                jnp.float32(self.divergence_limit),
                jnp.int32(self.iteration_number),
                jnp.int32(self.max_iterations),
                meta=meta,
                allow_negative=self.allow_negative_components,
                stop_on_negative=self.stop_on_negative_components,
                fitter=fit,
                border_h=hb,
                border_v=vb,
                use_rms=use_rms,
                use_mask=use_mask,
            )
            dirty_set.data = res
            model_set.data = mod
            it_f, val_f, fnd_f, div_f = np.asarray(
                jnp.stack(
                    [
                        it.astype(jnp.float32),
                        value,
                        found_f.astype(jnp.float32),
                        diverging_f.astype(jnp.float32),
                    ]
                )
            ).tolist()
            self.iteration_number = int(it_f)
            diverging = bool(div_f)
            max_value = val_f if bool(fnd_f) else None

        return self._finish_result(
            result,
            diverging,
            max_value,
            iteration_counter_at_start,
            major_iter_threshold,
        )

    # -- batched facet execution ----------------------------------------
    def batched_facets_eligible(
        self,
        meta: CubeMeta,
        box_w: int,
        box_h: int,
        n_facets: int,
        n_unique_psfs: int = 1,
    ) -> bool:
        """Whether all facets can run as one vmapped dense Högbom program
        (the reference runs all sub-images concurrently regardless of
        algorithm, ``parallel_deconvolution.cc:606-617``).  The dense
        while-loop has the same semantics as the Clark subminor path —
        both subtract the shifted PSF and stop at the same thresholds
        (``generic_clean.cc:115-206``) — so no per-facet host state is
        needed."""
        import os

        if os.environ.get("RADLER_TPU_NO_BATCHED_FACETS"):
            return False
        if self.component_optimization_algorithm != OptimizationAlgorithm.CLEAN:
            # Component optimization replaces the clean loop with a
            # per-facet linear solve / GD over a DATA-DEPENDENT component
            # count (component_optimization.cc:181-400) — the counts differ
            # per facet, so there is no common compiled shape to batch;
            # the serial facet loop runs these (as the reference's thread
            # pool would, one solve per sub-image).
            return False
        from ..utils.device_memory import fits_device_memory

        N, C = meta.n_images, meta.n_channels
        est = n_facets * (6 * N + C * max(n_unique_psfs, 1)) * (
            box_h * box_w * 4
        )
        return fits_device_memory(est, 0.25)

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
        facet_scale_masks=None,  # unused (multiscale-only state)
        facet_forced_terms=None,  # [F, T-1, Hb, Wb] (FORCED-mode fitter)
    ):
        """All facets' Högbom minor loops as ONE vmapped device program.

        Same contract as ``MultiScaleAlgorithm.execute_batched_facets``;
        the per-facet initial peak, major-gain threshold, and while-loop run
        in lockstep on device (one dispatch per phase instead of one per
        facet).  Returns ``(residual, model, results, iterations,
        mask_dummy, comp_dummy)``.
        """
        from ..ops.peak_finder import window_mask

        F, N, Hb, Wb = facet_residual.shape

        # Per-facet search masks: border window of the TRUE facet box ANDed
        # with the boundary/user mask (padding stays unsearchable).
        valid = np.zeros((F, Hb, Wb), dtype=bool)
        for f, (sw, sh) in enumerate(facet_boxes):
            hb = int(round(sw * self.clean_border_ratio))
            vb = int(round(sh * self.clean_border_ratio))
            valid[f, :sh, :sw] = window_mask(sh, sw, hb, vb)
            valid[f] &= facet_masks[f]

        use_rms = facet_rms is not None
        rms = (
            jnp.asarray(facet_rms)
            if use_rms
            else jnp.ones((F, Hb, Wb), jnp.float32)
        )
        fit = (
            self.spectral_fitter
            if (
                self.spectral_fitter is not None
                and self.spectral_fitter.is_active
            )
            else None
        )
        per_facet_psfs = psfs.ndim == 4
        if per_facet_psfs:
            slot = jnp.asarray(np.asarray(facet_psf_slot, np.int32))
            psfs_in = psfs[slot]  # [F, C, Hb, Wb]
            psf_axis = 0
        else:
            psfs_in = psfs
            psf_axis = None

        starts = jnp.asarray(start_iterations, jnp.int32)
        if find_peak_only:
            max_iters = starts  # zero remaining iterations -> peak only
        else:
            max_iters = jnp.full((F,), self.max_iterations, jnp.int32)

        from functools import partial as _partial

        program = _partial(
            _facet_hogbom_program,
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fit,
            use_rms=use_rms,
        )
        forced_axis = 0 if facet_forced_terms is not None else None
        forced_in = (
            jnp.asarray(facet_forced_terms)
            if facet_forced_terms is not None
            else jnp.zeros((1, 1, 1), jnp.float32)
        )
        in_axes = (
            0, 0, psf_axis, 0, 0, None, None, None, None, None, 0, 0,
            forced_axis,
        )
        inputs = [
            facet_residual,
            facet_model,
            psfs_in,
            rms,
            jnp.asarray(valid),
            jnp.float32(self.threshold),
            jnp.float32(major_iteration_threshold),
            jnp.float32(self.major_loop_gain),
            jnp.float32(self.minor_loop_gain),
            jnp.float32(self.divergence_limit),
            starts,
            max_iters,
            forced_in,
        ]
        if self.device_mesh is not None and self.device_mesh.size > 1:
            # Facet x mesh composition (parallel_deconvolution.cc:606-617
            # farmed to ICI instead of threads).
            from ..parallel.mesh import shard_facet_inputs

            inputs = shard_facet_inputs(self.device_mesh, inputs, in_axes)
        out = jax.vmap(program, in_axes=in_axes)(*inputs)
        (res, mod, it, value, found, diverging, pk0_value, pk0_found,
         m_thr) = out
        (it_h, value_h, found_h, div_h, pk0v_h, pk0f_h, m_thr_h) = (
            jax.device_get(
                (it, value, found, diverging, pk0_value, pk0_found, m_thr)
            )
        )
        results = []
        for f in range(F):
            result = DeconvolutionResult()
            if not bool(pk0f_h[f]):
                result.final_peak_value = 0.0
                result.another_iteration_required = False
                results.append(result)
                continue
            result.starting_peak_value = float(pk0v_h[f])
            result.final_peak_value = float(pk0v_h[f])
            if find_peak_only:
                results.append(result)
                continue
            max_value = float(value_h[f]) if bool(found_h[f]) else None
            saved_iter = self.iteration_number
            self.iteration_number = int(it_h[f])
            result = self._finish_result(
                result,
                bool(div_h[f]),
                max_value,
                int(start_iterations[f]),
                float(m_thr_h[f]),
            )
            self.iteration_number = saved_iter
            results.append(result)
        mask_dummy = jnp.zeros((F, 1, 1, 1), bool)
        comp_dummy = jnp.zeros((F, 1, 1, 1, 1), jnp.float32)
        return res, mod, results, it_h, mask_dummy, comp_dummy

    # ------------------------------------------------------------------
    def _mesh_subminor_eligible(self, meta, height: int, width: int) -> bool:
        """Shape gates for the sharded Clark subminor: plane count divides
        the "chan" axis without splitting a polarization group, rows divide
        the "tile" axis.  (The XLA candidate loop has no lane-alignment
        constraint.)  RADLER_TPU_NO_MESH_SUBMINOR=1 opts out (falls back to
        the XLA-partitioned dense loop)."""
        import os

        if os.environ.get("RADLER_TPU_NO_MESH_SUBMINOR"):
            return False
        mesh = self.device_mesh
        n_chan = mesh.shape["chan"]
        n_tile = mesh.shape["tile"]
        N = meta.n_images
        if N % n_chan != 0 or (N // n_chan) % meta.n_polarizations != 0:
            return False
        if height % n_tile != 0:
            return False
        return True

    def _run_mesh_subminor(
        self,
        dirty_set,
        model_set,
        psfs: jnp.ndarray,
        pk,
        first_threshold: float,
        initial_max_value: float,
        iteration_counter_at_start: int,
        major_iter_threshold: float,
        result: DeconvolutionResult,
        padded_h: int,
        padded_w: int,
    ) -> DeconvolutionResult:
        """Sharded twin of the SubMinorLoop block in :meth:`_execute` (see
        ``parallel/mesh.py::mesh_subminor_clean``): per-tile candidate sets
        cleaned in lockstep to the shared threshold, then ONE sharded FFT
        residual correction (``subminor_loop.cc:195-218``)."""
        from ..image_set import linear_integration_coefficients
        from ..ops.peak_finder import window_mask
        from ..parallel.mesh import mesh_subminor_clean
        from .subminor import _capacity_bucket, _correct_residual

        meta = dirty_set.meta
        height, width = dirty_set.height, dirty_set.width
        mesh = self.device_mesh
        n_tile = mesh.shape["tile"]
        h_loc = height // n_tile
        hb, vb = border_from_ratio(width, height, self.clean_border_ratio)
        window_np = window_mask(height, width, hb, vb)
        if self.clean_mask is not None:
            window_np = window_np & np.asarray(self.clean_mask, bool)
        use_rms = self.rms_factor_image is not None
        rms = (
            self.rms_factor_image
            if use_rms
            else _ones_plane(height, width)
        )
        considered_threshold = first_threshold * 0.99
        # Per-tile candidate counts -> static capacity bucket (every tile
        # allocates the same K; the bucket bounds jit-cache growth).  One
        # jitted dispatch + one scalar fetch.
        lin = jnp.asarray(
            np.asarray(linear_integration_coefficients(meta), np.float32)
        )
        max_count = int(
            _mesh_tile_max_count(
                dirty_set.data,
                lin,
                rms,
                jnp.asarray(window_np),
                jnp.float32(considered_threshold),
                n_tile=n_tile,
                allow_negative=self.allow_negative_components,
                use_rms=use_rms,
            )
        )
        if max_count == 0:
            # No pixels selected: the reference's fallback FindPeak scans a
            # zeroed scratch and finds nothing (generic_clean.cc:156-162).
            return self._finish_result(
                result,
                False,
                None,
                iteration_counter_at_start,
                major_iter_threshold,
            )
        cap = _capacity_bucket(max_count, min(h_loc * width, 1 << 20))
        per_image_psfs = psfs[jnp.asarray(meta.psf_indices)]
        if per_image_psfs.shape[-2:] != (height, width):
            per_image_psfs = untrim(per_image_psfs, height, width)
        fit = (
            self.spectral_fitter
            if (
                self.spectral_fitter is not None
                and self.spectral_fitter.is_active
            )
            else None
        )
        delta, it, final_max, diverging_d, any_sel = mesh_subminor_clean(
            mesh,
            dirty_set.data,
            per_image_psfs,
            rms,
            jnp.asarray(window_np),
            considered_threshold,
            first_threshold,
            self.minor_loop_gain,
            self.iteration_number,
            self.max_iterations,
            self.divergence_limit,
            cap,
            meta=meta,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_components,
            fitter=fit,
            use_rms=use_rms,
        )
        it_f, max_f, div_f, sel_f = np.asarray(
            jnp.stack(
                [
                    it.astype(jnp.float32),
                    final_max,
                    diverging_d.astype(jnp.float32),
                    any_sel.astype(jnp.float32),
                ]
            )
        ).tolist()
        self.iteration_number = int(it_f)
        max_value = float(max_f) if bool(sel_f) else None
        if bool(sel_f):
            # CorrectResidualDirty: one sharded FFT convolution of the
            # sparse model with the single-convolved PSFs.
            dirty_set.data = _correct_residual(
                dirty_set.data,
                delta,
                psfs,
                padded_h,
                padded_w,
                meta.n_channels,
            )
            model_set.data = model_set.data + delta
        return self._finish_result(
            result,
            bool(div_f),
            max_value,
            iteration_counter_at_start,
            major_iter_threshold,
        )

    def _finish_result(
        self,
        result: DeconvolutionResult,
        diverging: bool,
        max_value,
        iteration_counter_at_start: int,
        major_iter_threshold: float,
    ) -> DeconvolutionResult:
        """Stop-reason reporting (generic_clean.cc:208-251)."""
        if diverging:
            if max_value is not None:
                result.final_peak_value = max_value
            result.another_iteration_required = False
            result.is_diverging = True
        elif max_value is not None:
            final_threshold_reached = (
                abs(max_value) <= self.threshold or max_value == 0.0
            )
            negative_reached = (
                max_value < 0.0 and self.stop_on_negative_components
            )
            mgain_reached = abs(max_value) <= major_iter_threshold
            did_work = (
                self.iteration_number - iteration_counter_at_start
            ) != 0
            result.another_iteration_required = (
                mgain_reached
                and did_work
                and not negative_reached
                and not final_threshold_reached
            )
            result.final_peak_value = max_value
        else:
            result.another_iteration_required = False
        return result

    def _fit_model_spectra(self, model_set) -> None:
        """``GenericClean::FitSpectra`` (``generic_clean.cc:278-297``):
        constrain every model pixel's spectrum, batched over the image."""
        if self.spectral_fitter is None or not self.spectral_fitter.is_active:
            return
        meta = model_set.meta
        C, P = meta.n_channels, meta.n_polarizations
        H, W = model_set.height, model_set.width
        cube = model_set.data.reshape(C, P, H, W)
        vals = cube.reshape(C, P * H * W)
        fitted = self.spectral_fitter.fit_and_evaluate(vals)
        model_set.data = fitted.reshape(C * P, H, W)
