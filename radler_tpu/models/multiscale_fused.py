"""Fully on-device multiscale minor loop with a spectral-domain residual.

The host-orchestrated multiscale path (``multiscale.py``) mirrors the
reference's control flow (``cpp/algorithms/multiscale_algorithm.cc:183-543``):
per outer iteration it dispatches a scale-bank convolution, a sparse subminor
loop, an FFT residual correction, and a maxima refresh — each a separate
device dispatch with host scalar round-trips between them, and each
round trip leaves the device idle.

This module compiles the ENTIRE minor loop — outer scale-selection loop plus
the dense subminor loop at a fixed scale — into one ``lax.while_loop`` so a
major iteration is a single device program with one host transfer at the
end.  Beyond the fusion itself, the loop is restructured to spend FFTs
rather than device-memory passes:

* **The residual cube lives in the Fourier domain** (``res_f``, one unified
  7-smooth padded size).  The reference re-transforms the residual twice per
  outer iteration (once for the scale-bank maxima refresh, once per-plane for
  the subminor's scale-convolved cube) and inverse-transforms the correction
  (``CorrectResidualDirty``, ``cpp/algorithms/subminor_loop.cc:195-218``).
  With a spectral residual, the maxima refresh is S inverse transforms of
  ``integ_f x kernel_f`` (no forwards: the integrated spectrum is an einsum
  over ``res_f``), the subminor cube is N inverse transforms, and the
  residual correction is a pure spectral multiply-subtract — the correction's
  inverse transforms disappear entirely.  The image-domain residual inside
  the image region is bit-identical to the trim-and-rezero dance of the
  reference's padded convolution (the correction operator is linear in the
  component image and independent of the residual); only the padding margin
  accumulates the wrapped tails the reference re-zeroes, which is outside
  the searchable windows.
* **Correction spectra are factorized.**  The reference prepares a
  (scale x channel) bank of single-convolved PSFs
  (``ConvolvePsfs``, ``multiscale_algorithm.cc:29-88``); as spectra that is
  S·C padded planes (~5.7 GB at 2048²×8ch).  But the spectrum of
  ``kernel_s ⊛ psf_c`` is ``kernel_f[s] * psf_f[c]``, so only S + C planes
  are stored and the product fuses into the spectral subtraction.
* **The component image is tracked in spectral-fit coefficient space.**
  With polynomial fitting the per-iteration fitted peak values live in the
  T-dimensional column space of the design matrix
  (``fitted = design @ (fit_matrix @ values)``, see
  ``ops/spectral_fitting.py``), so the subminor accumulates T·P coefficient
  planes instead of C·P channel planes and the correction's forward
  transforms shrink from N to T·P (2 instead of 8 for a 2-term fit of 8
  channels).
* All per-scale data (kernel spectra, twice-convolved PSF stacks, search
  windows) is precomputed into ``[S, ...]`` stacks indexed with
  ``lax.dynamic_index_in_dim`` — every outer iteration has identical shapes,
  so the program compiles exactly once.
* Two padded-size buckets: the unified ``res_f`` size serves the small
  scales (the reference's per-scale sizing,
  ``cpp/utils/fft_size_calculations.h:39-50``, keeps small-scale FFTs
  cheap); rarely-selected large scales take a ``lax.cond`` branch that
  corrects at the large padded size in image space and re-syncs ``res_f``.

The dense subminor is the Clark-style candidate loop as a *dense masked
clean* over the scale-convolved cube (the candidate-set restriction is an
optimization, not a semantic requirement: both subtract the twice-convolved
PSF and stop at the same threshold — see ``subminor_loop.h:17-50``), with
*linear* integration (``SubMinorModel::GetMaxComponent``,
``subminor_loop.cc:13-36``).

The fused path carries per-scale auto-mask and component-list accumulators
on device (flushed once per major iteration); the host-orchestrated path
remains for configurations whose working set exceeds device memory.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..image_set import CubeMeta, linear_integration_coefficients
from ..ops.convolution import forward_fft2_padded, inverse_fft2_real_trimmed
from ..settings import SpectralFittingMode

_FLT_MIN = np.float32(1.1754943508222875e-38)

# The loop's f32 contractions (channel integration, coefficient-space
# expansion, spectral fit) run at full precision: at DEFAULT, XLA may run
# them as TF32 on a GPU, and a 4-card H100 mesh run then drifted from the
# one-card run by 1e-3 of the peak within 50 iterations.
_EXACT = jax.lax.Precision.HIGHEST


class FusedMultiscaleResult(NamedTuple):
    residual: jnp.ndarray  # [N, H, W]
    model: jnp.ndarray  # [N, H, W]
    iteration_number: jnp.ndarray  # int32
    final_biased_peak: jnp.ndarray  # float32, signed: value * bias at best scale
    final_scale: jnp.ndarray  # int32
    any_peak_found: jnp.ndarray  # bool: a peak existed at loop exit
    diverging: jnp.ndarray  # bool
    no_components: jnp.ndarray  # bool: a subminor pass cleaned nothing
    is_final_threshold: jnp.ndarray  # bool: stopped at the absolute threshold
    components_per_scale: jnp.ndarray  # [S] int32
    flux_per_scale: jnp.ndarray  # [S] float32
    mask_acc: jnp.ndarray  # [S, H, W] bool (track_masks) or [1, 1, 1] dummy
    comp_acc: jnp.ndarray  # [S, N, H, W] f32 (track_components) or dummy


def _coefficient_basis(fitter, meta: CubeMeta) -> Optional[np.ndarray]:
    """Expansion matrix E [N, T*P] with ``component_plane = E @ coef_planes``
    when the fitter is a linear projection (polynomial mode), else None.

    For polynomial fitting ``fitted = design @ (fit_matrix @ values)`` per
    polarization, so accumulated fitted values live in the column space of
    ``design`` [C, T]; plane ``n = c*P + p`` maps to coefficient plane
    ``k = t*P + p`` with weight ``design[c, t]``.
    """
    if (
        fitter is None
        or not fitter.is_active
        or fitter.mode != SpectralFittingMode.POLYNOMIAL
        or fitter._design is None
    ):
        return None
    C, P = meta.n_channels, meta.n_polarizations
    design = np.asarray(fitter._design, np.float32)  # [C, T]
    T = design.shape[1]
    E = np.zeros((C * P, T * P), np.float32)
    for c in range(C):
        for p in range(P):
            for t in range(T):
                E[c * P + p, t * P + p] = design[c, t]
    return E


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
def dense_subminor_loop(
    conv_res: jnp.ndarray,  # [N, H, W] scale-convolved residual cube
    psf_pad: jnp.ndarray,  # [N, 2H, 2W] padded twice-convolved PSFs
    weight: jnp.ndarray,  # [H, W] window x mask x rms weight
    rms_factor: jnp.ndarray,  # [H, W] (ones when unused)
    threshold: jnp.ndarray,
    gain: jnp.ndarray,
    start_iteration: jnp.ndarray,
    max_iterations: jnp.ndarray,
    divergence_limit: jnp.ndarray,
    value0: jnp.ndarray,
    x0: jnp.ndarray,
    y0: jnp.ndarray,
    found0: jnp.ndarray,
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    use_rms: bool,
):
    """Standalone dense Clark subminor pass at a fixed scale.

    Host-orchestrated twin of the inner loop of
    :func:`fused_multiscale_minor_loop` (same semantics as the sparse
    :class:`~radler_tpu.models.subminor.SubMinorLoop`, see the module
    docstring): used by the multiscale host path when the fused program's
    working set exceeds device memory.  Returns
    ``(conv_res, component_image, iteration, value, found, diverging)``.
    """
    N, H, W = conv_res.shape
    lin = jnp.asarray(linear_integration_coefficients(meta))
    start_abs = jnp.abs(value0)

    def cond(st):
        _res, _comp, it, value, x, y, found, div = st
        ok = found & (jnp.abs(value) > threshold) & (it < max_iterations)
        if stop_on_negative:
            ok &= value >= 0.0
        return ok & ~div

    def body(st):
        res, comp, it, value, x, y, found, _ = st
        peak_values = res[:, y, x]
        if fitter is not None:
            v = peak_values.reshape(meta.n_channels, meta.n_polarizations)
            peak_values = fitter.fit_and_evaluate(v, x, y).reshape(-1)
        peak_values = peak_values * gain
        comp = comp.at[:, y, x].add(peak_values)
        shifted = jax.lax.dynamic_slice(psf_pad, (0, H - y, W - x), (N, H, W))
        res = res - shifted * peak_values[:, None, None]
        integ = jnp.einsum("n,nhw->hw", lin, res, precision=_EXACT)
        wgt = integ * weight
        cmp = jnp.abs(wgt) if allow_negative else wgt
        flat_idx = jnp.argmax(cmp.reshape(-1))
        peak_cmp = cmp.reshape(-1)[flat_idx]
        nfound = peak_cmp > _FLT_MIN
        nx = (flat_idx % W).astype(jnp.int32)
        ny = (flat_idx // W).astype(jnp.int32)
        nvalue = jnp.einsum("n,n->", lin, res[:, ny, nx], precision=_EXACT)
        if use_rms:
            nvalue = nvalue * rms_factor[ny, nx]
        div = jnp.where(
            divergence_limit != 0.0,
            nfound & (jnp.abs(nvalue) > start_abs * divergence_limit),
            False,
        )
        return res, comp, it + 1, nvalue, nx, ny, nfound, div

    init = (
        conv_res,
        jnp.zeros_like(conv_res),
        start_iteration,
        value0,
        x0,
        y0,
        found0,
        jnp.asarray(False),
    )
    res, comp, it, value, x, y, found, div = jax.lax.while_loop(
        cond, body, init
    )
    return res, comp, it, value, found, div


def pad_psf_planes(psfs: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad [N, H, W] PSFs to [N, 2H, 2W] with the PSF center at (H, W):
    the slice ``[H - y : 2H - y, W - x : 2W - x]`` is the PSF shifted to
    peak (x, y), with out-of-image taps dropped."""
    H, W = psfs.shape[-2:]
    return jnp.pad(
        psfs, ((0, 0), (H - H // 2, H // 2), (W - W // 2, W // 2))
    )


@partial(
    jax.jit,
    static_argnames=(
        "meta",
        "allow_negative",
        "stop_on_negative",
        "fitter",
        "use_rms",
        "split",
        "padded_small",
        "padded_large",
        "track_masks",
        "track_components",
    ),
)
def fused_multiscale_minor_loop(
    residual: jnp.ndarray,  # [N, H, W]
    model: jnp.ndarray,  # [N, H, W]
    kernel_f: jnp.ndarray,  # [S, PHa, ...] scale-kernel spectra @ padded_small
    twice_psfs: jnp.ndarray,  # [S, C, H, W] twice-convolved per-channel PSFs
    psf_f: jnp.ndarray,  # [C, PHa, ...] single-PSF spectra @ padded_small
    kernel_f_large: jnp.ndarray,  # [S-split, PHb, ...] (1-row dummy if unused)
    psf_f_large: jnp.ndarray,  # [C, PHb, ...] (1-row dummy if unused)
    valid_stack: jnp.ndarray,  # [S, H, W] bool searchable windows
    rms_factor: jnp.ndarray,  # [H, W] (ones when unused)
    bias: jnp.ndarray,  # [S]
    gain_arr: jnp.ndarray,  # [S]
    threshold: jnp.ndarray,  # final (absolute) threshold
    major_iteration_threshold: jnp.ndarray,
    major_loop_gain: jnp.ndarray,
    sub_loop_gain: jnp.ndarray,
    minor_loop_gain: jnp.ndarray,
    divergence_limit: jnp.ndarray,
    start_iteration: jnp.ndarray,  # int32
    max_iterations: jnp.ndarray,  # int32
    countdown0: jnp.ndarray,  # int32
    forced_terms: jnp.ndarray = None,  # [T-1, H, W] (FORCED fit) or dummy
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    use_rms: bool,
    split: int,
    padded_small: tuple,
    padded_large: tuple,
    track_masks: bool = False,
    track_components: bool = False,
) -> FusedMultiscaleResult:
    N, H, W = residual.shape
    S = kernel_f.shape[0]
    Ph, Pw = padded_small
    PhL, PwL = padded_large
    lin = jnp.asarray(linear_integration_coefficients(meta))
    psf_idx = jnp.asarray(meta.psf_indices)
    neg_inf = jnp.float32(-jnp.inf)

    # Coefficient-space component tracking (see module docstring).
    E_np = _coefficient_basis(fitter, meta)
    if E_np is not None:
        E = jnp.asarray(E_np)  # [N, Tn]
        Tn = E_np.shape[1]
        fit_m = jnp.asarray(fitter._fit_matrix, jnp.float32)  # [T, C]
        n_terms = fit_m.shape[0]

        def expand_planes(planes):  # [Tn, ...] -> [N, ...]
            return jnp.einsum(
                "nk,k...->n...", E.astype(planes.dtype), planes,
                precision=_EXACT,
            )

    else:
        E = None
        Tn = N

        def expand_planes(planes):
            return planes

    # The residual cube in the Fourier domain at the unified padded size.
    res_f = forward_fft2_padded(residual, (Ph, Pw))  # [N, Ph, Pwf]

    # ---- maxima over all scales (FindActiveScaleConvolvedMaxima) --------
    # The scale-bank convolution runs on the padded canvas: no forward
    # transform (the integrated spectrum is a linear combination of res_f),
    # S inverse transforms, trim.  The padding margin carries the wrapped
    # correction tails the reference re-zeroes; the searchable windows
    # exclude the affected border ring (multiscale_algorithm.cc:597-603).
    def find_maxima(res_f):
        integ_f = jnp.einsum("n,nhw->hw", lin, res_f, precision=_EXACT)
        conv = inverse_fft2_real_trimmed(
            integ_f[None] * kernel_f, (Ph, Pw), (H, W)
        )  # [S, H, W]
        weighted = conv * rms_factor if use_rms else conv
        cmp = jnp.abs(weighted) if allow_negative else weighted
        masked = jnp.where(valid_stack, cmp, neg_inf).reshape(S, H * W)
        idx = jnp.argmax(masked, axis=1)
        peak_cmp = jnp.take_along_axis(masked, idx[:, None], axis=1)[:, 0]
        found = peak_cmp > _FLT_MIN
        vals = jnp.take_along_axis(
            weighted.reshape(S, H * W), idx[:, None], axis=1
        )[:, 0]
        vals = jnp.where(found, vals, 0.0)
        xs = (idx % W).astype(jnp.int32)
        ys = (idx // W).astype(jnp.int32)
        return vals, xs, ys, found

    # ---- dense subminor loop at a fixed scale ----------------------------
    def integrate_at(res, yy, xx):
        return jnp.einsum("n,n->", lin, res[:, yy, xx], precision=_EXACT)

    def dense_subminor(
        conv_res, psf_pad, weight, thr, gain, it0, value0, x0, y0, found0
    ):
        start_abs = jnp.abs(value0)

        def cond(st):
            _res, _comp, it, value, x, y, found, div = st
            ok = found & (jnp.abs(value) > thr) & (it < max_iterations)
            if stop_on_negative:
                ok &= value >= 0.0
            return ok & ~div

        def body(st):
            res, comp, it, value, x, y, found, _ = st
            vals = res[:, y, x]
            if E is not None:
                v = vals.reshape(meta.n_channels, meta.n_polarizations)
                coef = jnp.matmul(fit_m, v, precision=_EXACT)  # [T, P]
                peak_values = (
                    jnp.einsum("nk,k->n", E, coef.reshape(-1), precision=_EXACT)
                    * gain
                )
                comp = comp.at[:, y, x].add(coef.reshape(-1) * gain)
            else:
                peak_values = vals
                if fitter is not None:
                    v = vals.reshape(meta.n_channels, meta.n_polarizations)
                    tv = (
                        forced_terms[:, y, x]
                        if (
                            fitter.mode == SpectralFittingMode.FORCED_TERMS
                            and forced_terms is not None
                        )
                        else None
                    )
                    peak_values = fitter.fit_and_evaluate(
                        v, x, y, forced_terms=tv
                    ).reshape(-1)
                peak_values = peak_values * gain
                comp = comp.at[:, y, x].add(peak_values)
            shifted = jax.lax.dynamic_slice(
                psf_pad, (0, H - y, W - x), (N, H, W)
            )
            res = res - shifted * peak_values[:, None, None]
            integ = jnp.einsum("n,nhw->hw", lin, res, precision=_EXACT)
            wgt = integ * weight
            cmp = jnp.abs(wgt) if allow_negative else wgt
            flat_idx = jnp.argmax(cmp.reshape(-1))
            peak_cmp = cmp.reshape(-1)[flat_idx]
            nfound = peak_cmp > _FLT_MIN
            nx = (flat_idx % W).astype(jnp.int32)
            ny = (flat_idx // W).astype(jnp.int32)
            nvalue = integrate_at(res, ny, nx)
            if use_rms:
                nvalue = nvalue * rms_factor[ny, nx]
            div = jnp.where(
                divergence_limit != 0.0,
                nfound & (jnp.abs(nvalue) > start_abs * divergence_limit),
                False,
            )
            return res, comp, it + 1, nvalue, nx, ny, nfound, div

        comp0 = jnp.zeros((Tn, H, W), jnp.float32)
        init = (conv_res, comp0, it0, value0, x0, y0, found0, jnp.asarray(False))
        res, comp, it, value, x, y, found, div = jax.lax.while_loop(
            cond, body, init
        )
        return res, comp, it, value, found, div

    # ---- thresholds (multiscale_algorithm.cc:286-321) --------------------
    vals0, xs0, ys0, found0 = find_maxima(res_f)
    biased0 = jnp.abs(vals0 * bias)
    s0 = jnp.argmax(biased0)  # all scales start active
    initial_peak = biased0[s0]
    m_gain_threshold = jnp.maximum(
        initial_peak * (1.0 - major_loop_gain), major_iteration_threshold
    )
    first_threshold = jnp.maximum(m_gain_threshold, threshold)
    is_final_threshold = threshold > m_gain_threshold
    any_found0 = jnp.any(found0)

    scale_ids = jnp.arange(S)

    def select_scale(vals, active):
        sel = jnp.where(active, jnp.abs(vals * bias), neg_inf)
        return jnp.argmax(sel)

    # Auto-mask / component-list accumulators (the host path's
    # ``_mask_acc``/``_comp_acc``, here carried through the on-device loop;
    # ``SubMinorLoop``'s update hooks, ``subminor_loop.cc:220-246``).
    # Dummies keep the carried-state pytree shape-stable when not tracked.
    mask_acc0 = (
        jnp.zeros((S, H, W), bool)
        if track_masks
        else jnp.zeros((1, 1, 1), bool)
    )
    comp_acc0 = (
        jnp.zeros((S, N, H, W), jnp.float32)
        if track_components
        else jnp.zeros((1, 1, 1, 1), jnp.float32)
    )

    # ---- residual correction -------------------------------------------
    # Small-bucket scales: pure spectral subtraction at the unified size
    # (the spectrum of kernel_s ⊛ psf_c is kernel_f[s] * psf_f[c]).
    def small_correct(res_f, mod, comp, s):
        kf = jax.lax.dynamic_index_in_dim(kernel_f, s, 0, keepdims=False)
        comp_f = forward_fft2_padded(comp, (Ph, Pw))  # [Tn, ...]
        madd = inverse_fft2_real_trimmed(comp_f * kf[None], (Ph, Pw), (H, W))
        mod = mod + expand_planes(madd)
        comp_fn = expand_planes(comp_f)  # [N, ...]
        cfac = jnp.take(psf_f, psf_idx, axis=0)  # per-plane PSF spectra
        res_f = res_f - comp_fn * cfac * kf[None]
        return res_f, mod

    # Large-bucket scales (rarely selected): image-space correction at the
    # large padded size, then re-sync the spectral residual.
    def large_correct(res_f, mod, comp, s_local):
        kfL = jax.lax.dynamic_index_in_dim(
            kernel_f_large, s_local, 0, keepdims=False
        )
        comp_fL = forward_fft2_padded(comp, (PhL, PwL))  # [Tn, ...]
        madd = inverse_fft2_real_trimmed(
            comp_fL * kfL[None], (PhL, PwL), (H, W)
        )
        mod = mod + expand_planes(madd)
        comp_fLn = expand_planes(comp_fL)
        cfacL = jnp.take(psf_f_large, psf_idx, axis=0)
        delta = inverse_fft2_real_trimmed(
            comp_fLn * cfacL * kfL[None], (PhL, PwL), (H, W)
        )  # [N, H, W]
        res_f = res_f - forward_fft2_padded(delta, (Ph, Pw))
        return res_f, mod

    # ---- outer loop -------------------------------------------------------
    def outer_cond(state):
        (res_f, mod, it, countdown, vals, xs, ys, found, active, ncomp, flux,
         div, nocomp, _mask_acc, _comp_acc) = state
        s = select_scale(vals, active)
        peak_unnorm = vals[s]
        ok = it < max_iterations
        ok &= jnp.abs(peak_unnorm * bias[s]) > first_threshold
        if stop_on_negative:
            ok &= peak_unnorm >= 0.0
        ok &= countdown > 0
        return ok & ~div & ~nocomp & any_found0

    def outer_body(state):
        (res_f, mod, it, countdown, vals, xs, ys, found, active, ncomp, flux,
         div, _nocomp, mask_acc, comp_acc) = state
        s = select_scale(vals, active)
        biased_peak = jnp.abs(vals[s] * bias[s])
        sub_gain_threshold = biased_peak * (1.0 - sub_loop_gain)
        countdown = countdown - (
            first_threshold > sub_gain_threshold
        ).astype(countdown.dtype)
        first_sub = jnp.maximum(sub_gain_threshold, first_threshold)
        thr_sub = first_sub / bias[s]

        # Scale-convolved residual cube (multiscale_algorithm.cc:345-354):
        # N inverse transforms of res_f x kernel_f[s], no forwards.
        kf = jax.lax.dynamic_index_in_dim(kernel_f, s, 0, keepdims=False)
        conv_res = inverse_fft2_real_trimmed(
            res_f * kf[None], (Ph, Pw), (H, W)
        )
        tp = jax.lax.dynamic_index_in_dim(twice_psfs, s, 0, keepdims=False)
        tp = jnp.take(tp, psf_idx, axis=0)  # [C,H,W] -> per-plane [N,H,W]
        psf_pad = pad_psf_planes(tp)
        weight = valid_stack[s].astype(jnp.float32)
        if use_rms:
            weight = weight * rms_factor

        it_before = it
        _cres, comp, it, value, sub_found, sub_div = dense_subminor(
            conv_res,
            psf_pad,
            weight,
            thr_sub,
            gain_arr[s],
            it,
            vals[s],
            xs[s],
            ys[s],
            found[s],
        )
        nocomp = it == it_before
        div = sub_div | jnp.where(
            divergence_limit != 0.0,
            jnp.abs(value) > initial_peak * divergence_limit,
            False,
        )

        if split >= S:
            res_f, mod = small_correct(res_f, mod, comp, s)
        elif split == 0:
            res_f, mod = large_correct(res_f, mod, comp, s)
        else:
            res_f, mod = jax.lax.cond(
                s < split,
                lambda args: small_correct(*args, s),
                lambda args: large_correct(*args, jnp.maximum(s - split, 0)),
                (res_f, mod, comp),
            )

        ncomp = ncomp.at[s].add(it - it_before)
        if E is not None:
            flux_add = jnp.sum(
                jnp.matmul(E, jnp.sum(comp, axis=(1, 2)), precision=_EXACT)
            )
        else:
            flux_add = jnp.sum(comp)
        flux = flux.at[s].add(flux_add)
        if track_masks:
            nonzero = jnp.any(comp != 0.0, axis=0)
            row = jax.lax.dynamic_index_in_dim(
                mask_acc, s, 0, keepdims=False
            )
            mask_acc = jax.lax.dynamic_update_index_in_dim(
                mask_acc, row | nonzero, s, 0
            )
        if track_components:
            row = jax.lax.dynamic_index_in_dim(
                comp_acc, s, 0, keepdims=False
            )
            comp_acc = jax.lax.dynamic_update_index_in_dim(
                comp_acc, row + expand_planes(comp), s, 0
            )

        # Scale (de)activation uses the pre-refresh maxima
        # (multiscale_algorithm.cc:636-656) ...
        act_thr = jnp.abs(vals[s]) * (1.0 - minor_loop_gain) * bias[s]
        active = (scale_ids == s) | (jnp.abs(vals * bias) > act_thr)
        # ... then every scale's maxima are refreshed (see the note in
        # multiscale.py::_find_active_scale_convolved_maxima).
        vals, xs, ys, found = find_maxima(res_f)
        return (
            res_f, mod, it, countdown, vals, xs, ys, found, active, ncomp,
            flux, div, nocomp, mask_acc, comp_acc,
        )

    init = (
        res_f,
        model,
        start_iteration,
        countdown0,
        vals0,
        xs0,
        ys0,
        found0,
        jnp.ones((S,), bool),
        jnp.zeros((S,), jnp.int32),
        jnp.zeros((S,), jnp.float32),
        jnp.asarray(False),
        jnp.asarray(False),
        mask_acc0,
        comp_acc0,
    )
    (res_f, mod, it, countdown, vals, xs, ys, found, active, ncomp, flux,
     div, nocomp, mask_acc, comp_acc) = jax.lax.while_loop(
        outer_cond, outer_body, init
    )

    res_out = inverse_fft2_real_trimmed(res_f, (Ph, Pw), (H, W)).astype(
        residual.dtype
    )
    s_final = select_scale(vals, active)
    final_biased = vals[s_final] * bias[s_final]
    return FusedMultiscaleResult(
        residual=res_out,
        model=mod,
        iteration_number=it,
        final_biased_peak=final_biased,
        final_scale=s_final.astype(jnp.int32),
        any_peak_found=any_found0 & jnp.any(found),
        diverging=div,
        no_components=nocomp,
        is_final_threshold=is_final_threshold,
        components_per_scale=ncomp,
        flux_per_scale=flux,
        mask_acc=mask_acc,
        comp_acc=comp_acc,
    )
