"""Clark-style subminor loop on a sparse candidate set.

JAX equivalent of ``cpp/algorithms/subminor_loop.{h,cc}``.  The
reference gathers all pixels above the threshold into a dynamic vector and
iterates a scalar argmax/subtract loop over it; here the candidate set is a
*fixed-capacity* coordinate buffer (bucketed to limit recompilation) and the
whole minor loop is a single ``lax.while_loop`` over tiny ``[n_images, K]``
tensors that stay resident on the device.  The final residual correction — sparse
model ⊛ PSF subtracted from the full residual
(``subminor_loop.cc:195-218``) — is one batched padded FFT convolution.

Algorithm description: see the doc comment at
``cpp/algorithms/subminor_loop.h:17-50``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..image_set import CubeMeta, linear_integration_coefficients
from ..ops.convolution import padded_convolve
from ..ops.peak_finder import window_mask
from ..settings import SpectralFittingMode
from ..utils.fft_size import calculate_good_fft_size

# Routing between the one-program kernel (ops/pallas/subminor_fused.py) and
# the XLA while loop, from rates measured on an H100 80GB HBM3 (700 W power
# limit) with one image plane:
# * the XLA loop costs a flat 22-30 us per iteration from 4k to 64k
#   candidates — launch and loop-predicate overhead, not bytes;
# * the kernel streams the candidate state once per iteration: 4.5 us at
#   16k candidates, 11.5 us at 64k, i.e. ~2.2 us plus ~0.14 us per 1024
#   candidates per image plane;
# * the [C, K, K] interaction matrix builds at 1.3e11-2e11 elements/s.
_XLA_ITER_S = 22e-6
_KERNEL_ITER_S = 2.2e-6
_KERNEL_S_PER_CANDIDATE = 0.14e-6 / 1024
_MATRIX_ELEMENTS_PER_S = 1.3e11
# The kernel is taken only up to the largest work measured (images x
# padded candidates <= 65536, where it still ran at half the XLA loop's
# time) and while its matrix takes at most half of the device's memory.
_KERNEL_MAX_WORK = 65536
_MATRIX_MEMORY_FRACTION = 0.5


def _capacity_bucket(count: int, maximum: int) -> int:
    """Round the candidate count up to a {2^n, 1.5*2^n} bucket so jit caches
    stay small while the buffer holds every selected pixel.  The midpoint
    buckets keep the XLA loop's per-iteration gathers within 1.5x of the
    count."""
    cap = 256
    while cap < count:
        if count <= cap + cap // 2:
            cap = cap + cap // 2
            break
        cap *= 2
    return min(cap, maximum) if count <= maximum else maximum


@partial(
    jax.jit,
    static_argnames=(
        "allow_negative",
        "stop_on_negative",
        "fitter",
        "n_channels",
        "n_polarizations",
        "height",
        "width",
    ),
)
def _subminor_while(
    residual_k: jnp.ndarray,  # [N, K]
    model_k: jnp.ndarray,  # [N, K]
    rms_k: jnp.ndarray,  # [K]
    valid: jnp.ndarray,  # [K] bool
    xs: jnp.ndarray,  # [K] int32
    ys: jnp.ndarray,  # [K] int32
    psfs: jnp.ndarray,  # [C, H, W] (twice-convolved for multiscale)
    coef_lin: jnp.ndarray,  # [N]
    threshold: jnp.ndarray,
    gain: jnp.ndarray,
    start_iteration: jnp.ndarray,
    max_iterations: jnp.ndarray,
    divergence_limit: jnp.ndarray,
    *,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    n_channels: int,
    n_polarizations: int,
    height: int,
    width: int,
):
    """One full subminor run; mirrors ``SubMinorLoop::Run``
    (``subminor_loop.cc:38-117``)."""
    neg_inf = jnp.float32(-jnp.inf)
    psf_indices = jnp.arange(n_channels * n_polarizations) // n_polarizations

    def get_max(res_k):
        """``SubMinorModel::GetMaxComponent`` (``subminor_loop.cc:13-36``)."""
        scratch = jnp.einsum("i,ik->k", coef_lin, res_k) * rms_k
        value = jnp.abs(scratch) if allow_negative else scratch
        masked = jnp.where(valid, value, neg_inf)
        m = jnp.argmax(masked)
        return m, scratch[m]

    m0, max0 = get_max(residual_k)
    max_at_start = jnp.abs(max0)

    def cond(state):
        res_k, mod_k, it, m, max_val, diverging = state
        ok = jnp.abs(max_val) > threshold
        ok &= it < max_iterations
        if stop_on_negative:
            ok &= max_val >= 0.0
        return ok & ~diverging

    def body(state):
        res_k, mod_k, it, m, max_val, _ = state
        component_values = res_k[:, m] * gain  # [N]
        x = xs[m]
        y = ys[m]
        if fitter is not None and fitter.is_active:
            vals = component_values.reshape(n_channels, n_polarizations)
            component_values = fitter.fit_and_evaluate(vals, x, y).reshape(-1)
        mod_k = mod_k.at[:, m].add(component_values)
        # PSF values at every candidate position relative to the component
        # (``subminor_loop.cc:91-105``); note the reference indexes the PSF
        # with the *image* dimensions.
        dyp = ys - y + height // 2
        dxp = xs - x + width // 2
        inb = (
            (dyp >= 0)
            & (dyp < height)
            & (dxp >= 0)
            & (dxp < width)
            & valid
        )
        psf_vals = psfs[
            :,
            jnp.clip(dyp, 0, height - 1),
            jnp.clip(dxp, 0, width - 1),
        ]  # [C, K]
        psf_vals = jnp.where(inb[None, :], psf_vals, 0.0)
        res_k = res_k - psf_vals[psf_indices] * component_values[:, None]
        m2, max2 = get_max(res_k)
        diverging = jnp.where(
            divergence_limit != 0.0,
            jnp.abs(max2) > max_at_start * divergence_limit,
            False,
        )
        return res_k, mod_k, it + 1, m2, max2, diverging

    init = (
        residual_k,
        model_k,
        start_iteration,
        m0,
        max0,
        jnp.asarray(False),
    )
    res_k, mod_k, it, m, max_val, diverging = jax.lax.while_loop(cond, body, init)
    return res_k, mod_k, it, max_val, diverging


@partial(jax.jit, static_argnames=("allow_negative", "use_rms", "use_mask"))
def _select_candidates(
    residual_cube: jnp.ndarray,  # [N, H, W]
    coef_lin: jnp.ndarray,  # [N]
    rms_factor: jnp.ndarray,  # [H, W] (ones when unused)
    window: jnp.ndarray,  # [H, W] bool (border window)
    mask: jnp.ndarray,  # [H, W] bool (all-true when unused)
    threshold: jnp.ndarray,
    *,
    allow_negative: bool,
    use_rms: bool,
    use_mask: bool,
):
    """Candidate-pixel mask + count + clean-depth estimate in one dispatch
    (``subminor_loop.cc:143-184`` selection semantics).

    The depth estimate sums ``ln(value/threshold)`` over selectable *local
    maxima*: CLEAN removes each source with a geometric gain decay, so the
    expected iteration count is ``est_logsum / -ln(1 - gain)`` (validated
    within ~20% on synthetic fields) — used to gate the fused-kernel path,
    whose one-time interaction-matrix build must amortize."""
    integrated = jnp.einsum("i,ihw->hw", coef_lin, residual_cube)
    if use_rms:
        integrated = integrated * rms_factor
    value = jnp.abs(integrated) if allow_negative else integrated
    selectable = (value >= threshold) & window
    if use_mask:
        selectable = selectable & mask
    neigh_max = value
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh_max = jnp.maximum(
                neigh_max, jnp.roll(value, (dy, dx), axis=(0, 1))
            )
    local_max = selectable & (value >= neigh_max)
    est_logsum = jnp.sum(
        jnp.where(
            local_max, jnp.log(jnp.maximum(value, 1e-30) / threshold), 0.0
        )
    )
    return selectable, value, jnp.sum(selectable), est_logsum


@partial(jax.jit, static_argnames=("cap", "use_rms", "overflow"))
def _gather_candidates(
    selectable: jnp.ndarray,  # [H, W] bool
    value: jnp.ndarray,  # [H, W] comparison value
    residual_cube: jnp.ndarray,  # [N, H, W]
    rms_factor: jnp.ndarray,  # [H, W]
    *,
    cap: int,
    use_rms: bool,
    overflow: bool,
):
    """Coordinate buffer + per-candidate gathers in one dispatch."""
    W = selectable.shape[1]
    if overflow:
        flat = jnp.where(selectable, value, -jnp.inf).reshape(-1)
        _, idx = jax.lax.top_k(flat, cap)
        idx = jnp.sort(idx)
        valid = jnp.ones(cap, dtype=bool)
    else:
        idx = jnp.nonzero(selectable.reshape(-1), size=cap, fill_value=-1)[0]
        valid = idx >= 0
    idx_c = jnp.maximum(idx, 0)
    xs = (idx_c % W).astype(jnp.int32)
    ys = (idx_c // W).astype(jnp.int32)
    residual_k = residual_cube[:, ys, xs] * valid[None, :]
    if use_rms:
        rms_k = rms_factor[ys, xs]
    else:
        rms_k = jnp.ones((cap,), dtype=jnp.float32)
    return xs, ys, valid, residual_k, rms_k


@partial(jax.jit, static_argnames=("padded_h", "padded_w", "n_channels"))
def _correct_residual(
    residual_cube: jnp.ndarray,  # [N, H, W]
    model_full: jnp.ndarray,  # [N, H, W]
    psfs: jnp.ndarray,  # [C, h, w] single-convolved
    padded_h: int,
    padded_w: int,
    n_channels: int,
):
    """residual -= model ⊛ psf per image (``subminor_loop.cc:195-218``)."""
    N, H, W = residual_cube.shape
    P = N // n_channels
    model_c = model_full.reshape(n_channels, P, H, W)
    conv = padded_convolve(
        model_c, psfs[:, None, :, :], padded_shape=(padded_h, padded_w)
    )
    return residual_cube - conv.reshape(N, H, W)


class SubMinorLoop:
    """Host-side orchestration of one subminor run."""

    def __init__(
        self,
        width: int,
        height: int,
        padded_width: int,
        padded_height: int,
        max_set_capacity: Optional[int] = None,
        use_kernel: Optional[bool] = None,
    ):
        self.width = width
        self.height = height
        self.padded_width = padded_width
        self.padded_height = padded_height
        self.threshold = 0.0
        self.considered_pixel_threshold = 0.0  # kept for API parity; the
        # reference never reads it (selection uses ``threshold``, see
        # ``subminor_loop.cc:167``).
        self.gain = 0.0
        self.horizontal_border = 0
        self.vertical_border = 0
        self.current_iteration = 0
        self.max_iterations = 0
        self.allow_negative_components = True
        self.stop_on_negative_component = False
        self.mask: Optional[np.ndarray] = None
        self.rms_factor_image: Optional[jnp.ndarray] = None
        self.divergence_limit = 0.0
        self.parent_algorithm = None
        self.flux_cleaned = 0.0
        self.max_set_capacity = max_set_capacity or width * height
        # None: the measured gate picks the one-program kernel or the XLA
        # loop; True/False force one of them.
        self.use_kernel = use_kernel

        # Result state
        self._xs: Optional[jnp.ndarray] = None
        self._ys: Optional[jnp.ndarray] = None
        self._valid: Optional[jnp.ndarray] = None
        self._model_k: Optional[jnp.ndarray] = None
        self._residual_k: Optional[jnp.ndarray] = None
        self._rms_k: Optional[jnp.ndarray] = None
        self._meta: Optional[CubeMeta] = None
        self._count: Optional[int] = None
        self._est_logsum: float = 0.0

    # -- configuration mirrors (subminor_loop.h:122-172) -------------------
    def set_threshold(self, threshold: float, considered_pixel_threshold: float):
        self.threshold = threshold
        self.considered_pixel_threshold = considered_pixel_threshold

    def set_iteration_info(self, current_iteration: int, max_iterations: int):
        self.current_iteration = current_iteration
        self.max_iterations = max_iterations

    def set_gain(self, gain: float):
        self.gain = gain

    def set_clean_borders(self, horizontal: int, vertical: int):
        self.horizontal_border = horizontal
        self.vertical_border = vertical

    # -- the run -----------------------------------------------------------
    def find_peak_positions(
        self, residual_cube: jnp.ndarray, meta: CubeMeta
    ) -> int:
        """Select all candidate pixels >= threshold within borders/mask
        (``subminor_loop.cc:143-184``).  Returns the number selected.

        Two device dispatches total: (mask + count) then, once the host has
        picked the capacity bucket, (coordinates + gathers).  The gathered
        ``[N, K]`` candidate state is stored on ``self`` for :meth:`run`.
        """
        use_rms = self.rms_factor_image is not None
        use_mask = self.mask is not None
        coef = jnp.asarray(linear_integration_coefficients(meta))
        # The reference's border loop never clamps yiStart against start_y=0
        # (subminor_loop.cc:151-154), equivalent to the plain window.
        win = jnp.asarray(
            window_mask(
                self.height,
                self.width,
                self.horizontal_border,
                self.vertical_border,
            )
        )
        ones_img = jnp.ones((self.height, self.width), jnp.float32)
        selectable, value, count_dev, est_dev = _select_candidates(
            residual_cube,
            coef,
            self.rms_factor_image if use_rms else ones_img,
            win,
            jnp.asarray(self.mask) if use_mask else win,
            jnp.float32(self.threshold),
            allow_negative=self.allow_negative_components,
            use_rms=use_rms,
            use_mask=use_mask,
        )
        # One host transfer for both scalars.
        count_f, est_f = np.asarray(
            jnp.stack([count_dev.astype(jnp.float32), est_dev])
        )
        count = int(count_f)
        self._count = count
        self._est_logsum = float(est_f)
        if count == 0:
            return 0
        cap = _capacity_bucket(count, self.max_set_capacity)
        xs, ys, valid, residual_k, rms_k = _gather_candidates(
            selectable,
            value,
            residual_cube,
            self.rms_factor_image if use_rms else ones_img,
            cap=cap,
            use_rms=use_rms,
            # Overflow: keep the cap strongest candidates (the reference has
            # no cap; this fallback keeps behavior sane for absurd sets).
            overflow=count > cap,
        )
        self._xs = xs
        self._ys = ys
        self._valid = valid
        self._residual_k = residual_k
        self._rms_k = rms_k
        return count

    # -- fused-kernel gating -------------------------------------------------
    @staticmethod
    def _fused_projection(fitter) -> Tuple[bool, Optional[tuple]]:
        """(compatible, projection-tuple) for the fused Pallas kernel.

        NO_FITTING needs no projection; POLYNOMIAL is a constant [C, C]
        linear map (``ops/spectral_fitting.py``) bakeable into the kernel;
        everything else (log fits, per-pixel forced terms) is incompatible.
        """
        if fitter is None or not fitter.is_active:
            return True, None
        if fitter.mode == SpectralFittingMode.POLYNOMIAL:
            proj = tuple(
                tuple(float(v) for v in row) for row in fitter._projection
            )
            return True, proj
        return False, None

    def _data_device(self):
        """The device holding the candidate state."""
        return next(iter(self._residual_k.devices()))

    def fused_qualifies(self, n_psf_images: int, fitter=None) -> bool:
        """Whether this run takes the one-program kernel: ``use_kernel``
        when set, otherwise a GPU backend, an in-kernel spectral fit, work
        and matrix within the measured limits, and an expected clean depth
        that pays for the matrix build."""
        if self._xs is None:
            return False
        fit_ok, _ = self._fused_projection(
            fitter if (fitter is not None and fitter.is_active) else None
        )
        if self.use_kernel is not None:
            if self.use_kernel and not fit_ok:
                raise ValueError(
                    "use_kernel=True with a spectral fit the kernel cannot run"
                )
            return self.use_kernel
        device = self._data_device()
        if device.platform != "gpu" or not fit_ok:
            return False
        from ..ops.pallas.subminor_fused import padded_capacity
        from ..utils.device_memory import fits_device_memory

        n_images = int(self._residual_k.shape[0])
        k = padded_capacity(int(self._xs.shape[0]))
        if n_images * k > _KERNEL_MAX_WORK:
            return False
        matrix_elements = n_psf_images * k * k
        if not fits_device_memory(
            4 * matrix_elements, _MATRIX_MEMORY_FRACTION, device
        ):
            return False
        # Expected clean depth: est_logsum / -ln(1 - gain) (see
        # _select_candidates).
        gain = min(max(self.gain, 1e-3), 0.999)
        est_iters = self._est_logsum / -np.log1p(-gain)
        saving = _XLA_ITER_S - (
            _KERNEL_ITER_S + _KERNEL_S_PER_CANDIDATE * n_images * k
        )
        return est_iters * saving >= matrix_elements / _MATRIX_ELEMENTS_PER_S

    def run(
        self,
        residual_cube: jnp.ndarray,
        meta: CubeMeta,
        twice_convolved_psfs: jnp.ndarray,
        fitter=None,
    ) -> Tuple[bool, Optional[float]]:
        """``SubMinorLoop::Run`` — returns (diverging, final_peak or None)."""
        from .multiscale import _timed

        self._meta = meta
        if self._count is None:
            count = _timed(
                "subminor:find_positions",
                self.find_peak_positions,
                residual_cube,
                meta,
            )
        else:
            count = self._count
        if count == 0:
            return False, None
        residual_k = self._residual_k
        rms_k = self._rms_k
        model_k = jnp.zeros_like(residual_k)
        coef = jnp.asarray(linear_integration_coefficients(meta))
        fit = fitter if (fitter is not None and fitter.is_active) else None
        if self.fused_qualifies(int(twice_convolved_psfs.shape[0]), fit):
            res_k, mod_k, it, max_val, diverging = self._run_fused(
                residual_k, model_k, rms_k, meta, twice_convolved_psfs, fit
            )
        else:
            res_k, mod_k, it, max_val, diverging = _timed(
                "subminor:while_loop",
                _subminor_while,
                residual_k,
                model_k,
                rms_k,
                self._valid,
                self._xs,
                self._ys,
                twice_convolved_psfs,
                coef,
                jnp.float32(self.threshold),
                jnp.float32(self.gain),
                jnp.int32(self.current_iteration),
                jnp.int32(self.max_iterations),
                jnp.float32(self.divergence_limit),
                allow_negative=self.allow_negative_components,
                stop_on_negative=self.stop_on_negative_component,
                fitter=fit,
                n_channels=meta.n_channels,
                n_polarizations=meta.n_polarizations,
                height=self.height,
                width=self.width,
            )
        self._residual_k = res_k
        self._model_k = mod_k
        # One host transfer for all three scalars (each pull is a
        # device-to-host round trip).
        it_f, max_f, div_f = np.asarray(
            jnp.stack(
                [it.astype(jnp.float32), max_val, diverging.astype(jnp.float32)]
            )
        )
        self.current_iteration = int(it_f)
        return bool(div_f), float(max_f)

    def _run_fused(
        self,
        residual_k: jnp.ndarray,
        model_k: jnp.ndarray,
        rms_k: jnp.ndarray,
        meta: CubeMeta,
        twice_convolved_psfs: jnp.ndarray,
        fit,
    ):
        """One-program subminor loop (``ops/pallas/subminor_fused.py``):
        pad the candidates to the kernel's power-of-two capacity, build the
        interaction matrix, run the loop, and drop the padding.  Off the
        GPU the kernel runs in the Pallas interpreter (tests only: the gate
        never picks it there)."""
        from .multiscale import _timed
        from ..ops.pallas.subminor_fused import (
            build_interaction_matrix,
            padded_capacity,
            subminor_loop_fused,
        )

        _, proj = self._fused_projection(fit)
        coef = tuple(float(v) for v in linear_integration_coefficients(meta))
        k = int(self._xs.shape[0])
        pad = padded_capacity(k) - k
        xs = jnp.pad(self._xs, (0, pad))
        ys = jnp.pad(self._ys, (0, pad))
        valid = jnp.pad(self._valid, (0, pad))
        matrix = _timed(
            "subminor:psf_matrix",
            build_interaction_matrix,
            twice_convolved_psfs,
            xs,
            ys,
            valid,
            height=self.height,
            width=self.width,
        )
        res_k, mod_k, it, max_val, diverging = _timed(
            "subminor:fused_loop",
            subminor_loop_fused,
            jnp.pad(residual_k, ((0, 0), (0, pad))),
            jnp.pad(model_k, ((0, 0), (0, pad))),
            jnp.pad(rms_k, (0, pad)),
            valid,
            matrix,
            jnp.float32(self.threshold),
            jnp.float32(self.gain),
            jnp.int32(self.current_iteration),
            jnp.int32(self.max_iterations),
            jnp.float32(self.divergence_limit),
            coef=coef,
            proj=proj,
            n_channels=meta.n_channels,
            n_polarizations=meta.n_polarizations,
            allow_negative=self.allow_negative_components,
            stop_on_negative=self.stop_on_negative_component,
            use_rms=self.rms_factor_image is not None,
            interpret=self._data_device().platform != "gpu",
        )
        return res_k[:, :k], mod_k[:, :k], it, max_val, diverging

    # -- post-run ----------------------------------------------------------
    def full_model_cube(self) -> jnp.ndarray:
        """Scatter the sparse model onto full images, all planes at once
        (``SubMinorLoop::GetFullIndividualModel``)."""
        N = self._model_k.shape[0]
        full = jnp.zeros((N, self.height, self.width), dtype=jnp.float32)
        vals = self._model_k * self._valid[None, :]
        return full.at[:, self._ys, self._xs].add(vals)

    def correct_residual_dirty(
        self, residual_cube: jnp.ndarray, single_convolved_psfs: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Subtract (sparse model ⊛ PSF) from the residual; returns
        (new_residual, full_model_cube)."""
        full_model = self.full_model_cube()
        new_residual = _correct_residual(
            residual_cube,
            full_model,
            single_convolved_psfs,
            self.padded_height,
            self.padded_width,
            self._meta.n_channels,
        )
        return new_residual, full_model

    def update_auto_mask(self, mask: np.ndarray) -> None:
        """OR positions with non-zero model values into ``mask``
        (``subminor_loop.cc:220-228``)."""
        nonzero = np.asarray(
            jnp.any(self._model_k != 0.0, axis=0) & self._valid
        )
        xs = np.asarray(self._xs)[nonzero]
        ys = np.asarray(self._ys)[nonzero]
        mask[ys, xs] = True

    def update_component_list(self, component_list, scale_index: int) -> None:
        """``subminor_loop.cc:230-246``."""
        model_k = np.asarray(self._model_k)
        valid = np.asarray(self._valid)
        nonzero = np.any(model_k != 0.0, axis=0) & valid
        xs = np.asarray(self._xs)[nonzero]
        ys = np.asarray(self._ys)[nonzero]
        values = model_k[:, nonzero]
        for j in range(xs.shape[0]):
            component_list.add(int(xs[j]), int(ys[j]), scale_index, values[:, j])


def choose_padded_size(width: int, height: int, padding: float) -> Tuple[int, int]:
    """Padded convolution size for the residual correction; the reference uses
    even ceil(padding*dim) (``generic_clean.cc:63-66``), we round up to the
    next 7-smooth size for FFT efficiency (strictly more zero padding, so
    wrap-around suppression is at least as good)."""
    return (
        calculate_good_fft_size(int(np.ceil(padding * height))),
        calculate_good_fft_size(int(np.ceil(padding * width))),
    )
