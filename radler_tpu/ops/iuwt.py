"""Isotropic Undecimated Wavelet Transform (à-trous B3-spline).

Behavioral equivalent of ``cpp/algorithms/iuwt/iuwt_decomposition.{h,cc}``:
the 5-tap kernel [1,4,6,4,1]/16 applied separably with tap spacing
``2^scale - 1`` and *zero boundary* (taps falling outside the image are
dropped, no renormalization — see ``convolveComponentHorizontal``,
``iuwt_decomposition.h:199-211``).

Each scale's separable convolution is a handful of shifted adds over the
whole image (fused elementwise passes); the full decomposition of a [H, W] image
into S scales is S * 2 such convolutions, batched over leading axes.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

_H = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shifted(image: jnp.ndarray, dist: int, axis: int) -> jnp.ndarray:
    """out[i] = image[i + dist] with zero fill (reference's clipped taps).

    Implemented as pad+slice (pure data movement) rather than
    roll+iota+where, so no compare/select work is generated.
    """
    if dist == 0:
        return image
    axis = axis % image.ndim
    n = image.shape[axis]
    pad = [(0, 0)] * image.ndim
    sl = [slice(None)] * image.ndim
    if dist > 0:
        pad[axis] = (0, dist)
        sl[axis] = slice(dist, dist + n)
    else:
        pad[axis] = (-dist, 0)
        sl[axis] = slice(0, n)
    return jnp.pad(image, pad)[tuple(sl)]


def _conv_axis(image: jnp.ndarray, scale: int, axis: int) -> jnp.ndarray:
    """1-D B3-spline convolution with tap spacing (2^scale - 1)."""
    scale_dist = (1 << scale) - 1
    out = _H[2] * image
    for h_index in (0, 1, 3, 4):
        shift = (h_index - 2) * scale_dist
        out = out + _H[h_index] * _shifted(image, shift, axis)
    return out


def iuwt_convolve(image: jnp.ndarray, scale: int) -> jnp.ndarray:
    """Separable smoothing at one scale (``iuwt_decomposition.h:243-261``).

    ``scale`` here matches the reference's ``convolve(..., scale)`` argument
    (the decomposition at scale s calls it with s+1).
    """
    return _conv_axis(_conv_axis(image, scale, -1), scale, -2)


@partial(jax.jit, static_argnames=("n_scales",))
def decompose(image: jnp.ndarray, n_scales: int) -> jnp.ndarray:
    """IUWT decomposition; returns ``[n_scales + 1, H, W]`` where plane s
    holds the wavelet coefficients w_s = i_s - conv(conv(i_s)) and the last
    plane is the smooth residual (``IuwtDecomposition::DecomposeSt``,
    ``iuwt_decomposition.h:100-119``).  Each scale's separable smoothing
    is a chain of shifted adds that XLA fuses into a few elementwise
    passes."""
    coefficients = []
    i0 = image
    i1 = image
    for scale in range(n_scales):
        i1 = iuwt_convolve(i0, scale + 1)
        i2 = iuwt_convolve(i1, scale + 1)
        coefficients.append(i0 - i2)
        i0 = i1
    coefficients.append(i1)
    return jnp.stack(coefficients)


@partial(jax.jit, static_argnames=("n_scales", "include_largest"))
def recompose(
    scales: jnp.ndarray, n_scales: int, include_largest: bool
) -> jnp.ndarray:
    """Inverse transform (``IuwtDecomposition::Recompose``,
    ``iuwt_decomposition.h:121-148``): repeated smoothing + coefficient
    addition from the coarsest scale down."""
    if include_largest:
        output = scales[n_scales]
        is_zero = False
    else:
        output = jnp.zeros_like(scales[0])
        is_zero = True
    for scale in range(n_scales - 1, -1, -1):
        if is_zero:
            output = scales[scale]
            is_zero = False
        else:
            output = iuwt_convolve(output, scale + 1) + scales[scale]
    return output


def apply_mask(scales: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Zero coefficients outside the per-scale mask and zero the smooth plane
    (``IuwtDecomposition::ApplyMask``, ``iuwt_decomposition.h:162-169``).
    ``mask`` is bool ``[n_scales, H, W]``; ``scales`` is
    ``[n_scales + 1, H, W]``."""
    n_scales = mask.shape[0]
    masked = jnp.where(mask, scales[:n_scales], 0.0)
    smooth = jnp.zeros_like(scales[n_scales])[None]
    return jnp.concatenate([masked, smooth])


@partial(jax.jit, static_argnames=("allow_negative",))
def scale_peak_stats(
    coeffs: jnp.ndarray,  # [S, H, W]
    window: jnp.ndarray,  # [H, W] bool
    allow_negative: bool = True,
):
    """Per-scale masked argmax in one dispatch: returns (vals, xs, ys) with
    ``vals[s] = max over window of |coeffs[s]|`` (or the signed value when
    ``allow_negative`` is False).  Device equivalent of the per-scale
    ``GetMaxAbs{With,Without}Mask`` loop
    (``iuwt_deconvolution_algorithm.cc:112-167``)."""
    S, H, W = coeffs.shape
    value = jnp.abs(coeffs) if allow_negative else coeffs
    masked = jnp.where(window[None], value, -jnp.inf)
    flat = masked.reshape(S, H * W)
    idx = jnp.argmax(flat, axis=1)
    vals = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    ys = (idx // W).astype(jnp.int32)
    xs = (idx % W).astype(jnp.int32)
    return vals, xs, ys


@jax.jit
def select_structures(
    coeffs: jnp.ndarray,  # [S+1, H, W]
    thresholds: jnp.ndarray,  # [S] (signed: negative selects two-sided)
    window: jnp.ndarray,  # [H, W] bool
    min_scale: jnp.ndarray,  # scalar int
):
    """Device form of ``image_analysis::SelectStructures``
    (``image_analysis.cc:217-249``) with the flood-fill identity from the
    host version: every above-threshold pixel seeds a fill bounded to
    above-threshold pixels, so the selected set is exactly the windowed
    exceedance set.  Returns (mask [S,H,W] bool, count)."""
    S = thresholds.shape[0]
    c = coeffs[:S]
    thr = thresholds[:, None, None]
    exceeds = jnp.where(thr >= 0.0, c > thr, (c < thr) | (c > -thr))
    scale_idx = jnp.arange(S)[:, None, None]
    mask = exceeds & window[None] & (scale_idx >= min_scale)
    return mask, jnp.sum(mask)


@jax.jit
def bounding_box(image: jnp.ndarray):
    """1%-of-max support box (``BoundingBox``,
    ``iuwt_deconvolution_algorithm.cc:180-215``) computed on-device;
    returns (x1, y1, x2, y2) as a length-4 int32 vector (full image when no
    pixel is significant)."""
    H, W = image.shape
    a = jnp.abs(image)
    significant = a > a.max() * 0.01
    rows = jnp.any(significant, axis=1)
    cols = jnp.any(significant, axis=0)
    any_sig = jnp.any(rows)
    ridx = jnp.arange(H, dtype=jnp.int32)
    cidx = jnp.arange(W, dtype=jnp.int32)
    y1 = jnp.min(jnp.where(rows, ridx, H))
    y2 = jnp.max(jnp.where(rows, ridx, -1)) + 1
    x1 = jnp.min(jnp.where(cols, cidx, W))
    x2 = jnp.max(jnp.where(cols, cidx, -1)) + 1
    box = jnp.stack([x1, y1, x2, y2]).astype(jnp.int32)
    full = jnp.asarray([0, 0, W, H], jnp.int32)
    return jnp.where(any_sig, box, full)


@partial(jax.jit, static_argnames=("n_scales", "max_iterations"))
def conjugate_gradient(
    initial_dirty_scales: jnp.ndarray,  # masked IUWT of the dirty [S+1,H,W]
    mask: jnp.ndarray,  # [S,H,W] bool
    masked_dirty: jnp.ndarray,  # [H,W]
    psf_kernel_image: jnp.ndarray,  # [H,W] (kernel center at H/2,W/2)
    n_scales: int,
    max_iterations: int = 20,
):
    """``RunConjugateGradient`` (``iuwt_deconvolution_algorithm.cc:326-407``)
    as one compiled ``lax.while_loop``.  The reference spends 2 FFT
    convolutions + 2 IUWT transforms per iteration (one forward for the step,
    one to re-derive the model's response for the SNR check); the forward
    operator ``img -> masked-IUWT(img (x) psf)`` is linear, so the model's
    response is accumulated from the already-computed gradient response
    instead — 1 convolution + 1 transform per iteration.  The PSF spectrum is
    also hoisted out of the loop (XLA does not hoist large ops from
    ``while_loop`` bodies).  Returns ``(structure_model, status)`` where
    ``status`` is a packed ``[success, snr]`` float vector (one host pull)."""
    from .convolution import convolve_same_prefft, prepare_kernel_fft

    ker_f = prepare_kernel_fft(psf_kernel_image)

    def forward(img):
        conv = convolve_same_prefft(img, ker_f)
        return apply_mask(decompose(conv, n_scales), mask)

    def snr_of(model_scales):
        m = initial_dirty_scales
        n = model_scales
        m_sum = jnp.sum(m * m)
        n_sum = jnp.sum((m - n) * (m - n))
        return jnp.where(n_sum != 0.0, m_sum / n_sum, jnp.inf)

    zero_model = jnp.zeros_like(masked_dirty)

    def cond(state):
        it, model, model_fwd, gradient, residual, snr, done, success = state
        return (~done) & (it < max_iterations)

    def body(state):
        it, model, model_fwd, gradient, residual, snr, done, success = state
        grad_fwd = forward(gradient)
        scratch = recompose(grad_fwd, n_scales, False)
        gds = jnp.vdot(gradient, scratch)
        rd = jnp.vdot(residual, residual)
        fail = (gds == 0.0) | (rd == 0.0)
        step = jnp.where(gds != 0.0, rd / gds, 0.0)
        model = model + step * gradient
        model_fwd = model_fwd + step * grad_fwd
        residual2 = residual - step * scratch
        gstep = jnp.where(rd != 0.0, jnp.vdot(residual2, residual2) / rd, 0.0)
        gradient = residual2 + gstep * gradient
        prev_snr = snr
        snr = snr_of(model_fwd)
        conv_hi = (snr > 100.0) & (it > 2)
        conv_dec = (snr < prev_snr) & (it > 5) & (snr > 3.0)
        done = fail | conv_hi | conv_dec
        success = ~fail & (conv_hi | conv_dec)
        return it + 1, model, model_fwd, gradient, residual2, snr, done, success

    init = (
        jnp.int32(0),
        zero_model,
        jnp.zeros_like(initial_dirty_scales),
        masked_dirty,
        masked_dirty,
        jnp.float32(0.0),
        jnp.asarray(False),
        jnp.asarray(False),
    )
    it, model, model_fwd, gradient, residual, snr, done, success = (
        jax.lax.while_loop(cond, body, init)
    )
    # Ran all iterations without an early exit: success iff SNR > 3
    # (``iuwt_deconvolution_algorithm.cc:398-406``).
    success = jnp.where(done, success, snr > 3.0)
    # Packed [success, snr] so the host pulls one tiny vector (each pull is
    # a device-to-host round trip).
    return model, jnp.stack([success.astype(jnp.float32), snr])


@partial(jax.jit, static_argnames=("n_scales", "allow_negative"))
def structure_stats(image, window, n_scales: int, allow_negative: bool):
    """Decompose + per-scale MAD sigma + windowed argmax in ONE dispatch.

    Each eager op is a launch and each pull a device-to-host round trip;
    this fuses
    the front half of ``FindAndDeconvolveStructure``
    (``iuwt_deconvolution_algorithm.cc:414-483``) so the host pulls a single
    ``[5, S]`` stat block (sigma, |val|, x, y, signed value at the peak)
    alongside the coefficients."""
    from .noise import mad_sigma_batched

    coeffs = decompose(image, n_scales)
    # MAD sigma from every 4th row for large images: the exact median sorts
    # S full planes (~55 ms of a ~300 ms structure iteration at 4096²,
    # measured); a quarter-sample estimates sigma to ~0.1% (vs the 4-sigma
    # thresholds it feeds, iuwt_deconvolution_algorithm.cc:414-426).
    # Row (not column) striding: contiguous rows DMA cheaply where a 2-D
    # strided gather measured 50x SLOWER than the full sort on TPU.
    mad_src = (
        coeffs[:n_scales, ::4, :]
        if image.shape[-2] >= 2048
        else coeffs[:n_scales]
    )
    vals, xs, ys = scale_peak_stats(coeffs[:n_scales], window, allow_negative)
    flat = coeffs[:n_scales].reshape(n_scales, -1)
    idx = (ys.astype(jnp.int32) * image.shape[-1] + xs.astype(jnp.int32))
    signed = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    stats = jnp.stack(
        [
            mad_sigma_batched(mad_src),
            vals,
            xs.astype(jnp.float32),
            ys.astype(jnp.float32),
            signed,
        ]
    )
    return coeffs, stats


@partial(jax.jit, static_argnames=("n_scales",))
def psf_response_stats(psf: jnp.ndarray, n_scales: int) -> jnp.ndarray:
    """``MeasureRMSPerScale`` (``iuwt_deconvolution_algorithm.cc:42-102``) in
    one dispatch: returns ``[3, S]`` = (per-scale RMS of the PSF wavelet
    response, center peak response, center response of the re-decomposed
    scale-1 plane)."""
    scales = decompose(psf, n_scales)
    h, w = psf.shape
    cy, cx = h // 2, w // 2
    rms_v = jnp.sqrt(jnp.mean(scales[:n_scales] ** 2, axis=(1, 2)))
    peak = scales[:n_scales, cy, cx]
    next_scales = decompose(scales[1], n_scales)
    peak_next = next_scales[:n_scales, cy, cx]
    return jnp.stack([rms_v, peak, peak_next])


@partial(jax.jit, static_argnames=("n_scales",))
def masked_recompose_bbox(coeffs, mask, n_scales: int):
    """apply_mask + recompose + 1%-support bounding box, one dispatch."""
    rec = recompose(apply_mask(coeffs, mask), n_scales, False)
    return bounding_box(rec)


@partial(jax.jit, static_argnames=("n_scales",))
def masked_dirty_of(dirty, mask, n_scales: int):
    """(masked IUWT of dirty, its recomposition), one dispatch."""
    mds = apply_mask(decompose(dirty, n_scales), mask)
    return mds, recompose(mds, n_scales, False)


@jax.jit
def rms_guard(dirty, structure_model, psf, gain):
    """RMS before/after a candidate gain-scaled subtraction
    (``iuwt_deconvolution_algorithm.cc:608-618``); returns a packed
    ``[rms_before, rms_after]`` vector (one dispatch, one host pull)."""
    from .convolution import convolve_same

    conv = convolve_same(structure_model, psf)
    rb = jnp.sqrt(jnp.mean(dirty * dirty))
    d2 = dirty - gain * conv
    ra = jnp.sqrt(jnp.mean(d2 * d2))
    return jnp.stack([rb, ra])


@partial(
    jax.jit,
    static_argnames=("n_scales", "allow_negative"),
)
def structure_stats_select(
    image: jnp.ndarray,  # [H, W] integrated dirty
    window: jnp.ndarray,  # [H, W] bool peak-search window
    select_window: jnp.ndarray,  # [H, W] bool structure-selection window
    psf_rms: jnp.ndarray,  # [S] per-scale PSF wavelet RMS
    scale0_factor: jnp.ndarray,  # psf_peak_response[1]/response_to_next[0]
    sigma_level: jnp.ndarray,
    absolute_threshold: jnp.ndarray,
    tolerance: jnp.ndarray,
    min_scale: jnp.ndarray,  # traced: scale escalation must not recompile
    n_scales: int,
    allow_negative: bool,
):
    """The whole front half of ``FindAndDeconvolveStructure`` +
    ``FillAndDeconvolveStructure``'s selection as ONE program with ONE host
    pull: decompose + per-scale stats, the significant-scale choice
    (device replica of ``iuwt_deconvolution_algorithm.cc:439-483``), the
    adjusted per-scale thresholds, the structure mask
    (``image_analysis.cc:217-249``), and its bounding box.  The mask/bbox
    are speculative when no significant pixel exists — a wasted pass costs
    less than the extra device-to-host round trips it replaces.

    Returns ``(coeffs, mask, blob)`` with ``blob`` =
    ``[stats(5*S) | count | x1 y1 x2 y2 | sel signed_max]`` (float32).
    """
    coeffs, stats = structure_stats(image, window, n_scales, allow_negative)
    rmses, vals = stats[0], stats[1]
    # Significant-scale choice: ascending scan, the scale-0 winner carries
    # an adjusted comparison value (cc:452-467).
    max_val = jnp.float32(-1.0)
    sel = jnp.int32(-1)
    for s in range(n_scales):
        abs_coef = vals[s] / psf_rms[s]
        ok = (
            (abs_coef > max_val)
            & (vals[s] > rmses[s] * sigma_level)
            & (vals[s] > rmses[s] / rmses[0] * absolute_threshold)
            & (jnp.int32(s) >= min_scale)
        )
        if s == 0:
            cand = (
                vals[0]
                / jnp.minimum(psf_rms[0], psf_rms[1])
                * scale0_factor
            )
        else:
            cand = abs_coef
        sel = jnp.where(ok, jnp.int32(s), sel)
        max_val = jnp.where(ok, cand, max_val)
    sel_c = jnp.maximum(sel, 0)
    signed_max = jnp.where(sel >= 0, stats[4][sel_c], 0.0)
    thresholds = rmses * (sigma_level * 4.0 / 5.0)
    thr = jnp.maximum(thresholds, tolerance * jnp.abs(signed_max))
    thr = jnp.where(signed_max < 0.0, -thr, thr)
    mask, count = select_structures(
        coeffs, thr[:n_scales], select_window, min_scale
    )
    bbox = masked_recompose_bbox(coeffs, mask, n_scales)
    blob = jnp.concatenate(
        [
            stats.reshape(-1),
            count[None].astype(jnp.float32),
            jnp.asarray(bbox, jnp.float32),
            jnp.stack([sel.astype(jnp.float32), signed_max]),
        ]
    )
    return coeffs, mask, blob


@partial(jax.jit, static_argnames=("n_scales", "max_iterations"))
def conjugate_gradient_guarded(
    initial_dirty_scales: jnp.ndarray,  # [S+1, H, W]
    mask: jnp.ndarray,  # [S, H, W] bool
    masked_dirty: jnp.ndarray,  # [H, W]
    dirty: jnp.ndarray,  # [H, W] (for the RMS guard)
    psf_kernel_image: jnp.ndarray,  # [H, W]
    gain: jnp.ndarray,
    n_scales: int,
    max_iterations: int = 20,
):
    """:func:`conjugate_gradient` followed by :func:`rms_guard` in ONE
    program: the guard's convolution is speculative when CG fails, but a
    host round trip per structure iteration leaves the device idle longer
    than the wasted convolution takes.  Returns
    ``(model, [success, snr, rms_before, rms_after])`` — one pull for both
    decisions (``iuwt_deconvolution_algorithm.cc:604-618``)."""
    model, status = conjugate_gradient(
        initial_dirty_scales, mask, masked_dirty, psf_kernel_image,
        n_scales, max_iterations,
    )
    guard = rms_guard(dirty, model, psf_kernel_image, gain)
    return model, jnp.concatenate([status, guard])


@partial(jax.jit, static_argnames=("end_scale_n", "new_h", "new_w"))
def trim_coeffs_box(coeffs, y1, x1, end_scale_n: int, new_h: int, new_w: int):
    """Slice ``coeffs[:end_scale, box]`` and append a zero smooth plane —
    the trimmed-recursion input (``FillAndDeconvolveStructure`` trim path) —
    in one dispatch."""
    sl = jax.lax.dynamic_slice(
        coeffs, (jnp.int32(0), y1, x1), (end_scale_n, new_h, new_w)
    )
    return jnp.concatenate([sl, jnp.zeros((1, new_h, new_w), sl.dtype)])


@partial(jax.jit, static_argnames=("h", "w"))
def slice_box2(img, y1, x1, h: int, w: int):
    return jax.lax.dynamic_slice(img, (y1, x1), (h, w))


@partial(jax.jit, static_argnames=("h", "w"))
def slice_box3(img, y1, x1, h: int, w: int):
    return jax.lax.dynamic_slice(
        img, (jnp.int32(0), y1, x1), (img.shape[0], h, w)
    )


@partial(jax.jit, static_argnames=("full_h", "full_w"))
def embed_box3_zeros(small, y1, x1, full_h: int, full_w: int):
    """Zero-filled [N, full_h, full_w] with ``small`` written at (y1, x1)."""
    full = jnp.zeros((small.shape[0], full_h, full_w), small.dtype)
    return jax.lax.dynamic_update_slice(full, small, (jnp.int32(0), y1, x1))


@partial(jax.jit, static_argnames=("n_planes",))
def expand_single_plane(structure_model, n_planes: int):
    """[H, W] -> [n_planes, H, W] with plane 0 = model, rest zero."""
    out = jnp.zeros(
        (n_planes,) + structure_model.shape, structure_model.dtype
    )
    return out.at[0].set(structure_model)


@partial(jax.jit, static_argnames=("n_scales",))
def component_fit_ratio(mask, model, masked_dirty, psf, area, n_scales: int):
    """``PerformSubImageComponentFit`` (``iuwt_deconvolution_algorithm.cc:
    772-801``): flux ratio of the masked-IUWT model response to the masked
    dirty over one component area, one dispatch."""
    from .convolution import convolve_same

    conv = convolve_same(model, psf)
    masked_model = recompose(
        apply_mask(decompose(conv, n_scales), mask), n_scales, False
    )
    model_sum = jnp.sum(jnp.where(area, masked_model, 0.0))
    dirty_sum = jnp.sum(jnp.where(area, masked_dirty, 0.0))
    return jnp.stack([model_sum, dirty_sum])


@partial(jax.jit, static_argnames=("n_scales", "bh", "bw"))
def component_fit_ratio_batched(
    mask: jnp.ndarray,  # [S, H, W] bool
    model: jnp.ndarray,  # [H, W] structure model
    masked_dirty: jnp.ndarray,  # [H, W]
    psf_trimmed: jnp.ndarray,  # [bh, bw] (pre-trimmed to the bucket size)
    areas: jnp.ndarray,  # [P, bh, bw] bool per-component areas (box-local)
    y1s: jnp.ndarray,  # [P] int32 box origins
    x1s: jnp.ndarray,  # [P] int32
    n_scales: int,
    bh: int,
    bw: int,
) -> jnp.ndarray:
    """All components of one box-size bucket in ONE device dispatch.

    Per component this is exactly ``PerformSubImageComponentFitBoxed`` +
    ``...Fit`` (``iuwt_deconvolution_algorithm.cc:744-801``): slice the
    component's adjusted box, restrict the model to the component area,
    convolve with the (same-size) trimmed PSF, masked-IUWT it, and measure
    the model/dirty flux sums over the area.  The host loop over components
    (and its one device round trip each) is replaced by a ``lax.map`` inside
    a single program.  Returns ``[P, 2]`` (model_sum, dirty_sum).
    """
    from .convolution import convolve_same

    s = mask.shape[0]

    def one(args):
        area, y1, x1 = args
        m = jax.lax.dynamic_slice(model, (y1, x1), (bh, bw))
        msk = jax.lax.dynamic_slice(mask, (jnp.int32(0), y1, x1), (s, bh, bw))
        dirty = jax.lax.dynamic_slice(masked_dirty, (y1, x1), (bh, bw))
        comp_model = jnp.where(area, m, 0.0)
        conv = convolve_same(comp_model, psf_trimmed)
        mm = recompose(
            apply_mask(decompose(conv, n_scales), msk), n_scales, False
        )
        return jnp.stack(
            [
                jnp.sum(jnp.where(area, mm, 0.0)),
                jnp.sum(jnp.where(area, dirty, 0.0)),
            ]
        )

    return jax.lax.map(one, (areas, y1s, x1s))


def end_scale(max_image_dimension: int) -> int:
    """``max(log2(dim) - 3, 2)`` (``iuwt_decomposition.h:182-184``)."""
    return max(int(math.log2(max_image_dimension)) - 3, 2)


def min_image_dimension(end_scale_value: int) -> int:
    """``iuwt_decomposition.h:186-188``."""
    return 1 << (end_scale_value + 3)
