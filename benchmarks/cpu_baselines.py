"""CPU baselines for BASELINE.json configs 2-4.

The C++ reference cannot be built in this environment (empty vendored
submodules, no FFTW/GSL), so — as with the NumPy Högbom baseline in
bench.py — each config's baseline is the reference's *algorithmic core*
implemented with vectorized NumPy + multithreaded ``scipy.fft``:

* config 2 (Clark subminor, 2048²): sparse candidate set, integrated
  argmax over the set, PSF subtraction restricted to set pixels
  (``cpp/algorithms/subminor_loop.cc:62-115``).
* config 3 (multiscale, 2048² × 8 ch): per-scale FFT convolution bank,
  scale selection, fixed-scale subminor loop on twice-convolved images,
  FFT residual correction per outer iteration
  (``cpp/algorithms/multiscale_algorithm.cc:323-543``).
* config 4 (IUWT, 4096²): à-trous decomposition, per-scale MAD
  thresholds, structure selection, 20-iteration masked conjugate
  gradient per structure iteration
  (``cpp/algorithms/iuwt_deconvolution_algorithm.cc:326-407,803-918``).

Each ``baseline_*`` function returns ``(iterations, seconds)`` so callers
derive iterations/s; ``main`` prints one JSON line per config.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

try:
    from scipy import fft as sfft

    _WORKERS = os.cpu_count() or 1

    def _rfft2(a, s=None):
        return sfft.rfft2(a, s=s, workers=_WORKERS)

    def _irfft2(a, s):
        return sfft.irfft2(a, s=s, workers=_WORKERS)

except Exception:  # pragma: no cover
    def _rfft2(a, s=None):
        return np.fft.rfft2(a, s=s)

    def _irfft2(a, s):
        return np.fft.irfft2(a, s=s)


def _fft_convolve_same(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Circular FFT convolution with the kernel centered at (H//2, W//2),
    matching radler_tpu.ops.convolution.convolve_same semantics."""
    s = image.shape[-2:]
    kf = _rfft2(np.fft.ifftshift(kernel), s=s)
    return _irfft2(_rfft2(image, s=s) * kf, s=s).astype(np.float32)


# ---------------------------------------------------------------------------
# Config 2: Clark-style subminor loop.
# ---------------------------------------------------------------------------

def baseline_clark(
    psf: np.ndarray,
    residual: np.ndarray,
    n_iter: int,
    gain: float = 0.1,
    threshold_ratio: float = 0.1,
):
    """Sparse-set Clark loop (``subminor_loop.cc:62-115``): candidates are
    every |pixel| >= threshold; each iteration takes the set argmax and
    subtracts the PSF evaluated at every candidate offset."""
    size = residual.shape[0]
    cy, cx = size // 2, size // 2
    peak = float(np.abs(residual).max())
    threshold = threshold_ratio * peak
    ys, xs = np.nonzero(np.abs(residual) >= threshold)
    vals = residual[ys, xs].astype(np.float32).copy()
    k = vals.shape[0]
    print(f"[clark] candidate set K={k}", flush=True)
    if k == 0:
        return 0, 0.0

    t0 = time.perf_counter()
    it = 0
    for it in range(n_iter):
        j = int(np.abs(vals).argmax())
        v = float(vals[j]) * gain
        # PSF value at every candidate's offset from the peak (clipped
        # out-of-range offsets contribute zero, as in the patch subtract).
        dy = ys - ys[j] + cy
        dx = xs - xs[j] + cx
        ok = (dy >= 0) & (dy < size) & (dx >= 0) & (dx < size)
        vals[ok] -= v * psf[dy[ok], dx[ok]]
        if abs(vals[j]) < threshold:
            pass  # the reference re-checks the set max; keep iterating
    dt = time.perf_counter() - t0
    return it + 1, dt


# ---------------------------------------------------------------------------
# Config 3: multiscale CLEAN.
# ---------------------------------------------------------------------------

def _tapered_quadratic(scale: float, size: int) -> np.ndarray:
    """Tapered-quadratic scale kernel
    (``multiscale_transforms.h:163-195``)."""
    if scale <= 0.0:
        k = np.zeros((size, size), np.float32)
        k[size // 2, size // 2] = 1.0
        return k
    extent = int(np.ceil(scale * 0.5) * 2.0 + 1.0)
    extent = min(extent, size)
    yy, xx = np.mgrid[0:extent, 0:extent].astype(np.float32)
    cy = cx = extent // 2
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    alpha = scale * 0.5
    taper = 0.5 * (1.0 + np.cos(np.pi * np.minimum(r / alpha, 1.0)))
    k = np.maximum(0.0, 1.0 - (r / alpha) ** 2) * taper
    out = np.zeros((size, size), np.float32)
    top, left = size // 2 - cy, size // 2 - cx
    out[top : top + extent, left : left + extent] = k
    s = out.sum()
    return out / s if s > 0 else out


def baseline_multiscale(
    psfs: np.ndarray,  # [C, H, W]
    residual: np.ndarray,  # [C, H, W]
    n_iter: int,
    gain: float = 0.1,
    major_gain: float = 0.85,
    n_scales: int = 5,
    sub_minor_loop_gain: float = 0.2,
    padded_corrections: bool = False,
):
    """Multiscale minor loop: scale bank maxima -> fixed-scale subminor on
    twice-convolved images -> FFT residual correction per outer iteration
    (``multiscale_algorithm.cc:323-543``).

    The subminor loop uses the reference's stopping rule: it ends when the
    peak has decreased to ``(1 - sub_minor_loop_gain)`` of the value it had
    when the scale was selected (``settings.h:476-481``, default 0.2), NOT a
    fixed iteration count — so the scale-bank FFT refresh happens every few
    minor iterations, exactly as in the reference and in the JAX rebuild.

    ``padded_corrections=True`` pads the per-outer-iteration residual
    correction to the reference's own per-scale convolution size
    (``cpp/utils/fft_size_calculations.h:39-50``), the reference-faithful
    (heavier) variant; the default convolves at image size (wrap-risking,
    algorithmically LIGHTER than the reference — the adversarially fast
    CPU core)."""
    n_chan, size, _ = residual.shape
    beam = 2.0
    scales = [0.0] + [beam * (2.0**s) for s in range(1, n_scales)]
    kernels = np.stack([_tapered_quadratic(s, size) for s in scales])
    res = residual.copy()
    model = np.zeros_like(res)

    # Per-scale convolved integrated PSF peaks (bias/gain normalization).
    integ_psf = psfs.mean(axis=0)
    psf_scale_peak = np.empty(n_scales, np.float32)
    for s in range(n_scales):
        twice = _fft_convolve_same(
            _fft_convolve_same(integ_psf, kernels[s]), kernels[s]
        )
        psf_scale_peak[s] = twice[size // 2, size // 2]

    peak0 = None
    total_iters = 0
    t0 = time.perf_counter()
    while total_iters < n_iter:
        integ = res.mean(axis=0)
        # Scale bank: convolve the integrated residual by every kernel
        # (the reference's per-scale thread pool).
        conv = np.stack(
            [_fft_convolve_same(integ, kernels[s]) for s in range(n_scales)]
        )
        maxima = np.abs(conv).reshape(n_scales, -1).max(axis=1)
        sel = int(np.argmax(maxima / np.maximum(psf_scale_peak, 1e-12)))
        peak = float(maxima[sel])
        if peak0 is None:
            peak0 = peak
        if peak < (1.0 - major_gain) * peak0:
            break
        # Fixed-scale subminor: twice-convolved PSF patch subtraction on the
        # scale-convolved integrated image.
        twice_psf = _fft_convolve_same(
            _fft_convolve_same(integ_psf, kernels[sel]), kernels[sel]
        )
        cimg = conv[sel]
        half = size // 2
        sub_stop = (1.0 - sub_minor_loop_gain) * peak
        while total_iters < n_iter:
            j = int(np.abs(cimg).argmax())
            y, x = divmod(j, size)
            if abs(float(cimg[y, x])) <= sub_stop:
                break
            v = float(cimg[y, x]) * gain / max(psf_scale_peak[sel], 1e-12)
            y0, y1 = max(0, y - half), min(size, y + half)
            x0, x1 = max(0, x - half), min(size, x + half)
            py0, px0 = y0 - (y - half), x0 - (x - half)
            cimg[y0:y1, x0:x1] -= (
                v * twice_psf[py0 : py0 + (y1 - y0), px0 : px0 + (x1 - x0)]
            )
            model[:, y, x] += v
            total_iters += 1
        # Residual correction: subtract (scale-convolved model delta) ⊛ psf
        # per channel (one FFT pass per channel).
        delta = model.mean(axis=0)  # proxy for this pass's additions
        if padded_corrections:
            from radler_tpu.utils.fft_size import get_convolution_size

            p = get_convolution_size(scales[sel], size, 1.1)
            top = p // 2 - size // 2

            def embed(img):
                out = np.zeros((p, p), np.float32)
                out[top : top + size, top : top + size] = img
                return out

            corr_p = _fft_convolve_same(embed(delta), embed(kernels[sel]))
            for c in range(n_chan):
                full = _fft_convolve_same(corr_p, embed(psfs[c]))
                res[c] = residual[c] - full[top : top + size, top : top + size]
        else:
            corr = _fft_convolve_same(delta, kernels[sel])
            for c in range(n_chan):
                res[c] = residual[c] - _fft_convolve_same(corr, psfs[c])
    dt = time.perf_counter() - t0
    return total_iters, dt


# ---------------------------------------------------------------------------
# Config 4: IUWT.
# ---------------------------------------------------------------------------

_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _iuwt_convolve(img: np.ndarray, scale: int) -> np.ndarray:
    """Separable B3-spline smoothing with tap spacing 2^scale - 1, zero
    boundary (``iuwt_decomposition.h:243-261``)."""
    dist = (1 << scale) - 1
    out = _B3[2] * img
    for h_index in (0, 1, 3, 4):
        shift = (h_index - 2) * dist
        shifted = np.zeros_like(img)
        if shift > 0:
            shifted[:, : img.shape[1] - shift] = img[:, shift:]
        elif shift < 0:
            shifted[:, -shift:] = img[:, : img.shape[1] + shift]
        else:
            shifted = img
        out = out + _B3[h_index] * shifted
    img2 = out
    out = _B3[2] * img2
    for h_index in (0, 1, 3, 4):
        shift = (h_index - 2) * dist
        shifted = np.zeros_like(img2)
        if shift > 0:
            shifted[: img2.shape[0] - shift, :] = img2[shift:, :]
        elif shift < 0:
            shifted[-shift:, :] = img2[: img2.shape[0] + shift, :]
        else:
            shifted = img2
        out = out + _B3[h_index] * shifted
    return out


def _iuwt_decompose(img: np.ndarray, n_scales: int) -> np.ndarray:
    planes = []
    i0 = img
    i1 = img
    for scale in range(n_scales):
        i1 = _iuwt_convolve(i0, scale + 1)
        i2 = _iuwt_convolve(i1, scale + 1)
        planes.append(i0 - i2)
        i0 = i1
    planes.append(i1)
    return np.stack(planes)


def _iuwt_recompose(planes: np.ndarray, n_scales: int) -> np.ndarray:
    out = np.zeros_like(planes[0])
    started = False
    for scale in range(n_scales - 1, -1, -1):
        if not started:
            out = planes[scale].copy()
            started = True
        else:
            out = _iuwt_convolve(out, scale + 1) + planes[scale]
    return out


def baseline_iuwt(
    psf: np.ndarray,
    residual: np.ndarray,
    n_structure_iters: int,
    gain: float = 0.2,
    sigma_level: float = 4.0,
):
    """IUWT structure iterations: decompose + MAD thresholds + structure
    mask + 20-iteration masked CG + model/residual update
    (``iuwt_deconvolution_algorithm.cc:803-918``)."""
    size = residual.shape[0]
    n_scales = max(int(np.log2(size)) - 3, 2)
    res = residual.copy()
    psf_kf = _rfft2(np.fft.ifftshift(psf), s=(size, size))

    def forward(img, mask):
        conv = _irfft2(_rfft2(img, s=(size, size)) * psf_kf, s=(size, size))
        planes = _iuwt_decompose(conv.astype(np.float32), n_scales)
        planes[:n_scales] *= mask
        planes[n_scales] = 0.0
        return planes

    t0 = time.perf_counter()
    done = 0
    for done in range(n_structure_iters):
        coeffs = _iuwt_decompose(res, n_scales)
        sig = (
            np.median(np.abs(coeffs[:n_scales]).reshape(n_scales, -1), axis=1)
            / 0.674559
        )
        thr = sig * (sigma_level * 4.0 / 5.0)
        mask = coeffs[:n_scales] > thr[:, None, None]
        if not mask.any():
            break
        masked = coeffs.copy()
        masked[:n_scales] *= mask
        masked[n_scales] = 0.0
        dirty_img = _iuwt_recompose(masked, n_scales)
        # 20-iteration masked CG (``RunConjugateGradient``).
        model = np.zeros_like(res)
        residual_v = dirty_img.copy()
        gradient = dirty_img.copy()
        for _ in range(20):
            grad_fwd = forward(gradient, mask)
            scratch = _iuwt_recompose(grad_fwd, n_scales)
            gds = float(np.vdot(gradient, scratch))
            rd = float(np.vdot(residual_v, residual_v))
            if gds == 0.0 or rd == 0.0:
                break
            step = rd / gds
            model += step * gradient
            residual_v = residual_v - step * scratch
            gstep = float(np.vdot(residual_v, residual_v)) / rd
            gradient = residual_v + gstep * gradient
        res = res - gain * _irfft2(
            _rfft2(model, s=(size, size)) * psf_kf, s=(size, size)
        ).astype(np.float32)
    dt = time.perf_counter() - t0
    return done + 1, dt


def main():
    import argparse

    from bench import make_problem, make_diffuse_problem

    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--config", choices=("clark", "multiscale", "iuwt"), required=True
    )
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument(
        "--padded",
        action="store_true",
        help="multiscale only: reference-faithful per-scale padded "
        "correction sizes instead of image-size corrections",
    )
    args = ap.parse_args()

    if args.config == "clark":
        size = args.size or 2048
        iters = args.iters or 2000
        psf, residual = make_problem(size, 300)
        n, dt = baseline_clark(psf, residual, iters)
    elif args.config == "multiscale":
        size = args.size or 2048
        iters = args.iters or 600
        psfs, residual = make_diffuse_problem(size, 8)
        n, dt = baseline_multiscale(
            psfs, residual, iters, padded_corrections=args.padded
        )
    else:
        size = args.size or 4096
        iters = args.iters or 16
        psfs, residual = make_diffuse_problem(size, 1)
        n, dt = baseline_iuwt(psfs[0], residual[0], iters)
    print(
        json.dumps(
            {
                "config": args.config,
                "size": size,
                "iterations": n,
                "seconds": round(dt, 3),
                "it_per_s": round(n / dt, 3) if dt > 0 else None,
            }
        )
    )


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
