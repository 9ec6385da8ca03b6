#!/usr/bin/env python
"""Benchmark: minor-loop iterations/s of four configurations on one GPU.

Builds synthetic fields (point sources convolved with a PSF with sidelobes,
or extended emission for multiscale / IUWT), runs one full major iteration
through the public Radler API on the first JAX device, which must be a GPU,
and reports minor-loop iterations per second excluding compilation (a
warm-up major iteration on identical shapes runs first).

Engines:

* ``dense`` (default): the dense Högbom while loop (models/generic_clean.py).
* ``clark``: the Clark-style subminor loop on the sparse candidate set
  (models/subminor.py), the reference's fast path.

State is device-resident (``DeviceImageAccessor``): like the reference's
in-RAM caller buffers, the cube stays in device memory across major
iterations.  Every JSON line names the device it ran on; a failed
configuration makes the whole run exit non-zero.

``vs_baseline`` compares against a single-host NumPy Högbom loop (argmax +
PSF-patch subtraction, the reference's algorithmic core) timed on the same
host for the Högbom engine, and against recorded NumPy baselines for the
other engines (the C++ reference itself is not buildable from this
repository).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# CPU baselines recorded with benchmarks/cpu_baselines.py on a 2-core host
# (the reference's algorithmic cores in NumPy/scipy-fft).
# Reproduce: python benchmarks/cpu_baselines.py --config <name>
RECORDED_CPU_BASELINES = {
    # it/s, 2026-08-20
    "clark_2048": 2538.8,  # K=21040 candidate set, 2000 iters in 0.79 s
    "multiscale_2048x8": 40.4,  # 600 iters in 14.8 s
    "iuwt_4096": 0.002,  # 501.6 s per structure iteration
}


def make_problem(size: int, n_sources: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    psf = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    psf += np.exp(-r2 / (2.0 * 2.5**2)).astype(np.float32)
    # Faint sidelobe ring so the candidate set is non-trivial.
    ring = np.exp(-((np.sqrt(r2) - 12.0) ** 2) / (2.0 * 2.0**2))
    psf += 0.08 * ring.astype(np.float32)
    sky = np.zeros((size, size), np.float32)
    margin = size // 8
    ys = rng.integers(margin, size - margin, n_sources)
    xs = rng.integers(margin, size - margin, n_sources)
    amps = rng.uniform(0.2, 1.0, n_sources).astype(np.float32)
    np.add.at(sky, (ys, xs), amps)
    # Residual = sky convolved with the PSF (host FFT; wrap-free padding).
    pad = 1 << (size - 1).bit_length()
    psf_f = np.fft.rfft2(np.fft.ifftshift(_pad_center(psf, 2 * pad)))
    sky_f = np.fft.rfft2(_pad_center(sky, 2 * pad))
    conv = np.fft.irfft2(psf_f * sky_f, s=(2 * pad, 2 * pad))
    residual = _crop_center(conv, size).astype(np.float32)
    return psf, residual


def _pad_center(img, n):
    out = np.zeros((n, n), img.dtype)
    h, w = img.shape
    top, left = n // 2 - h // 2, n // 2 - w // 2
    out[top : top + h, left : left + w] = img
    return out


def _crop_center(img, n):
    h, w = img.shape
    top, left = h // 2 - n // 2, w // 2 - n // 2
    return img[top : top + n, left : left + n]


def device_record() -> dict:
    """The device this process runs on, as every JSON line reports it; a
    process without a GPU fails here instead of measuring the CPU."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, found {dev.platform}")
    smi = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": smi,
    }


def run_radler(psf, residual, n_iter: int, engine: str):
    import jax
    import jax.numpy as jnp
    import radler_tpu as rd

    size = residual.shape[0]
    psf_dev = jnp.asarray(psf)
    res_dev = jnp.asarray(residual)

    def one_run():
        s = rd.Settings()
        s.trimmed_image_width = size
        s.trimmed_image_height = size
        s.minor_iteration_count = n_iter
        s.absolute_threshold = 0.05
        s.minor_loop_gain = 0.1
        s.generic.use_sub_minor_optimization = engine == "clark"
        model = jnp.zeros_like(res_dev)
        r = rd.Radler(s, psf_dev, res_dev, model, 0.0)
        t0 = time.perf_counter()
        r.perform(0)
        jax.block_until_ready(r._table.front.residual_accessor.array)
        dt = time.perf_counter() - t0
        return r.iteration_number, dt

    one_run()  # warm-up/compile at identical shapes
    # Best of several warm runs.
    repeats = int(os.environ.get("RADLER_BENCH_REPEATS", "5"))
    best = min(
        (one_run() for _ in range(repeats)), key=lambda r: r[1] / max(r[0], 1)
    )
    return best


def make_diffuse_problem(size: int, n_channels: int, seed: int = 5):
    """Extended-emission multi-channel problem for the multiscale / IUWT
    configs (BASELINE.json configs 3 and 4)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psfs = []
    for c in range(n_channels):
        w = 2.5 * (1.0 + 0.04 * c)
        p = np.exp(-r2 / (2 * w * w))
        p += 0.06 * np.exp(-((np.sqrt(r2) - 14 * (1 + 0.03 * c)) ** 2) / 6)
        psfs.append(p.astype(np.float32))
    psfs = np.stack(psfs)
    sky = np.zeros((size, size), np.float32)
    for _ in range(60):
        cy, cx = rng.integers(size // 8, 7 * size // 8, 2)
        s = rng.uniform(1.5, 25)
        a = rng.uniform(0.2, 1.0)
        m = max(1, int(4 * s))
        y0, y1 = max(0, cy - m), min(size, cy + m)
        x0, x1 = max(0, cx - m), min(size, cx + m)
        sky[y0:y1, x0:x1] += a * np.exp(
            -((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2)
            / (2 * s * s)
        )
    residual = np.empty((n_channels, size, size), np.float32)
    for c in range(n_channels):
        fp = np.fft.rfft2(np.fft.ifftshift(psfs[c]))
        residual[c] = np.fft.irfft2(
            np.fft.rfft2(sky * (1 + 0.1 * c)) * fp, s=(size, size)
        ).astype(np.float32)
    return psfs, residual


def run_multiscale(size: int, n_channels: int, n_iter: int, repeats: int = 3):
    """Config 3: multiscale CLEAN, joined channels, polynomial spectral fit.

    Like the dense engine, the cubes live on device across the timed region
    (the caller's gridder hands over device-resident residuals,
    ``work_table`` device accessors) and a warm-up run is excluded; the best
    of ``repeats`` warm runs is reported.  The first perform compiles the
    fused minor loop (cached on disk for reruns)."""
    import jax
    import jax.numpy as jnp
    import radler_tpu as rd

    psfs, residual = make_diffuse_problem(size, n_channels)
    freqs = np.array(
        [[1.0e8 + c * 1e7, 1.1e8 + c * 1e7] for c in range(n_channels)]
    )
    psfs_dev = jnp.asarray(psfs)
    res_dev0 = jnp.asarray(residual)
    rms0 = float(jnp.sqrt(jnp.mean(res_dev0[0] ** 2)))

    def one_run():
        s = rd.Settings()
        s.trimmed_image_width = size
        s.trimmed_image_height = size
        s.algorithm_type = rd.AlgorithmType.MULTISCALE
        s.minor_iteration_count = n_iter
        s.minor_loop_gain = 0.1
        s.major_loop_gain = 0.85
        s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
        s.spectral_fitting.terms = 2
        resid = res_dev0 + 0.0  # fresh device buffer, no host round trip
        model = jnp.zeros_like(resid)
        r = rd.Radler(s, psfs_dev, resid, model, 0.0, frequencies=freqs)
        t0 = time.perf_counter()
        r.perform(0)
        out_res = r._table.front.residual_accessor.array  # ch-0 [H, W] plane
        jax.block_until_ready(out_res)
        dt = time.perf_counter() - t0
        rms1 = float(jnp.sqrt(jnp.mean(out_res**2)))
        print(
            f"[bench] multiscale {size}^2 x{n_channels}ch: "
            f"{r.iteration_number} iters in {dt:.1f}s, ch0 rms "
            f"{rms0:.4f}->{rms1:.4f}",
            file=sys.stderr,
        )
        return r.iteration_number, dt

    _, cold_dt = one_run()  # warm-up/compile
    best = min((one_run() for _ in range(repeats)),
               key=lambda r: r[1] / max(r[0], 1))
    return best[0], best[1], cold_dt


def run_iuwt(size: int, n_iter: int, repeats: int = 3):
    """Config 4: IUWT wavelet deconvolution (warm best-of-N, device-resident
    cubes — see run_multiscale)."""
    import jax
    import jax.numpy as jnp
    import radler_tpu as rd

    psfs, residual = make_diffuse_problem(size, 1)
    psf_dev = jnp.asarray(psfs[0])
    res_dev0 = jnp.asarray(residual[0])
    rms0 = float(jnp.sqrt(jnp.mean(res_dev0**2)))

    def one_run():
        s = rd.Settings()
        s.trimmed_image_width = size
        s.trimmed_image_height = size
        s.algorithm_type = rd.AlgorithmType.IUWT
        s.minor_iteration_count = n_iter
        s.major_loop_gain = 0.8
        resid = res_dev0 + 0.0
        model = jnp.zeros_like(resid)
        r = rd.Radler(s, psf_dev, resid, model, 0.0)
        t0 = time.perf_counter()
        r.perform(0)
        out_res = r._table.front.residual_accessor.array
        jax.block_until_ready(out_res)
        dt = time.perf_counter() - t0
        rms1 = float(jnp.sqrt(jnp.mean(out_res**2)))
        print(
            f"[bench] iuwt {size}^2: {r.iteration_number} iters in "
            f"{dt:.1f}s, rms {rms0:.4f}->{rms1:.4f}",
            file=sys.stderr,
        )
        return r.iteration_number, dt

    _, cold_dt = one_run()  # warm-up/compile
    best = min((one_run() for _ in range(repeats)),
               key=lambda r: r[1] / max(r[0], 1))
    return best[0], best[1], cold_dt


def run_numpy_baseline(psf, residual, n_iter: int, gain: float = 0.1):
    """Single-host NumPy Högbom core: argmax + PSF-patch subtract."""
    size = residual.shape[0]
    half = size // 2

    def one_run():
        res = residual.copy()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            idx = np.abs(res).argmax()
            y, x = divmod(idx, size)
            v = res[y, x] * gain
            y0, y1 = max(0, y - half), min(size, y + half)
            x0, x1 = max(0, x - half), min(size, x + half)
            py0, px0 = y0 - (y - half), x0 - (x - half)
            res[y0:y1, x0:x1] -= (
                v * psf[py0 : py0 + (y1 - y0), px0 : px0 + (x1 - x0)]
            )
        return time.perf_counter() - t0

    # Best-of-3, symmetric with the device measurement.
    dt = min(one_run() for _ in range(3))
    return n_iter, dt


def _emit(metric, ips, cpu_ips, cold_s=None, warm_s=None):
    record = {
        "metric": metric,
        "value": ips,
        "unit": "iterations/s",
        "vs_baseline": ips / cpu_ips if cpu_ips else None,
    }
    if cold_s is not None:
        # Cold (compiles included) against the best warm run.
        record["cold_s"] = cold_s
        record["warm_s"] = warm_s
    record.update(device_record())
    print(json.dumps(record), flush=True)
    return ips, cpu_ips


def _single_config(args):
    """One explicitly requested config (the pre-round-3 CLI)."""
    if args.engine in ("multiscale", "iuwt"):
        if args.engine == "multiscale":
            iters, dt, cold_dt = run_multiscale(
                args.size, args.channels, args.iters
            )
            if args.size == 2048 and args.channels == 8:
                cpu_ips = RECORDED_CPU_BASELINES["multiscale_2048x8"]
            else:
                from benchmarks.cpu_baselines import baseline_multiscale

                b_psfs, b_res = make_diffuse_problem(args.size, args.channels)
                b_iters, b_dt = baseline_multiscale(b_psfs, b_res, args.iters)
                cpu_ips = b_iters / b_dt if b_dt > 0 else 0.0
        else:
            iters, dt, cold_dt = run_iuwt(args.size, args.iters)
            cpu_ips = (
                RECORDED_CPU_BASELINES["iuwt_4096"]
                if args.size >= 4096
                else None
            )
        ips = iters / dt if dt > 0 else 0.0
        _emit(
            f"{args.engine}_minor_loop_iterations_per_s_{args.size}sq",
            ips,
            cpu_ips,
            cold_s=cold_dt,
            warm_s=dt,
        )
        return

    psf, residual = make_problem(args.size, args.sources)
    iters, dt = run_radler(psf, residual, args.iters, args.engine)
    ips = iters / dt if dt > 0 else 0.0
    b_iters, b_dt = run_numpy_baseline(psf, residual, args.baseline_iters)
    cpu_ips = b_iters / b_dt if b_dt > 0 else 0.0
    print(
        f"[bench] radler_tpu ({args.engine}): {iters} minor iterations in "
        f"{dt:.3f}s ({ips:.1f} it/s) at {args.size}^2",
        file=sys.stderr,
    )
    name = "hogbom" if args.engine == "dense" else args.engine
    _emit(f"{name}_minor_loop_iterations_per_s_{args.size}sq", ips, cpu_ips)


def _run_all(args):
    """Default invocation: one JSON metric line per BASELINE.json config
    (1-4).  Every config runs in its own child process, one after the
    other, so one process holds the GPU at a time and the parent never
    touches it.  Any failed config makes the run exit non-zero."""
    import subprocess

    configs = [
        ("hogbom", ["--engine", "dense", "--size", "4096"]),
        ("clark", ["--engine", "clark", "--size", "2048"]),
        (
            "multiscale",
            ["--engine", "multiscale", "--size", "2048", "--iters", "600"],
        ),
        ("iuwt", ["--engine", "iuwt", "--size", "4096", "--iters", "16"]),
    ]
    failed = []
    for name, argv in configs:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + argv,
            capture_output=True,
            text=True,
        )
        sys.stderr.write(proc.stderr[-2000:])
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        if proc.returncode != 0:
            print(
                f"[bench] {name} config exited {proc.returncode}",
                file=sys.stderr,
            )
            failed.append(name)
    if failed:
        raise SystemExit(f"[bench] failed configs: {', '.join(failed)}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--sources", type=int, default=300)
    parser.add_argument("--iters", type=int, default=5000)
    parser.add_argument("--baseline-iters", type=int, default=100)
    parser.add_argument(
        "--engine",
        choices=("all", "dense", "clark", "multiscale", "iuwt"),
        default="all",
    )
    parser.add_argument("--channels", type=int, default=8)
    args = parser.parse_args()

    if args.engine == "all":
        _run_all(args)
    else:
        _single_config(args)


if __name__ == "__main__":
    main()
