#!/usr/bin/env python
"""Run radler_tpu's main path once on one NVIDIA GPU and check the results.

    python chip_smoke.py               # one card: phases 1-4 below
    python chip_smoke.py --four-cards  # four cards: the mesh path only

Every phase runs in this one process, so one JAX client holds the card.

1. Device: the first JAX device must be a GPU; the card's name and power
   limit (``nvidia-smi``) and the compile-cache directory are printed.
2. Main path, through ``Radler.perform`` on device-resident cubes:
   generic CLEAN with default settings at 2048² and 4096² over three major
   iterations (the caller re-predicts ``dirty - model ⊛ psf`` on the device
   between majors); dense Högbom at 4096² checked against a NumPy Högbom
   loop; multiscale 2048² × 8 channels and IUWT 4096² checked against their
   recorded end states; generic, multiscale, IUWT and ASP at 512² checked
   against the same runs on the CPU device.
3. The reference's point-source accuracy contract
   (``cpp/test/test_radler.cc:98-135``) for generic CLEAN, multiscale and
   ASP at 64².
4. Kernels: the one-program Clark kernel against the XLA loop at the
   generic phase's real candidate count, the batched-FFT accuracy probe,
   and the device's memory statistics.

Any failed check raises, and the script exits non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Recorded end states (residual rms before -> after) of the bench configs.
MULTISCALE_RMS = (3.9161, 1.6363)  # 2048² x 8 ch, ch0, 600 iterations
IUWT_RMS = (1.9199, 1.2374)  # 4096², 16 iterations
RMS_REL_TOL = 0.01

CARD = "?"


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card (a child
    process that does not use JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def rms(x) -> float:
    import jax.numpy as jnp

    return float(jnp.sqrt(jnp.mean(jnp.square(x))))


def within(value: float, recorded: float, rel: float = RMS_REL_TOL) -> bool:
    return abs(value - recorded) <= rel * abs(recorded)


# ---------------------------------------------------------------- helpers
def device_table(psfs, residual, model, frequencies=None):
    """A WorkTable whose entries hold ``[C, H, W]`` device cubes through
    ``DeviceImageAccessor`` (the caller keeps the accessors, so it can read
    the model and store a re-predicted residual between majors)."""
    import radler_tpu as rd
    from radler_tpu.work_table import DeviceImageAccessor

    table = rd.WorkTable([], psfs.shape[0], 0)
    for ch in range(psfs.shape[0]):
        entry = rd.WorkTableEntry()
        entry.original_channel_index = ch
        entry.image_weight = 1.0
        if frequencies is not None:
            entry.band_start_frequency = float(frequencies[ch][0])
            entry.band_end_frequency = float(frequencies[ch][1])
        entry.psf_accessors = [DeviceImageAccessor(psfs[ch])]
        entry.residual_accessor = DeviceImageAccessor(residual[ch])
        entry.model_accessor = DeviceImageAccessor(model[ch])
        table.add_entry(entry)
    return table


def channel_frequencies(n_channels: int) -> np.ndarray:
    return np.array(
        [[1.0e8 + c * 1e7, 1.1e8 + c * 1e7] for c in range(n_channels)]
    )


def timed_perform(r, major: int, sync):
    import jax

    t0 = time.perf_counter()
    more = r.perform(major)
    jax.block_until_ready(sync())
    return more, time.perf_counter() - t0


# ------------------------------------------------------------ phase 2
def generic_majors(size: int, n_majors: int = 3, n_sources: int = 300):
    """Generic CLEAN with default settings (Clark subminor on), each major
    at ``major_loop_gain = 0.85``; between majors the residual is formed on
    the device as ``dirty - model ⊛ psf``.  Returns per-major records."""
    import jax.numpy as jnp
    import bench
    import radler_tpu as rd
    from radler_tpu.ops.convolution import padded_convolve

    psf, dirty = bench.make_problem(size, n_sources)
    psf_d = jnp.asarray(psf)[None]
    dirty_d = jnp.asarray(dirty)[None]
    table = device_table(psf_d, dirty_d + 0.0, jnp.zeros_like(dirty_d))
    entry = table.entries[0]
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.minor_iteration_count = 1_000_000
    s.absolute_threshold = 0.001
    s.minor_loop_gain = 0.1
    s.major_loop_gain = 0.85
    r = rd.Radler(s, table, beam_size=0.0)
    peak0 = float(jnp.max(jnp.abs(dirty_d)))
    records = []
    it_before = 0
    for major in range(n_majors):
        more, dt = timed_perform(
            r, major, lambda: entry.residual_accessor.array
        )
        model = entry.model_accessor.array
        predicted = dirty_d[0] - padded_convolve(model, psf_d[0])
        drift = float(jnp.max(jnp.abs(predicted - entry.residual_accessor.array)))
        check(
            bool(jnp.all(jnp.isfinite(predicted)))
            and predicted.shape == (size, size),
            f"generic {size}²: non-finite or misshapen residual",
        )
        check(
            drift <= 1e-4 * peak0,
            f"generic {size}²: Radler's residual and dirty - model*psf differ"
            f" by {drift:.3g} (peak {peak0:.3g})",
        )
        entry.residual_accessor.store(predicted)
        records.append(
            {
                "major": major,
                "iterations": r.iteration_number - it_before,
                "seconds": dt,
                "rms": rms(predicted),
                "more": bool(more),
            }
        )
        it_before = r.iteration_number
        if not more:
            break
    check(records[0]["iterations"] > 0, f"generic {size}²: no iterations")
    check(
        records[-1]["rms"] < rms(dirty_d),
        f"generic {size}²: the residual rms did not drop",
    )
    return records


def numpy_hogbom(psf, residual, n_iter: int, gain: float = 0.1):
    """Plain NumPy Högbom loop: argmax of |residual|, subtract the PSF
    (centered at size//2, clipped at the edges) scaled by gain x peak."""
    res = residual.astype(np.float32).copy()
    model = np.zeros_like(res)
    size = res.shape[0]
    half = size // 2
    for _ in range(n_iter):
        idx = int(np.abs(res).argmax())
        y, x = divmod(idx, size)
        v = np.float32(res[y, x] * np.float32(gain))
        model[y, x] += v
        y0, y1 = max(0, y - half), min(size, y + half)
        x0, x1 = max(0, x - half), min(size, x + half)
        py0, px0 = y0 - (y - half), x0 - (x - half)
        res[y0:y1, x0:x1] -= v * psf[py0 : py0 + (y1 - y0), px0 : px0 + (x1 - x0)]
    return res, model


def dense_hogbom(size: int, n_check: int = 200, n_iter: int = 5000):
    """Dense Högbom (``use_sub_minor_optimization=False``): the first
    ``n_check`` iterations against :func:`numpy_hogbom` (same components,
    residual within 1e-5), then ``n_iter`` iterations timed."""
    import jax.numpy as jnp
    import bench
    import radler_tpu as rd

    psf, dirty = bench.make_problem(size, 300)

    def run(n):
        table = device_table(
            jnp.asarray(psf)[None],
            jnp.asarray(dirty)[None],
            jnp.zeros((1, size, size), jnp.float32),
        )
        entry = table.entries[0]
        s = rd.Settings()
        s.trimmed_image_width = s.trimmed_image_height = size
        s.minor_iteration_count = n
        s.absolute_threshold = 0.05
        s.minor_loop_gain = 0.1
        s.generic.use_sub_minor_optimization = False
        r = rd.Radler(s, table, beam_size=0.0)
        _, dt = timed_perform(r, 0, lambda: entry.residual_accessor.array)
        return (
            np.asarray(entry.residual_accessor.array),
            np.asarray(entry.model_accessor.array),
            r.iteration_number,
            dt,
        )

    res_d, mod_d, it_d, dt_check = run(n_check)
    res_n, mod_n = numpy_hogbom(psf, dirty, n_check)
    check(it_d == n_check, f"dense {size}²: {it_d} iterations, not {n_check}")
    same = np.array_equal(mod_d != 0, mod_n != 0)
    res_err = float(np.abs(res_d - res_n).max())
    mod_err = float(np.abs(mod_d - mod_n).max())
    check(same, f"dense {size}²: component positions differ from NumPy")
    check(res_err <= 1e-5, f"dense {size}²: residual differs by {res_err:.3g}")
    check(mod_err <= 1e-5, f"dense {size}²: model differs by {mod_err:.3g}")
    _, _, it, dt = run(n_iter)
    return {
        "numpy_check_iterations": n_check,
        "max_residual_diff": res_err,
        "max_model_diff": mod_err,
        "iterations": it,
        "seconds": dt,
        "iterations_per_s": it / dt,
    }


def multiscale(size: int, n_channels: int, n_iter: int, device=None):
    """The bench multiscale config (joined channels, 2-term polynomial
    fit, ``major_loop_gain = 0.85``).  Returns (iterations, seconds, ch0 rms
    before, ch0 rms after)."""
    import jax
    import jax.numpy as jnp
    import bench
    import radler_tpu as rd

    psfs, residual = bench.make_diffuse_problem(size, n_channels)
    put = (lambda a: jax.device_put(a, device)) if device else jnp.asarray
    psfs_d, res_d = put(psfs), put(residual)
    table = device_table(
        psfs_d, res_d, jnp.zeros_like(res_d), channel_frequencies(n_channels)
    )
    entry = table.entries[0]
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = rd.AlgorithmType.MULTISCALE
    s.minor_iteration_count = n_iter
    s.minor_loop_gain = 0.1
    s.major_loop_gain = 0.85
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    r = rd.Radler(s, table, beam_size=0.0)
    rms0 = rms(res_d[0])
    _, dt = timed_perform(r, 0, lambda: entry.residual_accessor.array)
    out = entry.residual_accessor.array
    check(bool(jnp.all(jnp.isfinite(out))), "multiscale: non-finite residual")
    return r.iteration_number, dt, rms0, rms(out)


def iuwt(size: int, n_iter: int, device=None):
    """The bench IUWT config.  Returns (iterations, seconds, rms before,
    rms after)."""
    import jax
    import jax.numpy as jnp
    import bench
    import radler_tpu as rd

    psfs, residual = bench.make_diffuse_problem(size, 1)
    put = (lambda a: jax.device_put(a, device)) if device else jnp.asarray
    psf_d, res_d = put(psfs), put(residual)
    table = device_table(psf_d, res_d, jnp.zeros_like(res_d))
    entry = table.entries[0]
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = rd.AlgorithmType.IUWT
    s.minor_iteration_count = n_iter
    s.major_loop_gain = 0.8
    r = rd.Radler(s, table, beam_size=0.0)
    rms0 = rms(res_d[0])
    _, dt = timed_perform(r, 0, lambda: entry.residual_accessor.array)
    out = entry.residual_accessor.array
    check(bool(jnp.all(jnp.isfinite(out))), "iuwt: non-finite residual")
    return r.iteration_number, dt, rms0, rms(out)


def point_sources(size: int, algorithm, device=None, n_iter: int = 300):
    """Generic CLEAN (Clark subminor) or ASP on the bench point-source
    field.  Returns (iterations, rms after)."""
    import jax
    import jax.numpy as jnp
    import bench
    import radler_tpu as rd

    psf, dirty = bench.make_problem(size, max(4, size // 64))
    put = (lambda a: jax.device_put(a, device)) if device else jnp.asarray
    psf_d, res_d = put(psf[None]), put(dirty[None])
    table = device_table(psf_d, res_d, jnp.zeros_like(res_d))
    entry = table.entries[0]
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = algorithm
    s.minor_iteration_count = n_iter
    s.absolute_threshold = 1e-3
    r = rd.Radler(s, table, beam_size=0.0)
    r.perform(0)
    out = entry.residual_accessor.array
    check(bool(jnp.all(jnp.isfinite(out))), f"{algorithm.name}: non-finite")
    return r.iteration_number, rms(out)


def gpu_against_cpu(size: int = 512, ms_channels: int = 4):
    """Each algorithm on the default device and on the CPU device: the same
    iteration count and end-state rms within 1e-4 relative."""
    import jax
    import radler_tpu as rd

    cpu = jax.devices("cpu")[0]
    runs = {
        "generic": lambda dev: point_sources(
            size, rd.AlgorithmType.GENERIC_CLEAN, dev
        ),
        "asp": lambda dev: point_sources(
            size, rd.AlgorithmType.ADAPTIVE_SCALE_PIXEL, dev, n_iter=40
        ),
        "multiscale": lambda dev: multiscale(size, ms_channels, 150, dev)[
            ::3
        ],
        "iuwt": lambda dev: iuwt(size, 6, dev)[::3],
    }
    out = {}
    for name, run in runs.items():
        it_g, rms_g = run(None)
        with jax.default_device(cpu):
            it_c, rms_c = run(cpu)
        rel = abs(rms_g - rms_c) / max(abs(rms_c), 1e-30)
        out[name] = {
            "iterations": [it_g, it_c],
            "rms": [rms_g, rms_c],
            "rel_diff": rel,
        }
        check(it_g == it_c, f"{name} {size}²: {it_g} iterations vs {it_c} on CPU")
        check(rel <= 1e-4, f"{name} {size}²: rms differs by {rel:.3g} from CPU")
    return out


# ------------------------------------------------------------ phase 3
def point_source_contract(algorithm, size: int = 64):
    """The reference's point-source contract: residual |.| < 2e-6 anywhere,
    model peak within 1e-4 (rel) of the 2.5 Jy source, nothing else above
    2e-6 (``cpp/test/test_radler.cc:98-135``)."""
    import radler_tpu as rd

    ps = np.array([[0.0, 0.4, 0.0], [0.25, 1.0, 0.5], [0.0, 0.6, 0.0]], np.float32)
    c = size // 2
    psf = np.zeros((size, size), np.float32)
    psf[c - 1 : c + 2, c - 1 : c + 2] = ps
    cy, cx = c + 15, c - 9
    res = np.zeros((size, size), np.float32)
    res[cy - 1 : cy + 2, cx - 1 : cx + 2] = 2.5 * ps
    mdl = np.zeros_like(res)
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = size
    s.algorithm_type = algorithm
    s.minor_iteration_count = 1000
    s.absolute_threshold = (
        1e-6 if algorithm == rd.AlgorithmType.ADAPTIVE_SCALE_PIXEL else 1e-7
    )
    r = rd.Radler(s, psf, res, mdl, 0.0)
    for major in range(10):
        if not r.perform(major):
            break
    peak = float(mdl[cy, cx])
    off = mdl.copy()
    off[cy, cx] = 0.0
    rec = {
        "residual_max": float(np.abs(res).max()),
        "model_peak": peak,
        "stray": float(np.abs(off).max()),
        "iterations": r.iteration_number,
    }
    check(
        rec["residual_max"] < 2e-6
        and abs(peak - 2.5) < 2.5e-4
        and rec["stray"] < 2e-6,
        f"{algorithm.name} point-source contract: {rec}",
    )
    return rec


# ------------------------------------------------------------ phase 4
def clark_kernel_against_xla(
    size: int, major_loop_gain: float = 0.85, n_sources: int = 300
):
    """The one-program Clark kernel against the XLA loop (at HIGHEST
    matmul precision) on the candidates of a generic CLEAN first major at
    ``size`` (threshold ``max(0.05, (1 - major_loop_gain) x peak)``): the
    same iteration count and components, residual and model within 1e-5 x
    the initial peak."""
    import jax
    import jax.numpy as jnp
    import bench
    from radler_tpu.image_set import CubeMeta
    from radler_tpu.models.subminor import SubMinorLoop

    psf, dirty = bench.make_problem(size, n_sources)
    psfs = jnp.asarray(psf)[None]
    threshold = max(0.05, (1.0 - major_loop_gain) * float(np.abs(dirty).max()))
    meta = CubeMeta(1, 1, (1.0,), (True,), 1.0, False, (0.0,))

    def run(use_kernel):
        loop = SubMinorLoop(size, size, 2 * size, 2 * size, use_kernel=use_kernel)
        loop.set_threshold(threshold, threshold)
        loop.set_iteration_info(0, 1_000_000)
        loop.set_gain(0.1)
        count = loop.find_peak_positions(jnp.asarray(dirty)[None], meta)
        start = loop._residual_k
        gate = SubMinorLoop(size, size, 2 * size, 2 * size)
        gate.set_gain(0.1)
        gate._xs, gate._residual_k = loop._xs, start
        gate._est_logsum = loop._est_logsum
        times = []
        for _ in range(2):  # the first call compiles
            loop._residual_k = start
            loop.current_iteration = 0
            t0 = time.perf_counter()
            loop.run(jnp.asarray(dirty)[None], meta, psfs)
            jax.block_until_ready(loop._model_k)
            times.append(time.perf_counter() - t0)
        return loop, count, times[-1], gate.fused_qualifies(1)

    with jax.default_matmul_precision("highest"):
        xla, count, t_xla, gate_pick = run(False)
    ker, _, t_ker, _ = run(True)
    peak0 = float(np.abs(dirty).max())
    it_x, it_k = xla.current_iteration, ker.current_iteration
    res_err = float(jnp.max(jnp.abs(xla._residual_k - ker._residual_k)))
    mod_err = float(jnp.max(jnp.abs(xla._model_k - ker._model_k)))
    same = bool(jnp.all((xla._model_k != 0) == (ker._model_k != 0)))
    rec = {
        "candidates": count,
        "capacity": int(xla._xs.shape[0]),
        "iterations": [it_x, it_k],
        "xla_us_per_iteration": 1e6 * t_xla / max(it_x, 1),
        "kernel_us_per_iteration": 1e6 * t_ker / max(it_k, 1),
        "residual_diff_over_peak": res_err / peak0,
        "model_diff_over_peak": mod_err / peak0,
        "gate_picks_kernel": bool(gate_pick),
    }
    check(it_x == it_k, f"Clark kernel: {it_k} iterations vs {it_x} (XLA)")
    check(same, "Clark kernel: components differ from the XLA loop")
    check(res_err <= 1e-5 * peak0, f"Clark kernel: residual differs: {rec}")
    check(mod_err <= 1e-5 * peak0, f"Clark kernel: model differs: {rec}")
    return rec


def batched_fft_probe():
    from radler_tpu.ops.convolution import probe_batched_fft_accuracy

    rec = probe_batched_fft_accuracy(n=8, size=2048)
    check(
        rec["forward_rel_err"] <= 1e-5 and rec["inverse_rel_err"] <= 1e-5,
        f"batched FFT differs from per-plane FFT: {rec}",
    )
    return rec


# --------------------------------------------------------- four cards
def mesh_against_one_card(size: int, n_channels: int, n_devices: int = 4):
    """The mesh path on ``n_devices`` cards against the same run on
    ``jax.devices()[:1]``: the XLA-partitioned Högbom loop, the sharded
    Clark subminor and the partitioned fused multiscale loop.  Tolerances
    are those of tests/test_mesh_clean.py (2e-6) and
    tests/test_mesh_multiscale.py (2e-5), relative to the field's peak."""
    import bench
    import radler_tpu as rd

    psf, base = bench.make_problem(size, 300)
    psfs = np.stack([psf] * n_channels)
    point = np.stack([base * (1.0 - 0.05 * c) for c in range(n_channels)])
    d_psfs, diffuse = bench.make_diffuse_problem(size, n_channels)
    freqs = channel_frequencies(n_channels)

    def run(kind, n_dev):
        s = rd.Settings()
        s.trimmed_image_width = s.trimmed_image_height = size
        s.parallel.use_device_mesh = True
        s.parallel.n_devices = n_dev
        if kind == "multiscale":
            s.algorithm_type = rd.AlgorithmType.MULTISCALE
            s.minor_iteration_count = 600
            s.major_loop_gain = 0.85
            s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
            s.spectral_fitting.terms = 2
            p, res = d_psfs, diffuse.copy()
        else:
            s.minor_iteration_count = 2000
            s.absolute_threshold = 0.05
            s.major_loop_gain = 0.85
            s.generic.use_sub_minor_optimization = kind == "clark"
            p, res = psfs, point.copy()
        mdl = np.zeros_like(res)
        r = rd.Radler(s, p, res, mdl, 0.0, frequencies=freqs)
        t0 = time.perf_counter()
        r.perform(0)
        return res, mdl, r.iteration_number, time.perf_counter() - t0

    out = {}
    for kind, tol, field in (
        ("hogbom", 2e-6, point),
        ("clark", 2e-6, point),
        ("multiscale", 2e-5, diffuse),
    ):
        res_m, mdl_m, it_m, dt_m = run(kind, n_devices)
        res_1, mdl_1, it_1, dt_1 = run(kind, 1)
        peak = float(np.abs(field).max())
        res_err = float(np.abs(res_m - res_1).max())
        mdl_err = float(np.abs(mdl_m - mdl_1).max())
        out[kind] = {
            "iterations": [it_m, it_1],
            "seconds": [dt_m, dt_1],
            "residual_diff": res_err,
            "model_diff": mdl_err,
            "tolerance": tol * peak,
        }
        log(f"mesh {kind} {size}² x {n_channels}: {out[kind]}")
        check(it_m > 0 and it_m == it_1, f"mesh {kind}: iterations {it_m} vs {it_1}")
        check(res_err <= tol * peak, f"mesh {kind}: residual differs {res_err:.3g}")
        check(mdl_err <= tol * peak, f"mesh {kind}: model differs {mdl_err:.3g}")
    return out


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the mesh path on four cards against one card",
    )
    args = parser.parse_args(argv)

    import jax

    import bench  # noqa: F401  (fails here, before any output, outside the repo)
    import radler_tpu

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: needs a GPU, found {devices[0].platform}",
            file=sys.stderr,
        )
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs", file=sys.stderr)
        return 2

    # Phase 1: device.
    card = card_line()
    CARD = card
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or (
        jax.config.jax_compilation_cache_dir
    )
    print(card, flush=True)
    log(
        f"device_kind={devices[0].device_kind} count={len(devices)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache} (package default {radler_tpu.COMPILE_CACHE_DIR})"
    )

    if args.four_cards:
        mesh_against_one_card(2048, 8, n_devices=4)
        used = 4
    else:
        # Phase 2: main path.
        for size in (2048, 4096):
            for rec in generic_majors(size):
                log(f"generic {size}² (Clark, default settings): {rec}")
        log(f"dense Högbom 4096²: {dense_hogbom(4096)}")
        it, dt, rms0, rms1 = multiscale(2048, 8, 600)
        log(
            f"multiscale 2048² x 8 ch: {it} iterations in {dt:.3f} s "
            f"(compile included), ch0 rms {rms0:.4f} -> {rms1:.4f}, "
            f"recorded {MULTISCALE_RMS[0]} -> {MULTISCALE_RMS[1]}"
        )
        check(
            within(rms0, MULTISCALE_RMS[0]) and within(rms1, MULTISCALE_RMS[1]),
            "multiscale: end state differs from the recorded rms by > 1%",
        )
        it, dt, rms0, rms1 = multiscale(2048, 8, 600)
        log(f"multiscale 2048² x 8 ch warm: {it} iterations in {dt:.3f} s")
        it, dt, rms0, rms1 = iuwt(4096, 16)
        log(
            f"IUWT 4096²: {it} iterations in {dt:.3f} s (compile included), "
            f"rms {rms0:.4f} -> {rms1:.4f}, "
            f"recorded {IUWT_RMS[0]} -> {IUWT_RMS[1]}"
        )
        check(
            within(rms0, IUWT_RMS[0]) and within(rms1, IUWT_RMS[1]),
            "iuwt: end state differs from the recorded rms by > 1%",
        )
        it, dt, _, _ = iuwt(4096, 16)
        log(f"IUWT 4096² warm: {it} iterations in {dt:.3f} s")
        log(f"GPU against the CPU device at 512²: {gpu_against_cpu(512)}")

        # Phase 3: accuracy contract.
        for algorithm in (
            radler_tpu.AlgorithmType.GENERIC_CLEAN,
            radler_tpu.AlgorithmType.MULTISCALE,
            radler_tpu.AlgorithmType.ADAPTIVE_SCALE_PIXEL,
        ):
            log(f"{algorithm.name} 64² contract: {point_source_contract(algorithm)}")

        # Phase 4: kernels.
        for gain in (0.85, 1.0):
            log(
                f"Clark kernel vs XLA loop 2048², major_loop_gain {gain}: "
                f"{clark_kernel_against_xla(2048, gain)}"
            )
        log(f"batched FFT probe [8, 2048, 2048]: {batched_fft_probe()}")
        used = 1
    for i, dev in enumerate(devices[:used]):
        stats = dev.memory_stats() or {}
        log(
            f"device {i} memory: peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use')} bytes_limit="
            f"{stats.get('bytes_limit')}"
        )
    print(card, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": used,
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
