#!/usr/bin/env python
"""Config-5 proxy: a faceted IQUV joined-polarization clean on one device,
standing in for BASELINE.json config 5 (8192² × 64 ch × 4 Stokes, faceted,
multi-device).

Config 5 is a 64 GB cube — it only exists sharded over a mesh (see
``radler_tpu/parallel/mesh.py::dryrun_large_sharded`` for the sharded-
construction proof on 8 virtual devices).  What one device CAN run is the
per-device shard workload; this script measures exactly that: a joined-
polarization multi-channel multiscale clean with 2×2 facets through the
WorkTable API.

Reproduce: python benchmarks/config5_proxy.py [--size 4096 --channels 2]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POL_FLUX = (1.0, 0.3, -0.2, 0.1)  # I, Q, U, V plane scalings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument(
        "--algorithm",
        choices=("multiscale", "generic"),
        default="multiscale",
        help="config 5 is 'joined-polarization multi-frequency clean'; "
        "generic (Hogbom/Clark) is the canonical joined-pol clean and "
        "compiles a much smaller program",
    )
    ap.add_argument("--facets", type=int, default=2, help="grid width=height")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument(
        "--host-cubes",
        action="store_true",
        help="numpy accessors instead of device-resident cubes (every "
        "run then copies the cubes between host and device)",
    )
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument(
        "--mesh",
        action="store_true",
        help="run the minor loop as the mesh-partitioned program "
        "(parallel.use_device_mesh) — on one device this is the "
        "identical sharded program with degenerate collectives",
    )
    args = ap.parse_args()

    import jax  # noqa: F401  (the compile cache is wired by radler_tpu)

    import radler_tpu as rd
    from radler_tpu.work_table import (
        DeviceImageAccessor,
        WorkTable,
        WorkTableEntry,
    )
    from bench import make_diffuse_problem
    import jax.numpy as jnp

    C, size = args.channels, args.size
    pols = [
        rd.Polarization.STOKES_I,
        rd.Polarization.STOKES_Q,
        rd.Polarization.STOKES_U,
        rd.Polarization.STOKES_V,
    ]
    psfs, base = make_diffuse_problem(size, C)
    cube_gb = C * len(pols) * size * size * 4 / 1e9
    print(
        f"[config5-proxy] cube {C}ch x {len(pols)}pol x {size}^2 = "
        f"{cube_gb:.2f} GB, {args.facets}x{args.facets} facets",
        flush=True,
    )

    # Device-resident accessors: the caller's contract is device-memory
    # jax.Array buffers (the reference's equivalent is in-RAM caller
    # buffers); per-run numpy round trips would measure host-device copies,
    # not the framework.
    if args.host_cubes:
        from radler_tpu.work_table import (
            LoadAndStoreImageAccessor,
            LoadOnlyImageAccessor,
        )
    if args.host_cubes:
        psf_dev = base_dev = None
    else:
        psf_dev = [jnp.asarray(psfs[ch]) for ch in range(C)]
        base_dev = [
            [jnp.asarray(base[ch]) * POL_FLUX[i] for i in range(len(pols))]
            for ch in range(C)
        ]

    def one_run():
        residuals = []
        table = WorkTable([], C, C)
        for ch in range(C):
            for i, pol in enumerate(pols):
                if args.host_cubes:
                    res = (base[ch] * POL_FLUX[i]).astype(np.float32).copy()
                    mod = np.zeros_like(res)
                else:
                    res = base_dev[ch][i] + 0.0
                    mod = jnp.zeros_like(res)
                residuals.append(res)
                e = WorkTableEntry()
                e.polarization = pol
                e.original_channel_index = ch
                e.image_weight = 1.0
                e.band_start_frequency = 1.0e8 + ch * 1e7
                e.band_end_frequency = 1.1e8 + ch * 1e7
                if i == 0:
                    e.psf_accessors = (
                        [LoadOnlyImageAccessor(psfs[ch])]
                        if args.host_cubes
                        else [DeviceImageAccessor(psf_dev[ch])]
                    )
                if args.host_cubes:
                    e.residual_accessor = LoadAndStoreImageAccessor(res)
                    e.model_accessor = LoadAndStoreImageAccessor(mod)
                else:
                    e.residual_accessor = DeviceImageAccessor(res)
                    e.model_accessor = DeviceImageAccessor(mod)
                table.add_entry(e)

        s = rd.Settings()
        s.trimmed_image_width = size
        s.trimmed_image_height = size
        if args.algorithm == "multiscale":
            s.algorithm_type = rd.AlgorithmType.MULTISCALE
        else:
            s.algorithm_type = rd.AlgorithmType.GENERIC_CLEAN
            s.absolute_threshold = 5e-3
        s.minor_iteration_count = args.iters
        s.minor_loop_gain = 0.1
        s.major_loop_gain = 0.85
        s.squared_joins = True
        s.parallel.grid_width = args.facets
        s.parallel.grid_height = args.facets
        if args.mesh:
            s.parallel.use_device_mesh = True
            s.parallel.n_devices = len(jax.devices())
        s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
        s.spectral_fitting.terms = 2
        r = rd.Radler(s, table, beam_size=0.0)

        def total_iters():
            # Radler.iteration_number mirrors the reference
            # (FirstAlgorithm().IterationNumber(), radler.cc:406-408) which
            # is facet 0's count only; the throughput metric wants the SUM
            # over facet clones (each counts its own minor iterations, like
            # the reference's per-sub-image algorithms).
            algs = r._parallel.algorithms or [r._parallel.first_algorithm]
            return sum(a.iteration_number for a in algs)
        rms0_host = float(np.sqrt(np.mean(np.asarray(base[0]) ** 2)))
        rms0 = rms0_host
        t0 = time.perf_counter()
        r.perform(0)
        if args.host_cubes:
            dt = time.perf_counter() - t0
            rms1 = float(np.sqrt(np.mean(residuals[0] ** 2)))
            return total_iters(), dt, rms0_host, rms1
        out_res = table.front.residual_accessor.array
        jax.block_until_ready(out_res)
        dt = time.perf_counter() - t0
        rms1 = float(jnp.sqrt(jnp.mean(out_res**2)))
        return total_iters(), dt, rms0, rms1

    it, dt, rms0, rms1 = one_run()  # warm-up/compile
    print(f"[config5-proxy] cold: {it} iters in {dt:.1f}s", flush=True)
    best = min((one_run() for _ in range(args.repeats)), key=lambda r: r[1])
    it, dt, rms0, rms1 = best
    print(
        f"[config5-proxy] warm: {it} minor iters in {dt:.1f}s "
        f"({it / dt:.1f} it/s), I-rms {rms0:.4f}->{rms1:.4f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
