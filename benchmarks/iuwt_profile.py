"""Stage-level timing of the IUWT structure iteration at a given size.

Breaks the per-iteration cost of ``models/iuwt.py`` into its jitted
dispatches (structure_stats, select_structures, bbox, CG at the typical
box sizes, rms_guard, apply_structure_update) so optimization effort goes
where the time is.  Run on a GPU:

    python benchmarks/iuwt_profile.py --size 4096
"""

import argparse
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from radler_tpu.ops import iuwt as iuwt_ops
from radler_tpu.ops.convolution import convolve_same


def timeit(label, fn, n=5):
    jax.block_until_ready(fn())  # compile + drain
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    print(f"{label:42s} {best * 1e3:9.2f} ms", flush=True)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    H = W = args.size
    S = iuwt_ops.end_scale(min(H, W))
    print(f"size={H}x{W}  end_scale(max)={S}")

    rng = np.random.default_rng(7)
    dirty = jnp.asarray(rng.normal(size=(H, W)).astype(np.float32))
    psf = jnp.asarray(rng.normal(size=(H, W)).astype(np.float32) * 0.01)
    psf = psf.at[H // 2, W // 2].set(1.0)
    window = jnp.ones((H, W), bool)
    jax.block_until_ready((dirty, psf))

    # Early iterations use cur_end_scale=2..; profile both small and max.
    for n_scales in (2, 4, S):
        timeit(
            f"structure_stats (S={n_scales})",
            lambda ns=n_scales: iuwt_ops.structure_stats(
                dirty, window, ns, True
            ),
            args.reps,
        )

    coeffs, _ = iuwt_ops.structure_stats(dirty, window, S, True)
    thr = jnp.full((S,), 0.5, jnp.float32)
    mask, _ = iuwt_ops.select_structures(coeffs, thr, window, jnp.int32(0))
    jax.block_until_ready(mask)
    timeit(
        "select_structures",
        lambda: iuwt_ops.select_structures(coeffs, thr, window, jnp.int32(0)),
        args.reps,
    )
    timeit(
        "masked_recompose_bbox",
        lambda: iuwt_ops.masked_recompose_bbox(coeffs, mask, S),
        args.reps,
    )
    for box in (512, 1024, args.size):
        if box > args.size:
            continue
        S_box = iuwt_ops.end_scale(box)
        d = dirty[:box, :box]
        m = mask[:S_box, :box, :box]
        mds, md = iuwt_ops.masked_dirty_of(d, m, S_box)
        p = psf[:box, :box]
        jax.block_until_ready((mds, md))
        timeit(
            f"masked_dirty_of (box={box}, S={S_box})",
            lambda d=d, m=m, S_box=S_box: iuwt_ops.masked_dirty_of(
                d, m, S_box
            ),
            args.reps,
        )
        timeit(
            f"conjugate_gradient (box={box}, S={S_box})",
            lambda mds=mds, m=m, md=md, p=p, S_box=S_box: (
                iuwt_ops.conjugate_gradient(mds, m, md, p, S_box)
            ),
            args.reps,
        )
    model = jnp.zeros((H, W), jnp.float32)
    timeit(
        "rms_guard",
        lambda: iuwt_ops.rms_guard(dirty, model, psf, jnp.float32(0.2)),
        args.reps,
    )
    timeit(
        "convolve_same (full, 1 plane)",
        lambda: convolve_same(model, psf),
        args.reps,
    )


if __name__ == "__main__":
    main()
