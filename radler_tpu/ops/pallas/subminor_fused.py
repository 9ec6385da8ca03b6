"""Clark subminor loop as one Pallas program (Triton route, for Hopper).

The XLA version of the loop (``models.subminor._subminor_while``) runs
several small kernels per ``lax.while_loop`` step, and the loop predicate
goes back to the host once per step; at the candidate counts CLEAN sees
the arithmetic is a few hundred kilobytes, so that fixed cost is the whole
iteration.  Here the loop runs inside ONE program (grid ``(1,)``): the
``[N, K]`` candidate residual and model, the rms and validity vectors stay
in the program's own buffers (a few hundred kB, resident in L2), and each
iteration

1. reads the component's per-image values at candidate ``m``,
2. applies the (optional) polynomial spectral fit and the gain,
3. subtracts row ``m`` of the PSF interaction matrix
   ``mat[c, m, j] = psf[c, ys[j]-ys[m]+H/2, xs[j]-xs[m]+W/2]`` (positions
   are fixed for a run, so the pairwise response table is built once),
4. and, in the same pass over the candidates, integrates the images and
   keeps a per-lane running argmax; one block reduction per iteration picks
   the winner (the largest value, then the lowest index at that value —
   ``jnp.argmax``'s tie rule).

Reference semantics: ``cpp/algorithms/subminor_loop.cc:38-117`` (the loop),
``:13-36`` (integrated argmax over the set), ``:91-105`` (PSF values at the
candidate offsets).  The kernel does no matrix product; only the order of
the sums in the joined integration differs from the XLA loop.

Spectral fitting: NO_FITTING and POLYNOMIAL (a constant ``[C, C]``
projection per polarization, ``ops/spectral_fitting.py``) run in-kernel;
other modes stay on the XLA loop.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton



def _chunking(k: int) -> Tuple[int, int]:
    """(lanes per chunk, warps) of the in-kernel pass over ``k`` candidates:
    a power of two, as Triton's block shapes must be, with 8 lanes per
    thread.  Measured on an H100 80GB HBM3: at 16k candidates 4096 lanes
    over 16 warps ran 4.5 us per iteration (2048/8: 5.4 us, 8192/32:
    5.3 us); at 64k, 8192 lanes over 32 warps ran 11.5 us (4096/16:
    19.7 us, 1024/4: 42.7 us)."""
    block = min(k, 8192 if k >= 65536 else 4096)
    return block, max(4, block // 256)


def padded_capacity(k: int) -> int:
    """Candidate capacity the kernel runs at: the next power of two."""
    return max(16, 1 << (int(k) - 1).bit_length())


@partial(jax.jit, static_argnames=("height", "width", "chunk"))
def build_interaction_matrix(
    psfs: jnp.ndarray,  # [C, H, W]
    xs: jnp.ndarray,  # [K]
    ys: jnp.ndarray,  # [K]
    valid: jnp.ndarray,  # [K] bool
    *,
    height: int,
    width: int,
    chunk: int = 512,
) -> jnp.ndarray:
    """``mat[c, m, j] = psf[c, ys[j]-ys[m]+H/2, xs[j]-xs[m]+W/2]`` with
    out-of-bounds and invalid-j entries zeroed — the table of PSF responses
    at every candidate j from a component at candidate m
    (``subminor_loop.cc:91-105`` hoisted out of the loop).  Row m is
    contiguous so the kernel reads one row per iteration.

    Built in m-chunks via ``lax.map`` over a flat 1-D take, so the
    ``[chunk, K]`` index and mask planes are the only intermediates and the
    full ``[K, K]`` index planes are never materialized."""
    k = xs.shape[0]
    psf_flat = psfs.reshape(psfs.shape[0], height * width)  # [C, H*W]

    def one_chunk(args):
        ys_m, xs_m = args  # [chunk]
        dy = ys[None, :] - ys_m[:, None] + height // 2  # [chunk, K(j)]
        dx = xs[None, :] - xs_m[:, None] + width // 2
        inb = (dy >= 0) & (dy < height) & (dx >= 0) & (dx < width)
        inb &= valid[None, :]
        lin = jnp.clip(dy, 0, height - 1) * width + jnp.clip(
            dx, 0, width - 1
        )
        vals = jnp.take(psf_flat, lin.reshape(-1), axis=1)
        vals = vals.reshape(psfs.shape[0], dy.shape[0], k)
        return jnp.where(inb[None], vals, 0.0)  # [C, chunk, K]

    if k <= chunk:
        return one_chunk((ys, xs))
    while k % chunk != 0:
        chunk //= 2
    n_chunks = k // chunk
    out = jax.lax.map(
        one_chunk,
        (ys.reshape(n_chunks, chunk), xs.reshape(n_chunks, chunk)),
    )  # [n_chunks, C, chunk, K]
    return jnp.transpose(out, (1, 0, 2, 3)).reshape(psfs.shape[0], k, k)


def _loop_kernel(
    scal_f_ref,  # [4] f32: threshold, gain, divergence_limit, (unused)
    scal_i_ref,  # [2] i32: start_iteration, max_iterations
    res_in,  # [N, K]
    mod_in,  # [N, K]
    rms_ref,  # [K]
    pen_ref,  # [K]: 0 where valid, -inf elsewhere
    mat_ref,  # [C, K, K] interaction matrix
    res_ref,  # out [N, K]
    mod_ref,  # out [N, K]
    it_out,  # out [1] i32
    max_out,  # out [1] f32
    div_out,  # out [1] i32
    *,
    coef: Tuple[float, ...],
    proj: Optional[Tuple[Tuple[float, ...], ...]],
    n_channels: int,
    n_polarizations: int,
    k: int,
    block: int,
    allow_negative: bool,
    stop_on_negative: bool,
    use_rms: bool,
):
    n_images = n_channels * n_polarizations
    n_chunks = k // block
    threshold = scal_f_ref[0]
    gain = scal_f_ref[1]
    div_limit = scal_f_ref[2]
    start_it = scal_i_ref[0]
    max_it = scal_i_ref[1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
    big = jnp.int32(2**30)

    # Every access to the state is a [block] slice with the same layout, so
    # each element is stored and re-read by the same thread.
    def copy_chunk(j, carry):
        sl = pl.ds(pl.multiple_of(j * block, block), block)
        for i in range(n_images):
            res_ref[i, sl] = res_in[i, sl]
            mod_ref[i, sl] = mod_in[i, sl]
        return carry

    jax.lax.fori_loop(0, n_chunks, copy_chunk, 0)

    def scan_candidates(m, cvs):
        """One pass over the candidates: subtract ``cvs`` x row m of the
        interaction matrix (skipped when ``cvs`` is None), integrate, and
        return the masked argmax ``(index, integrated value)``
        (``SubMinorModel::GetMaxComponent``, subminor_loop.cc:13-36)."""

        def chunk(j, best):
            best_v, best_i, best_s = best
            off = pl.multiple_of(j * block, block)
            sl = pl.ds(off, block)
            s = None
            for i in range(n_images):
                r = res_ref[i, sl]
                if cvs is not None:
                    ch = i // n_polarizations
                    r = r - mat_ref[ch, m, sl] * cvs[i]
                    res_ref[i, sl] = r
                t = r * np.float32(coef[i])
                s = t if s is None else s + t
            if use_rms:
                s = s * rms_ref[sl]
            v = jnp.abs(s) if allow_negative else s
            vm = v + pen_ref[sl]
            take = (vm > best_v) | (j == 0)
            return (
                jnp.where(take, vm, best_v),
                jnp.where(take, lane + off, best_i),
                jnp.where(take, s, best_s),
            )

        init = (
            jnp.full((block,), -jnp.inf, jnp.float32),
            lane,
            jnp.zeros((block,), jnp.float32),
        )
        best_v, best_i, best_s = jax.lax.fori_loop(0, n_chunks, chunk, init)
        mx = jnp.max(best_v)
        idx = jnp.min(jnp.where(best_v == mx, best_i, big))
        val = jnp.sum(jnp.where(best_i == idx, best_s, 0.0))
        return idx, val

    m0, v0 = scan_candidates(jnp.int32(0), None)
    max_at_start = jnp.abs(v0)

    def cond(carry):
        it, _m, val, div = carry
        ok = (jnp.abs(val) > threshold) & (it < max_it) & jnp.logical_not(div)
        if stop_on_negative:
            ok &= val >= 0.0
        return ok

    def body(carry):
        it, m, _val, _div = carry
        base = pl.multiple_of((m // block) * block, block)
        sl = pl.ds(base, block)
        onehot = lane + base == m
        # Component values: residual at m, gain-scaled
        # (subminor_loop.cc:75-83).
        cvs = [
            jnp.sum(jnp.where(onehot, res_ref[i, sl], 0.0)) * gain
            for i in range(n_images)
        ]
        if proj is not None:
            # Polynomial spectral fit: a constant [C, C] projection applied
            # per polarization (deconvolution_algorithm.cc:29-46).
            fitted = []
            for c in range(n_channels):
                for p in range(n_polarizations):
                    acc = None
                    for c2 in range(n_channels):
                        term = np.float32(proj[c][c2]) * cvs[
                            c2 * n_polarizations + p
                        ]
                        acc = term if acc is None else acc + term
                    fitted.append(acc)
            cvs = fitted
        for i in range(n_images):
            mod_ref[i, sl] = mod_ref[i, sl] + jnp.where(onehot, cvs[i], 0.0)
        m2, v2 = scan_candidates(m, cvs)
        div = (div_limit != 0.0) & (jnp.abs(v2) > max_at_start * div_limit)
        return it + 1, m2, v2, div

    it, _m, val, div = jax.lax.while_loop(
        cond, body, (start_it, m0, v0, jnp.bool_(False))
    )
    it_out[0] = it
    max_out[0] = val
    div_out[0] = div.astype(jnp.int32)


@partial(
    jax.jit,
    static_argnames=(
        "coef",
        "proj",
        "n_channels",
        "n_polarizations",
        "allow_negative",
        "stop_on_negative",
        "use_rms",
        "interpret",
    ),
)
def subminor_loop_fused(
    residual_k: jnp.ndarray,  # [N, K]
    model_k: jnp.ndarray,  # [N, K]
    rms_k: jnp.ndarray,  # [K]
    valid: jnp.ndarray,  # [K] bool
    matrix: jnp.ndarray,  # [C, K, K] interaction matrix (row m contiguous)
    threshold: jnp.ndarray,
    gain: jnp.ndarray,
    start_iteration: jnp.ndarray,
    max_iterations: jnp.ndarray,
    divergence_limit: jnp.ndarray,
    *,
    coef: Tuple[float, ...],
    proj: Optional[Tuple[Tuple[float, ...], ...]],
    n_channels: int,
    n_polarizations: int,
    allow_negative: bool,
    stop_on_negative: bool,
    use_rms: bool,
    interpret: bool = False,
):
    """Run the whole subminor while-loop in one Pallas program.

    ``K`` must be a power of two (:func:`padded_capacity`; padding
    candidates carry ``valid=False``).  Returns ``(res_k, mod_k, iteration,
    max_value, diverging)`` with the contract of
    ``models.subminor._subminor_while``.
    """
    n, k = residual_k.shape
    assert k == padded_capacity(k), k
    block, num_warps = _chunking(k)
    pen = jnp.where(valid, 0.0, -jnp.inf).astype(jnp.float32)
    scal_f = jnp.stack(
        [
            threshold.astype(jnp.float32),
            gain.astype(jnp.float32),
            divergence_limit.astype(jnp.float32),
            jnp.float32(0.0),
        ]
    )
    scal_i = jnp.stack(
        [start_iteration.astype(jnp.int32), max_iterations.astype(jnp.int32)]
    )
    kernel = partial(
        _loop_kernel,
        coef=coef,
        proj=proj,
        n_channels=n_channels,
        n_polarizations=n_polarizations,
        k=k,
        block=block,
        allow_negative=allow_negative,
        stop_on_negative=stop_on_negative,
        use_rms=use_rms,
    )
    res_out, mod_out, it, max_val, div = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((n, k), jnp.float32),
            jax.ShapeDtypeStruct((n, k), jnp.float32),
            jax.ShapeDtypeStruct((1,), jnp.int32),
            jax.ShapeDtypeStruct((1,), jnp.float32),
            jax.ShapeDtypeStruct((1,), jnp.int32),
        ],
        grid=(1,),
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="clark_subminor_loop",
    )(
        scal_f,
        scal_i,
        residual_k.astype(jnp.float32),
        model_k.astype(jnp.float32),
        rms_k.astype(jnp.float32),
        pen,
        matrix.astype(jnp.float32),
    )
    return res_out, mod_out, it[0], max_val[0], div[0].astype(jnp.bool_)
