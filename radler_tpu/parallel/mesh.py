"""Device-mesh sharding for the deconvolution state.

JAX replacement for the reference's thread pool (SURVEY.md §2.2): the image
cube ``[n_chan, n_pol, H, W]`` is laid out over a
``Mesh(("chan", "tile"))`` — frequency channels across the ``chan`` axis
(batch-like data parallelism) and image rows across the ``tile`` axis
(spatial/facet parallelism).  The four cross-worker exchanges of the
reference (global peak max-reduce, threshold broadcast, boundary-masked
merge, mask union — ``parallel_deconvolution.cc:592-617``) all become XLA
collectives inserted automatically from sharding annotations (NCCL between
GPUs), and only the scalar major-loop decisions touch the host.  The mesh is
a plain reshape of the device list: every device reaches every other at the
same rate, so its shape follows the algorithm alone.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None, n_channels: Optional[int] = None
) -> Mesh:
    """Build a ("chan", "tile") mesh over the available devices.

    The layout is channel-major: the "chan" axis takes the largest device
    factor that divides the cube's channel count.  Channel sharding keeps
    every 2-D FFT (the dominant cost of the multiscale/IUWT paths) fully
    local to a device, whereas row sharding forces an all-to-all transpose
    inside each transform — so spatial tiling only receives the devices the
    channel count cannot use (e.g. 64 channels on 8 devices -> chan=8;
    2 channels on 8 devices -> chan=2, tile=4).  When the channel count is
    unknown, a conservative factor of <=4 rides "chan" so shardings stay
    valid for any problem shape.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    chan = 1
    if n_channels is not None:
        chan = max(
            (
                d
                for d in range(1, n + 1)
                if n % d == 0 and n_channels % d == 0
            ),
            default=1,
        )
    else:
        for candidate in (4, 2):
            if n % candidate == 0 and n // candidate > 1:
                chan = candidate
                break
    tile = n // chan
    mesh_devices = np.asarray(devices).reshape(chan, tile)
    return Mesh(mesh_devices, ("chan", "tile"))


def cube_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of a ``[n_chan, n_pol, H, W]`` cube: channels over "chan",
    image rows over "tile"."""
    return NamedSharding(mesh, P("chan", None, "tile", None))


def image_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of a ``[H, W]`` integrated image: rows over "tile"."""
    return NamedSharding(mesh, P("tile", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


@partial(jax.jit, donate_argnums=(0, 1))
def sharded_clean_step(
    residual: jnp.ndarray,  # [C, P, H, W] sharded (chan, -, tile, -)
    model: jnp.ndarray,  # [C, P, H, W] same sharding
    psfs: jnp.ndarray,  # [C, H, W] sharded (chan, -, -)
    chan_weights: jnp.ndarray,  # [C] replicated
    gain: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One fully-sharded Högbom step: joined integrate → global argmax →
    spectrally-independent component subtraction.

    The channel/polarization reduction becomes a ``psum`` over the "chan"
    mesh axis, the argmax a max-reduce over "tile" — both inserted by XLA
    from the sharding annotations.  Returns (residual, model, peak_value).
    """
    C, Pp, H, W = residual.shape
    # Joined peak finding: sqrt of the weighted sum of squares over pols,
    # weighted mean over channels (cf. image_set.cc:309-421).
    sq = jnp.einsum("c,cphw->hw", chan_weights, residual * residual)
    integrated = jnp.sqrt(jnp.maximum(sq, 0.0))
    flat_idx = jnp.argmax(integrated.reshape(-1))
    y = (flat_idx // W).astype(jnp.int32)
    x = (flat_idx % W).astype(jnp.int32)
    values = residual[:, :, y, x] * gain  # [C, P]
    model = model.at[:, :, y, x].add(values)
    # Shifted-PSF subtraction with wrap clipping (ops/psf_subtract.py).
    dy = y - H // 2
    dx = x - W // 2
    shifted = jnp.roll(psfs, (dy, dx), axis=(-2, -1))
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    valid = (rows >= dy) & (rows < H + dy) & (cols >= dx) & (cols < W + dx)
    shifted = jnp.where(valid, shifted, 0.0)
    residual = residual - values[:, :, None, None] * shifted[:, None, :, :]
    peak = integrated.reshape(-1)[flat_idx]
    return residual, model, peak


def _shard_map(fn, mesh, in_specs, out_specs):
    """``jax.shard_map`` without the replication check (the programs here
    reduce explicitly)."""
    return jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


_MESH_SUBMINOR_CACHE: dict = {}


def _build_mesh_subminor_program(
    mesh: Mesh,
    shape: Tuple[int, int, int],
    cap: int,
    *,
    C: int,
    Pp: int,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    use_rms: bool,
):
    """Build (and cache) the sharded Clark-subminor program.

    The reference's faceted fast path: each sub-image gathers its own
    candidate set and cleans it *independently* to the shared global
    threshold (``subminor_loop.cc:62-115,143-184`` run per sub-image under
    ``parallel_deconvolution.cc:606-617``).  Here each "tile" shard of the
    ("chan", "tile") mesh owns the candidates in its rows; the chan shards
    of a tile cooperate per iteration with a [K] ``psum`` (integrated
    scratch) and an [N] ``all_gather`` (the winner's per-plane values), and
    the whole mesh runs in lockstep until every tile is below threshold
    (one scalar any-reduce per iteration).  Candidate coordinates within a
    tile are identical across its chan group by construction (they derive
    from the psum'd integrated image).

    Returns the jitted program; see :func:`mesh_subminor_clean`.
    """
    N, H, W = shape
    n_chan = mesh.shape["chan"]
    n_tile = mesh.shape["tile"]
    N_loc = N // n_chan
    H_loc = H // n_tile
    neg_inf = jnp.float32(-jnp.inf)

    plane_axis = "chan" if n_chan > 1 else None
    cube_spec = P(plane_axis, "tile", None)
    # The candidate-offset PSF gather indexes GLOBAL rows: each device
    # needs the full spatial extent of its plane shard.
    psf_spec = P(plane_axis, None, None)
    img_spec = P("tile", None)
    scalar = P()

    def body(res_l, psf_l, rms_l, window_l, lin_all,
             considered_threshold, threshold, gain,
             start_iteration, max_iterations, divergence_limit):
        ci = jax.lax.axis_index("chan")
        ti = jax.lax.axis_index("tile")
        r0 = ti * H_loc
        lin_l = jax.lax.dynamic_slice(lin_all, (ci * N_loc,), (N_loc,))

        # ---- candidate selection (subminor_loop.cc:143-184) -------------
        integ = jax.lax.psum(
            jnp.einsum("n,nhw->hw", lin_l, res_l), "chan"
        )
        if use_rms:
            integ = integ * rms_l
        value = jnp.abs(integ) if allow_negative else integ
        selectable = (value >= considered_threshold) & window_l
        flat = jnp.where(selectable, value, neg_inf).reshape(-1)
        # Brightest-first capped gather: with overflow, dropping the
        # dimmest pixels matches the reference's behavior of never visiting
        # below-threshold set members.
        _, idx = jax.lax.top_k(flat, cap)
        sel = jnp.take(selectable.reshape(-1), idx)
        valid = sel
        idx_c = jnp.maximum(idx, 0)
        xs = (idx_c % W).astype(jnp.int32)
        ys_l = (idx_c // W).astype(jnp.int32)  # local row frame
        ys = ys_l + r0  # global rows (PSF offsets)
        res_k = res_l[:, ys_l, xs] * valid[None, :]  # [N_loc, K]
        rms_k = rms_l[ys_l, xs] if use_rms else jnp.ones((cap,), jnp.float32)

        def get_max(res_k):
            scratch = jax.lax.psum(
                jnp.einsum("n,nk->k", lin_l, res_k), "chan"
            ) * rms_k
            v = jnp.abs(scratch) if allow_negative else scratch
            masked = jnp.where(valid, v, neg_inf)
            m = jnp.argmax(masked)
            return m, scratch[m]

        m0, max0 = get_max(res_k)
        has_any = jnp.any(valid)
        max_at_start = jnp.abs(max0)

        def tile_ok(it, max_val, diverging):
            ok = has_any & (jnp.abs(max_val) > threshold)
            ok &= it < max_iterations
            if stop_on_negative:
                ok &= max_val >= 0.0
            return ok & ~diverging

        def cond(state):
            res_k, mod_k, it, m, max_val, diverging = state
            ok = tile_ok(it, max_val, diverging)
            # Lockstep: iterate while ANY tile is above threshold.
            return jax.lax.psum(
                jax.lax.psum(ok.astype(jnp.int32), "tile"), "chan"
            ) > 0

        def step(state):
            res_k, mod_k, it, m, max_val, diverging = state
            do = tile_ok(it, max_val, diverging)
            vals_l = res_k[:, m]  # [N_loc]
            vals = jax.lax.all_gather(vals_l, "chan", tiled=True)  # [N]
            x = xs[m]
            y = ys[m]
            if fitter is not None:
                vv = vals.reshape(C, Pp)
                vals = fitter.fit_and_evaluate(vv, x, y).reshape(-1)
            component = vals * gain
            pv_l = jax.lax.dynamic_slice(component, (ci * N_loc,), (N_loc,))
            gate = do.astype(jnp.float32)
            mod_k = mod_k.at[:, m].add(pv_l * gate)
            # Twice-convolved-PSF values at every candidate relative to the
            # component (subminor_loop.cc:91-105; image-size indexing).
            dyp = ys - y + H // 2
            dxp = xs - x + W // 2
            inb = (
                (dyp >= 0) & (dyp < H) & (dxp >= 0) & (dxp < W) & valid
            )
            psf_vals = psf_l[
                :,
                jnp.clip(dyp, 0, H - 1),
                jnp.clip(dxp, 0, W - 1),
            ]  # [N_loc, K]
            psf_vals = jnp.where(inb[None, :], psf_vals, 0.0)
            res_k = res_k - psf_vals * (pv_l * gate)[:, None]
            m2, max2 = get_max(res_k)
            diverging = diverging | jnp.where(
                divergence_limit != 0.0,
                do & (jnp.abs(max2) > max_at_start * divergence_limit),
                False,
            )
            return (
                res_k,
                mod_k,
                it + do.astype(jnp.int32),
                m2,
                jnp.where(do, max2, max_val),
                diverging,
            )

        init = (
            res_k,
            jnp.zeros_like(res_k),
            start_iteration,
            m0,
            max0,
            jnp.asarray(False),
        )
        res_k, mod_k, it, m, max_val, diverging = jax.lax.while_loop(
            cond, step, init
        )
        # Scatter the per-candidate model into this shard's cube rows.
        mod_full = jnp.zeros((N_loc, H_loc, W), jnp.float32)
        mod_full = mod_full.at[:, ys_l, xs].add(
            mod_k * valid[None, :].astype(jnp.float32)
        )
        # Iterations: summed over tiles (the reference's per-sub-image
        # counters aggregate the same way); identical within a chan group.
        tile_iters = (it - start_iteration) * (ci == 0).astype(jnp.int32)
        total_iters = start_iteration + jax.lax.psum(
            jax.lax.psum(tile_iters, "tile"), "chan"
        )
        gmax = jax.lax.pmax(jax.lax.pmax(jnp.abs(max_val), "tile"), "chan")
        signed = jnp.where(jnp.abs(max_val) >= gmax, max_val, neg_inf)
        gmax_signed = jax.lax.pmax(jax.lax.pmax(signed, "tile"), "chan")
        any_div = jax.lax.pmax(
            jax.lax.pmax(diverging.astype(jnp.int32), "tile"), "chan"
        ) > 0
        any_sel = jax.lax.pmax(
            jax.lax.pmax(has_any.astype(jnp.int32), "tile"), "chan"
        ) > 0
        return mod_full, total_iters, gmax_signed, any_div, any_sel

    sharded = _shard_map(
        body,
        mesh,
        in_specs=(
            cube_spec, psf_spec, img_spec, img_spec, scalar,
            scalar, scalar, scalar, scalar, scalar, scalar,
        ),
        out_specs=(cube_spec, scalar, scalar, scalar, scalar),
    )
    return jax.jit(sharded)


def mesh_subminor_clean(
    mesh: Mesh,
    residual: jnp.ndarray,  # [N, H, W] sharded or host
    twice_psfs: jnp.ndarray,  # [N, H, W] per-plane twice-convolved PSFs
    rms_factor: jnp.ndarray,  # [H, W] (ones when unused)
    window: jnp.ndarray,  # [H, W] bool: border window AND mask
    considered_threshold: jnp.ndarray,
    threshold: jnp.ndarray,
    gain: jnp.ndarray,
    start_iteration: jnp.ndarray,
    max_iterations: jnp.ndarray,
    divergence_limit: jnp.ndarray,
    cap: int,
    *,
    meta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter,
    use_rms: bool,
):
    """Sharded Clark subminor (see :func:`_build_mesh_subminor_program`).

    Returns ``(model_delta [N, H, W] sharded, iterations, final_max,
    diverging, any_selected)``; the caller subtracts
    ``model_delta ⊛ psf`` from the full residual (the reference's
    ``CorrectResidualDirty``, one sharded FFT convolution) and adds
    ``model_delta`` to the model cube.
    """
    from ..image_set import linear_integration_coefficients

    N, H, W = residual.shape
    C, Pp = meta.n_channels, meta.n_polarizations
    lin_np = np.asarray(linear_integration_coefficients(meta), np.float32)
    key = (
        mesh, (N, H, W), cap, C, Pp, allow_negative, stop_on_negative,
        fitter, use_rms,
    )
    prog = _MESH_SUBMINOR_CACHE.get(key)
    if prog is None:
        prog = _build_mesh_subminor_program(
            mesh,
            (N, H, W),
            cap,
            C=C,
            Pp=Pp,
            allow_negative=allow_negative,
            stop_on_negative=stop_on_negative,
            fitter=fitter,
            use_rms=use_rms,
        )
        _MESH_SUBMINOR_CACHE[key] = prog
    n_chan = mesh.shape["chan"]
    plane_axis = "chan" if n_chan > 1 else None
    cube_sh = NamedSharding(mesh, P(plane_axis, "tile", None))
    img_sh = NamedSharding(mesh, P("tile", None))
    residual = jax.device_put(residual, cube_sh)
    twice_psfs = jax.device_put(
        twice_psfs, NamedSharding(mesh, P(plane_axis, None, None))
    )
    rms_factor = jax.device_put(rms_factor, img_sh)
    window = jax.device_put(window, img_sh)
    return prog(
        residual,
        twice_psfs,
        rms_factor,
        window,
        jnp.asarray(lin_np),
        jnp.float32(considered_threshold),
        jnp.float32(threshold),
        jnp.float32(gain),
        jnp.int32(start_iteration),
        jnp.int32(max_iterations),
        jnp.float32(divergence_limit),
    )


def shard_clean_inputs(
    mesh: Mesh,
    residual: jnp.ndarray,  # [N, H, W]
    model: jnp.ndarray,  # [N, H, W]
    psfs: jnp.ndarray,  # [C, H, W]
    rms_factor: jnp.ndarray,  # [H, W]
    mask: jnp.ndarray,  # [H, W]
):
    """Lay the minor-loop state out over the mesh: image planes over the
    "chan" axis (when the plane count divides it) and image rows over "tile".
    XLA then partitions the jitted minor loop and inserts the channel psum,
    the argmax max-reduce, and the peak broadcast automatically — the
    reference's four exchange patterns (SURVEY.md §2.2)."""
    n_chan_devices = mesh.shape["chan"]
    plane_axis = "chan" if residual.shape[0] % n_chan_devices == 0 else None
    psf_axis = "chan" if psfs.shape[0] % n_chan_devices == 0 else None
    plane_rows = NamedSharding(mesh, P(plane_axis, "tile", None))
    image_rows = NamedSharding(mesh, P("tile", None))
    residual = jax.device_put(residual, plane_rows)
    model = jax.device_put(model, plane_rows)
    psfs = jax.device_put(psfs, NamedSharding(mesh, P(psf_axis, None, None)))
    rms_factor = jax.device_put(rms_factor, image_rows)
    mask = jax.device_put(mask, image_rows)
    return residual, model, psfs, rms_factor, mask


def shard_multiscale_inputs(
    mesh: Mesh,
    residual: jnp.ndarray,  # [N, H, W]
    model: jnp.ndarray,  # [N, H, W]
    kernel_f: jnp.ndarray,  # [S, PH, PWf] complex (padded_small spectra)
    twice_psfs: jnp.ndarray,  # [S, C, H, W]
    psf_f: jnp.ndarray,  # [C, PH, PWf] complex
    kernel_f_large: jnp.ndarray,  # [S-split, PHb, PWbf] complex
    psf_f_large: jnp.ndarray,  # [C, PHb, PWbf] complex
    valid_stack: jnp.ndarray,  # [S, H, W] bool
    rms_factor: jnp.ndarray,  # [H, W]
):
    """Lay the fused-multiscale state out over the ("chan", "tile") mesh.

    Image planes ride the "chan" axis (when divisible) and image rows the
    "tile" axis — the reference's per-scale thread parallelism
    (``threaded_deconvolution_tools.cc:30-50``) becomes XLA-partitioned
    batched FFTs plus a tile max-reduce for the per-scale argmax
    (``multiscale_algorithm.cc:578-634``).  The spectral residual the fused
    loop derives from the (sharded) image-space cube inherits the channel
    sharding; padded-size spectra bank rows are sharded over "chan" (PSF
    planes) or replicated (kernel planes), because the 7-smooth padded
    extent need not divide the tile count."""
    n_chan = mesh.shape["chan"]
    n_tile = mesh.shape["tile"]
    plane_axis = "chan" if residual.shape[0] % n_chan == 0 else None
    psf_chan_axis = "chan" if psf_f.shape[0] % n_chan == 0 else None
    row_axis = "tile" if residual.shape[1] % n_tile == 0 else None
    cube = NamedSharding(mesh, P(plane_axis, row_axis, None))
    residual = jax.device_put(residual, cube)
    model = jax.device_put(model, cube)
    kernel_f = jax.device_put(kernel_f, replicated(mesh))
    twice_psfs = jax.device_put(
        twice_psfs, NamedSharding(mesh, P(None, psf_chan_axis, row_axis, None))
    )
    psf_f = jax.device_put(
        psf_f, NamedSharding(mesh, P(psf_chan_axis, None, None))
    )
    kernel_f_large = jax.device_put(kernel_f_large, replicated(mesh))
    psf_f_large = jax.device_put(
        psf_f_large, NamedSharding(mesh, P(psf_chan_axis, None, None))
    )
    valid_stack = jax.device_put(
        valid_stack, NamedSharding(mesh, P(None, row_axis, None))
    )
    rms_factor = jax.device_put(
        rms_factor, NamedSharding(mesh, P(row_axis, None))
    )
    return (
        residual,
        model,
        kernel_f,
        twice_psfs,
        psf_f,
        kernel_f_large,
        psf_f_large,
        valid_stack,
        rms_factor,
    )


def facet_axis_spec(mesh: Mesh, n_facets: int):
    """Mesh axes to lay the facet axis over: the whole mesh when the facet
    count divides it, the "tile" axis alone otherwise, or None (replicate)
    when it divides neither.  The facet axis is embarrassingly parallel
    (the reference's ``RecursiveFor::NestedRun`` over sub-images,
    ``parallel_deconvolution.cc:606-617``), so F facets on F devices cost
    one facet's wall time."""
    if n_facets % mesh.size == 0:
        return ("chan", "tile")
    if n_facets % mesh.shape["tile"] == 0:
        return "tile"
    if n_facets % mesh.shape["chan"] == 0:
        return "chan"
    return None


def shard_facet_inputs(mesh: Mesh, arrays, facet_axes):
    """Lay batched-facet program inputs over the mesh.

    ``arrays`` pairs with ``facet_axes`` (the vmap in_axes spec): entries
    with axis 0 are sharded along the facet axis, shared banks are
    replicated.  XLA then partitions the whole vmapped minor-loop program:
    each device runs its own facets' while-loops, and only the lockstep
    stop predicate (an OR over facets) crosses devices per iteration."""
    n_facets = None
    for arr, ax in zip(arrays, facet_axes):
        if ax == 0:
            n_facets = arr.shape[0]
            break
    spec = facet_axis_spec(mesh, n_facets) if n_facets else None
    out = []
    for arr, ax in zip(arrays, facet_axes):
        if not hasattr(arr, "shape") or arr.ndim == 0:
            out.append(arr)
        elif ax == 0 and spec is not None:
            out.append(
                jax.device_put(
                    arr, NamedSharding(mesh, P(*([spec] + [None] * (arr.ndim - 1))))
                )
            )
        else:
            out.append(jax.device_put(arr, replicated(mesh)))
    return out


def dryrun_large_sharded(n_devices: int, size: int = 8192, c: int = 2,
                         p: int = 4, n_steps: int = 1) -> float:
    """Memory-sharded large-shape proof (8192² × channels × 4 Stokes):
    the cube is built SHARDED via ``jax.make_array_from_callback`` — each
    device materializes only its own shard, so the full cube never exists
    on any single device — and cleaned by the XLA-partitioned dense Högbom
    loop (``models.generic_clean._hogbom_loop`` over the ("chan", "tile")
    mesh, the path ``GenericClean`` takes on a mesh).  Returns the final
    peak comparison value.
    """
    from ..image_set import CubeMeta
    from ..models.generic_clean import _hogbom_loop

    mesh = make_mesh(n_devices, n_channels=c)
    n_chan = mesh.shape["chan"]
    N = c * p
    H = W = size
    meta = CubeMeta(
        n_channels=c,
        n_polarizations=p,
        weights=(1.0,) * c,
        linked=(True,) * p,
        polarization_norm_factor=float(p),
        squared_joins=True,
        frequencies=tuple(1e8 + 1e7 * i for i in range(c)),
    )
    plane_axis = "chan" if N % n_chan == 0 else None
    cube_sh = NamedSharding(mesh, P(plane_axis, "tile", None))
    img_sh = NamedSharding(mesh, P("tile", None))
    psf_sh = NamedSharding(
        mesh, P("chan" if c % n_chan == 0 else None, None, None)
    )
    cy, cx = size // 2, size // 4

    def local(index, dims):
        return [np.arange(d)[i] for d, i in zip(dims, index)]

    def res_shard(index):
        planes, rows, cols = local(index, (N, H, W))
        block = (
            np.sin(rows[:, None] * 0.37) * np.cos(cols[None, :] * 0.23)
        ).astype(np.float32) * 0.01
        out = np.broadcast_to(
            block[None], (len(planes), len(rows), len(cols))
        ).copy()
        # One bright source, owned by whichever shard contains it.
        if rows[0] <= cy <= rows[-1] and cols[0] <= cx <= cols[-1]:
            out[:, cy - rows[0], cx - cols[0]] = 1.0
        return out

    def zeros_shard(index):
        return np.zeros(
            tuple(len(a) for a in local(index, (N, H, W))), np.float32
        )

    def psf_shard(index):
        chans, rows, cols = local(index, (c, H, W))
        out = np.zeros((len(chans), len(rows), len(cols)), np.float32)
        if rows[0] <= H // 2 <= rows[-1] and cols[0] <= W // 2 <= cols[-1]:
            out[:, H // 2 - rows[0], W // 2 - cols[0]] = 1.0
        return out

    residual = jax.make_array_from_callback((N, H, W), cube_sh, res_shard)
    full_elems = N * H * W
    for s in residual.addressable_shards:
        assert int(np.prod(s.data.shape)) < full_elems, (
            "cube materialized unsharded on a device"
        )
    model = jax.make_array_from_callback((N, H, W), cube_sh, zeros_shard)
    psfs = jax.make_array_from_callback((c, H, W), psf_sh, psf_shard)
    ones_img = jax.make_array_from_callback(
        (H, W), img_sh,
        lambda idx: np.ones(
            tuple(len(a) for a in local(idx, (H, W))), np.float32
        ),
    )
    mask = jax.make_array_from_callback(
        (H, W), img_sh,
        lambda idx: np.ones(tuple(len(a) for a in local(idx, (H, W))), bool),
    )
    res, mod, it, value, found, diverging = _hogbom_loop(
        residual,
        model,
        psfs,
        ones_img,
        mask,
        jnp.float32(2.0),
        jnp.int32(cx),
        jnp.int32(cy),
        jnp.asarray(True),
        jnp.float32(1e-4),
        jnp.float32(0.5),
        jnp.float32(2.0),
        jnp.float32(0.0),
        jnp.int32(0),
        jnp.int32(n_steps),
        meta=meta,
        allow_negative=True,
        stop_on_negative=False,
        fitter=None,
        border_h=0,
        border_v=0,
        use_rms=False,
        use_mask=False,
    )
    jax.block_until_ready(res)
    assert int(it) == n_steps, (int(it), n_steps)
    assert bool(found) and not bool(diverging)
    return float(value)


def dryrun_step(n_devices: int) -> float:
    """Compile + execute the sharded deconvolution on tiny shapes; used by
    the driver's multi-chip dry-run.

    Two layers are exercised: (1) one explicitly-sharded clean step (the
    collective patterns in isolation), then (2) a FULL ``Radler.perform``
    with ``parallel.use_device_mesh`` — the entire jitted minor
    ``while_loop`` partitioned over the ("chan", "tile") mesh, with the
    channel psum, global argmax max-reduce, and peak broadcast riding the
    mesh exactly as on a real multi-chip slice."""
    C, Pp, H, W = 2, 2, 64, 64
    mesh = make_mesh(n_devices, n_channels=C)
    key = jax.random.PRNGKey(0)
    residual = jax.random.normal(key, (C, Pp, H, W), jnp.float32) * 0.01
    residual = residual.at[:, :, H // 2, W // 2].set(1.0)
    psf = jnp.zeros((C, H, W), jnp.float32).at[:, H // 2, W // 2].set(1.0)
    weights = jnp.full((C,), 1.0 / C, jnp.float32)
    with mesh:
        residual_s = jax.device_put(residual, cube_sharding(mesh))
        model = jax.device_put(
            jnp.zeros((C, Pp, H, W), jnp.float32), cube_sharding(mesh)
        )
        psf_s = jax.device_put(
            psf, NamedSharding(mesh, P("chan", None, None))
        )
        weights_s = jax.device_put(weights, replicated(mesh))
        residual_s, model, peak = sharded_clean_step(
            residual_s, model, psf_s, weights_s, jnp.float32(0.1)
        )
        jax.block_until_ready(residual_s)

    # Full minor loop over the mesh through the public API.
    import radler_tpu as rd  # deferred: avoids a circular import

    s = rd.Settings()
    s.trimmed_image_width = W
    s.trimmed_image_height = H
    s.minor_iteration_count = 20
    s.absolute_threshold = 1e-6
    s.generic.use_sub_minor_optimization = False
    s.parallel.use_device_mesh = True
    s.parallel.n_devices = n_devices  # dry-run the REQUESTED mesh size
    res_np = np.zeros((C, H, W), np.float32)
    res_np[:, H // 2, W // 2] = 1.0
    res_np[:, H // 4, W // 4] = 0.5
    mdl_np = np.zeros_like(res_np)
    psf_np = np.asarray(psf)
    freqs = np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7] for c in range(C)])
    r = rd.Radler(s, psf_np, res_np, mdl_np, 0.0, frequencies=freqs)
    r.perform(0)
    assert np.isfinite(res_np).all() and np.isfinite(mdl_np).all()
    assert np.abs(res_np).max() < 1.0, "sharded minor loop did not clean"

    # Full MULTISCALE perform over the mesh: the fused minor loop (scale
    # bank FFTs + dense subminor) partitioned over ("chan", "tile").
    yy, xx = np.mgrid[0:H, 0:W]
    g = np.exp(
        -((yy - H // 2) ** 2.0 + (xx - W // 2) ** 2.0) / (2 * 2.0**2)
    ).astype(np.float32)
    ms_psf = np.stack([g / g.max()] * C)
    sky = np.zeros((H, W), np.float32)
    sky[H // 3, W // 3] = 1.0
    sky[2 * H // 3, W // 2] = 0.7
    conv = np.real(
        np.fft.ifft2(np.fft.fft2(sky) * np.fft.fft2(np.fft.ifftshift(g)))
    ).astype(np.float32)
    ms_res = np.stack([conv * (1.0 - 0.1 * c) for c in range(C)])
    ms_before = np.abs(ms_res).max()
    ms_mdl = np.zeros_like(ms_res)
    s2 = rd.Settings()
    s2.trimmed_image_width = W
    s2.trimmed_image_height = H
    s2.algorithm_type = rd.AlgorithmType.MULTISCALE
    s2.minor_iteration_count = 40
    s2.absolute_threshold = 1e-3
    s2.major_loop_gain = 0.8
    s2.multiscale.max_scales = 2
    s2.parallel.use_device_mesh = True
    s2.parallel.n_devices = n_devices
    r2 = rd.Radler(s2, ms_psf, ms_res, ms_mdl, 0.0, frequencies=freqs)
    r2.perform(0)
    assert np.isfinite(ms_res).all() and np.isfinite(ms_mdl).all()
    assert np.abs(ms_res).max() < ms_before, "mesh multiscale did not clean"

    # Faceted multiscale WITH the mesh: both facet phases as one vmapped
    # program each (parallel_deconvolution.cc:582-617 pattern), the facet
    # axis sharded over the mesh (facet x mesh composition).
    f_res = np.stack([conv * (1.0 - 0.1 * c) for c in range(C)])
    f_before = np.abs(f_res).max()
    f_mdl = np.zeros_like(f_res)
    s3 = rd.Settings()
    s3.trimmed_image_width = W
    s3.trimmed_image_height = H
    s3.algorithm_type = rd.AlgorithmType.MULTISCALE
    s3.minor_iteration_count = 40
    s3.absolute_threshold = 1e-3
    s3.major_loop_gain = 0.8
    s3.multiscale.max_scales = 2
    s3.parallel.grid_width = 2
    s3.parallel.grid_height = 2
    s3.parallel.use_device_mesh = True
    s3.parallel.n_devices = n_devices
    r3 = rd.Radler(s3, ms_psf, f_res, f_mdl, 0.0, frequencies=freqs)
    r3.perform(0)
    assert np.isfinite(f_res).all() and np.isfinite(f_mdl).all()
    assert np.abs(f_res).max() < f_before, "faceted multiscale did not clean"

    # Faceted generic clean over the mesh (the batched Högbom facet
    # program, F axis sharded).
    g_res = np.stack([conv * (1.0 - 0.1 * c) for c in range(C)])
    g_before = np.abs(g_res).max()
    g_mdl = np.zeros_like(g_res)
    s4 = rd.Settings()
    s4.trimmed_image_width = W
    s4.trimmed_image_height = H
    s4.minor_iteration_count = 40
    s4.absolute_threshold = 1e-3
    s4.major_loop_gain = 0.8
    s4.parallel.grid_width = 2
    s4.parallel.grid_height = 2
    s4.parallel.use_device_mesh = True
    s4.parallel.n_devices = n_devices
    r4 = rd.Radler(s4, ms_psf, g_res, g_mdl, 0.0, frequencies=freqs)
    r4.perform(0)
    assert np.isfinite(g_res).all() and np.isfinite(g_mdl).all()
    assert np.abs(g_res).max() < g_before, "faceted generic did not clean"

    # IUWT over the mesh: rows of the decompose/CG programs sharded.
    HI = WI = 128
    yy, xx = np.mgrid[0:HI, 0:WI]
    gi = np.exp(
        -((yy - HI // 2) ** 2.0 + (xx - WI // 2) ** 2.0) / (2 * 2.5**2)
    ).astype(np.float32)
    blob = 0.8 * np.exp(
        -((yy - HI // 3) ** 2.0 + (xx - WI // 3) ** 2.0) / (2 * 4.0**2)
    ).astype(np.float32)
    i_res = np.real(
        np.fft.ifft2(np.fft.fft2(blob) * np.fft.fft2(np.fft.ifftshift(gi)))
    ).astype(np.float32)
    i_before = float(np.sqrt(np.mean(i_res**2)))
    i_mdl = np.zeros_like(i_res)
    s5 = rd.Settings()
    s5.trimmed_image_width = WI
    s5.trimmed_image_height = HI
    s5.algorithm_type = rd.AlgorithmType.IUWT
    s5.minor_iteration_count = 3
    s5.major_loop_gain = 0.8
    s5.parallel.use_device_mesh = True
    s5.parallel.n_devices = n_devices
    r5 = rd.Radler(s5, gi, i_res, i_mdl, 0.0)
    r5.perform(0)
    assert np.isfinite(i_res).all() and np.isfinite(i_mdl).all()
    assert float(np.sqrt(np.mean(i_res**2))) < i_before, (
        "mesh IUWT did not clean"
    )
    return float(peak)
