"""The dense Högbom loop partitioned by XLA over the ("chan", "tile") mesh
(the path ``GenericClean`` takes on a mesh) against the same loop on one
device: single-channel, joined-channel and joined-polarization (squared
joins) cubes on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radler_tpu.image_set import CubeMeta, get_square_integrated
from radler_tpu.models.generic_clean import _hogbom_loop
from radler_tpu.ops.peak_finder import find_peak
from radler_tpu.parallel.mesh import make_mesh, shard_clean_inputs


def _problem(n_chan, n_pol, size, seed=3):
    rng = np.random.default_rng(seed)
    N = n_chan * n_pol
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psf = np.exp(-r2 / 18.0).astype(np.float32)
    sky = np.zeros((size, size), np.float32)
    for _ in range(8):
        cy, cx = rng.integers(10, size - 10, 2)
        sky[cy, cx] = rng.uniform(0.5, 2.0)
    res = np.stack(
        [
            np.fft.irfft2(
                np.fft.rfft2(sky * (1 + 0.1 * i))
                * np.fft.rfft2(np.fft.ifftshift(psf)),
                s=(size, size),
            )
            for i in range(N)
        ]
    ).astype(np.float32)
    psfs = np.stack([psf] * n_chan)
    return psfs, res


def _run(meta, psfs, res, mesh=None, n_iter=40):
    N, H, W = res.shape
    residual = jnp.asarray(res)
    model = jnp.zeros_like(residual)
    psfs = jnp.asarray(psfs)
    rms = jnp.ones((H, W), jnp.float32)
    mask = jnp.ones((H, W), bool)
    pk = find_peak(get_square_integrated(residual, meta), True, 0, 0, None)
    if mesh is not None:
        residual, model, psfs, rms, mask = shard_clean_inputs(
            mesh, residual, model, psfs, rms, mask
        )
    return _hogbom_loop(
        residual,
        model,
        psfs,
        rms,
        mask,
        pk.value,
        pk.x,
        pk.y,
        pk.found,
        jnp.float32(1e-6),
        jnp.float32(0.2),
        jnp.abs(pk.value),
        jnp.float32(4.0),
        jnp.int32(0),
        jnp.int32(n_iter),
        meta=meta,
        allow_negative=True,
        stop_on_negative=False,
        fitter=None,
        border_h=0,
        border_v=0,
        use_rms=False,
        use_mask=False,
    )


def _meta(n_chan, n_pol, squared):
    return CubeMeta(
        n_channels=n_chan,
        n_polarizations=n_pol,
        weights=(1.0,) * n_chan,
        linked=(True,) * n_pol,
        polarization_norm_factor=float(n_pol),
        squared_joins=squared,
        frequencies=tuple(1e8 + 1e7 * c for c in range(n_chan)),
    )


@pytest.mark.parametrize(
    "n_chan,n_pol,squared",
    [(1, 1, False), (4, 1, False), (2, 2, True)],
    ids=["single_channel", "joined_channels", "joined_pols_squared"],
)
def test_mesh_hogbom_matches_one_device(n_chan, n_pol, squared):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    meta = _meta(n_chan, n_pol, squared)
    psfs, res = _problem(n_chan, n_pol, 64)
    ref = _run(meta, psfs, res)
    mesh = make_mesh(8, n_channels=n_chan)
    got = _run(meta, psfs, res, mesh)
    assert int(got[2]) == int(ref[2]) > 0
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), atol=2e-5)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), atol=2e-5)
    assert bool(got[4]) == bool(ref[4])
    assert abs(float(got[3]) - float(ref[3])) < 2e-4 + 1e-3 * abs(float(ref[3]))


def test_large_sharded_dry_run_small():
    """``dryrun_large_sharded`` (the config-5 sharded-construction proof)
    on the XLA-partitioned loop at a small size: the unit source shrinks
    step by step (gain 0.5)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from radler_tpu.parallel.mesh import dryrun_large_sharded

    two = dryrun_large_sharded(8, size=128, n_steps=2)
    three = dryrun_large_sharded(8, size=128, n_steps=3)
    assert abs(three - 0.5 * two) < 1e-6 * two
