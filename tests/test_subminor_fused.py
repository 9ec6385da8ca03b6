"""The one-program Clark subminor kernel (Pallas, Triton route) must match
the XLA while-loop path (``subminor_loop.cc:38-117`` semantics either way).

The kernel runs in the Pallas interpreter here; on a GPU the same program is
compiled by Triton and compared with the XLA loop by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from radler_tpu.image_set import CubeMeta, linear_integration_coefficients
from radler_tpu.models import subminor as sm
from radler_tpu.ops.pallas.subminor_fused import padded_capacity
from radler_tpu.ops.spectral_fitting import SpectralFitter
from radler_tpu.settings import SpectralFittingMode


def _make_problem(size=64, n_channels=2, n_pols=1, seed=3, n_sources=12):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = (yy - size // 2) ** 2.0 + (xx - size // 2) ** 2.0
    psf = np.exp(-r2 / (2 * 2.0**2)).astype(np.float32)
    psfs = np.stack([psf * (1.0 - 0.1 * c) for c in range(n_channels)])
    sky = np.zeros((size, size), np.float32)
    ys = rng.integers(8, size - 8, n_sources)
    xs = rng.integers(8, size - 8, n_sources)
    amps = rng.uniform(0.3, 1.0, n_sources).astype(np.float32)
    np.add.at(sky, (ys, xs), amps)
    planes = []
    for c in range(n_channels):
        conv = np.real(
            np.fft.ifft2(
                np.fft.fft2(sky) * np.fft.fft2(np.fft.ifftshift(psfs[c]))
            )
        ).astype(np.float32)
        for p in range(n_pols):
            planes.append(conv * (1.0 - 0.15 * p))
    residual = np.stack(planes)
    meta = CubeMeta(
        n_channels,
        n_pols,
        tuple([1.0] * n_channels),
        tuple([True] * n_pols),
        1.0,
        False,
        tuple(1e8 + 1e7 * c for c in range(n_channels)),
    )
    return psfs, residual, meta


def _run_both(
    psfs,
    residual,
    meta,
    threshold,
    max_iters=500,
    gain=0.1,
    fitter=None,
    rms=None,
    allow_negative=True,
    stop_on_negative=False,
    divergence_limit=0.0,
):
    size = residual.shape[-1]
    loop = sm.SubMinorLoop(size, size, 2 * size, 2 * size)
    loop.set_threshold(threshold, threshold)
    loop.set_iteration_info(0, max_iters)
    loop.set_gain(gain)
    loop.allow_negative_components = allow_negative
    loop.stop_on_negative_component = stop_on_negative
    loop.divergence_limit = divergence_limit
    if rms is not None:
        loop.rms_factor_image = jnp.asarray(rms)
    res = jnp.asarray(residual)
    count = loop.find_peak_positions(res, meta)
    assert count > 0
    fit = fitter if (fitter is not None and fitter.is_active) else None
    coef = jnp.asarray(linear_integration_coefficients(meta))
    res_k0 = loop._residual_k
    mod_k0 = jnp.zeros_like(res_k0)
    ref = sm._subminor_while(
        res_k0,
        mod_k0,
        loop._rms_k,
        loop._valid,
        loop._xs,
        loop._ys,
        jnp.asarray(psfs),
        coef,
        jnp.float32(threshold),
        jnp.float32(gain),
        jnp.int32(0),
        jnp.int32(max_iters),
        jnp.float32(divergence_limit),
        allow_negative=allow_negative,
        stop_on_negative=stop_on_negative,
        fitter=fit,
        n_channels=meta.n_channels,
        n_polarizations=meta.n_polarizations,
        height=size,
        width=size,
    )
    fused = loop._run_fused(
        res_k0,
        mod_k0,
        loop._rms_k,
        meta,
        jnp.asarray(psfs),
        fit,
    )
    return ref, fused


def _assert_match(ref, fused, atol=3e-5):
    r_ref, m_ref, it_ref, max_ref, div_ref = ref
    r_f, m_f, it_f, max_f, div_f = fused
    assert int(it_ref) == int(it_f)
    assert bool(div_ref) == bool(div_f)
    np.testing.assert_allclose(float(max_ref), float(max_f), atol=atol)
    np.testing.assert_allclose(
        np.asarray(r_ref), np.asarray(r_f), atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(m_ref), np.asarray(m_f), atol=atol
    )


def test_fused_matches_xla_multichannel():
    psfs, residual, meta = _make_problem(n_channels=2, n_pols=2)
    thr = 0.05 * float(np.abs(residual).max())
    ref, fused = _run_both(psfs, residual, meta, thr)
    _assert_match(ref, fused)


def test_fused_matches_xla_with_rms_factor():
    psfs, residual, meta = _make_problem(n_channels=1, n_pols=1)
    size = residual.shape[-1]
    yy, xx = np.mgrid[0:size, 0:size]
    rms = (0.5 + 0.5 * (xx + yy) / (2.0 * size)).astype(np.float32)
    thr = 0.04 * float(np.abs(residual).max())
    ref, fused = _run_both(psfs, residual, meta, thr, rms=rms)
    _assert_match(ref, fused)


def test_fused_matches_xla_polynomial_fit():
    psfs, residual, meta = _make_problem(n_channels=3, n_pols=1)
    fitter = SpectralFitter(
        SpectralFittingMode.POLYNOMIAL,
        2,
        meta.frequencies,
        (1.0,) * meta.n_channels,
    )
    thr = 0.05 * float(np.abs(residual).max())
    ref, fused = _run_both(psfs, residual, meta, thr, fitter=fitter)
    _assert_match(ref, fused)


def test_fused_matches_xla_stop_on_negative():
    psfs, residual, meta = _make_problem(n_channels=1, n_pols=1, seed=11)
    residual = residual.copy()
    residual[0, 20, 20] = -0.8 * np.abs(residual).max()
    thr = 0.02 * float(np.abs(residual).max())
    ref, fused = _run_both(
        psfs, residual, meta, thr, stop_on_negative=True
    )
    _assert_match(ref, fused)


def test_fused_matches_xla_divergence():
    psfs, residual, meta = _make_problem(n_channels=1, n_pols=1, seed=5)
    # A broken (negated, doubled) PSF makes every subtraction grow the peak.
    bad = -2.5 * psfs
    thr = 0.05 * float(np.abs(residual).max())
    ref, fused = _run_both(
        bad, residual, meta, thr, max_iters=200, divergence_limit=4.0
    )
    _assert_match(ref, fused)
    assert bool(ref[4])  # the run must actually have diverged


def test_fused_gate_rejects_nonlinear_fit_and_cpu():
    psfs, residual, meta = _make_problem(n_channels=2, n_pols=1)
    size = residual.shape[-1]
    loop = sm.SubMinorLoop(size, size, 2 * size, 2 * size)
    thr = 0.05 * float(np.abs(residual).max())
    loop.set_threshold(thr, thr)
    loop.set_iteration_info(0, 100)
    loop.set_gain(0.1)
    loop.find_peak_positions(jnp.asarray(residual), meta)
    log_fitter = SpectralFitter(
        SpectralFittingMode.LOG_POLYNOMIAL,
        2,
        meta.frequencies,
        (1.0,) * meta.n_channels,
    )
    ok, proj = sm.SubMinorLoop._fused_projection(log_fitter)
    assert not ok
    # Off the GPU the gate must always reject.
    assert not loop.fused_qualifies(len(psfs), None)


@pytest.mark.parametrize("k,expected", [(1, 16), (16, 16), (17, 32), (384, 512),
                                        (4096, 4096), (6144, 8192)])
def test_padded_capacity_is_next_power_of_two(k, expected):
    assert padded_capacity(k) == expected


def test_fused_three_images_odd_count():
    """Three image planes (no padding of N) and a candidate count that is
    not a power of two (padded K)."""
    psfs, residual, meta = _make_problem(n_channels=3, n_pols=1, seed=8)
    thr = 0.05 * float(np.abs(residual).max())
    ref, fused = _run_both(psfs, residual, meta, thr)
    assert ref[0].shape == fused[0].shape
    _assert_match(ref, fused)


def test_kernel_wrapper_pads_and_drops_candidates():
    """Padding candidates carry valid=False and never win the argmax."""
    from radler_tpu.ops.pallas.subminor_fused import (
        build_interaction_matrix,
        subminor_loop_fused,
    )

    rng = np.random.default_rng(4)
    H = W = 32
    K = 20
    Kp = padded_capacity(K)
    psf = np.zeros((1, H, W), np.float32)
    psf[0, H // 2, W // 2] = 1.0
    idx = rng.choice(H * W, K, replace=False)
    xs = jnp.asarray(np.pad(idx % W, (0, Kp - K)), jnp.int32)
    ys = jnp.asarray(np.pad(idx // W, (0, Kp - K)), jnp.int32)
    valid = jnp.asarray(np.arange(Kp) < K)
    res = np.zeros((1, Kp), np.float32)
    res[0, :K] = rng.uniform(0.1, 1.0, K)
    res[0, K:] = 100.0  # padding values must be ignored
    mat = build_interaction_matrix(
        jnp.asarray(psf), xs, ys, valid, height=H, width=W
    )
    out = subminor_loop_fused(
        jnp.asarray(res), jnp.zeros((1, Kp), jnp.float32),
        jnp.ones((Kp,), jnp.float32), valid, mat,
        jnp.float32(0.05), jnp.float32(1.0), jnp.int32(0), jnp.int32(K),
        jnp.float32(0.0),
        coef=(1.0,), proj=None, n_channels=1, n_polarizations=1,
        allow_negative=True, stop_on_negative=False, use_rms=False,
        interpret=True,
    )
    # A delta PSF with gain 1 removes one candidate per iteration.
    assert int(out[2]) == K
    np.testing.assert_allclose(np.asarray(out[1])[0, :K], res[0, :K])
    np.testing.assert_allclose(np.asarray(out[1])[0, K:], 0.0)


def _selected_loop(use_kernel):
    psfs, residual, meta = _make_problem(n_channels=1, n_pols=1)
    size = residual.shape[-1]
    loop = sm.SubMinorLoop(size, size, 2 * size, 2 * size,
                           use_kernel=use_kernel)
    thr = 0.05 * float(np.abs(residual).max())
    loop.set_threshold(thr, thr)
    loop.set_iteration_info(0, 300)
    loop.set_gain(0.1)
    loop.find_peak_positions(jnp.asarray(residual), meta)
    return loop, psfs, residual, meta


@pytest.mark.parametrize("use_kernel", [True, False])
def test_keyword_override_forces_the_loop(use_kernel, monkeypatch):
    loop, psfs, residual, meta = _selected_loop(use_kernel)
    assert loop.fused_qualifies(len(psfs), None) is use_kernel
    called = []
    real = loop._run_fused

    def spy(*args, **kwargs):
        called.append(True)
        return real(*args, **kwargs)

    monkeypatch.setattr(loop, "_run_fused", spy)
    loop.run(jnp.asarray(residual), meta, jnp.asarray(psfs))
    assert bool(called) is use_kernel
    assert loop.current_iteration > 0


def test_gate_limits_on_gpu(monkeypatch):
    """With a GPU backend the gate follows the measured limits: small
    candidate sets with a deep expected clean take the kernel; a work
    (images x candidates) above the limit or a matrix over the memory
    budget stays on the XLA loop."""
    loop, psfs, residual, meta = _selected_loop(None)

    class _Dev:
        platform = "gpu"

    monkeypatch.setattr(loop, "_data_device", lambda: _Dev())
    import radler_tpu.utils.device_memory as dm

    monkeypatch.setattr(dm, "device_memory_bytes", lambda device=None: 80e9)
    loop._est_logsum = 1e6
    assert loop.fused_qualifies(1, None)
    loop._est_logsum = 0.0
    assert not loop.fused_qualifies(1, None)  # nothing to amortize
    loop._est_logsum = 1e6
    big = sm._KERNEL_MAX_WORK * 2
    loop._xs = jnp.zeros((big,), jnp.int32)
    assert not loop.fused_qualifies(1, None)
    monkeypatch.setattr(dm, "device_memory_bytes", lambda device=None: 1e3)
    loop._xs = jnp.zeros((256,), jnp.int32)
    assert not loop.fused_qualifies(1, None)


@pytest.fixture
def gpu_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU form")
    return dev


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu_device):
    """The kernel as Triton compiles it (chip_smoke.py's kernel phase runs
    the same comparison at the 2048² candidate count)."""
    psfs, residual, meta = _make_problem(n_channels=2, n_pols=1)
    thr = 0.05 * float(np.abs(residual).max())
    ref, fused = _run_both(psfs, residual, meta, thr)
    _assert_match(ref, fused)
