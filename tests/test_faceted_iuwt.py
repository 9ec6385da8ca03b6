"""Faceted IUWT/ASP through the parallel engine (serial per-facet loop).

The reference clones and runs ANY algorithm concurrently across sub-images
(``parallel_deconvolution.cc:227-242,606-617``); the JAX rebuild batches
MULTISCALE/GENERIC_CLEAN facets into one vmapped program and runs the
remaining algorithms through the same engine serially — IUWT's driver has
data-dependent per-facet control flow (structure boxes, scale escalation,
``iuwt_deconvolution_algorithm.cc:852-916``) with no common compiled shape
to batch.  These tests pin the behavioral contract of that path: the
faceted run cleans comparably to the unfaceted one and merges facets
without boundary artifacts.
"""

import numpy as np
import pytest

import radler_tpu as rd


def _diffuse_problem(size, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    psf = np.exp(-r2 / (2 * 2.0**2)).astype(np.float32)
    sky = np.zeros((size, size), np.float32)
    for _ in range(10):
        cy, cx = rng.integers(size // 6, 5 * size // 6, 2)
        s_ = rng.uniform(1.5, 6.0)
        a = rng.uniform(0.4, 1.2)
        sky += a * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s_ * s_)
        )
    residual = np.real(
        np.fft.ifft2(np.fft.fft2(sky) * np.fft.fft2(np.fft.ifftshift(psf)))
    ).astype(np.float32)
    return psf, residual


def _run_iuwt(grid, size=128):
    psf, residual = _diffuse_problem(size)
    model = np.zeros_like(residual)
    resid = residual.copy()
    s = rd.Settings()
    s.trimmed_image_width = size
    s.trimmed_image_height = size
    s.algorithm_type = rd.AlgorithmType.IUWT
    s.minor_iteration_count = 12
    s.major_loop_gain = 0.6
    s.parallel.grid_width = grid
    s.parallel.grid_height = grid
    r = rd.Radler(s, psf, resid, model, 0.0)
    r.perform(0)
    return residual, resid, model


@pytest.mark.slow
def test_faceted_iuwt_cleans_like_unfaceted():
    res0, res_1, mdl_1 = _run_iuwt(1)
    _, res_f, mdl_f = _run_iuwt(2)
    rms0 = float(np.sqrt(np.mean(res0**2)))
    rms_1 = float(np.sqrt(np.mean(res_1**2)))
    rms_f = float(np.sqrt(np.mean(res_f**2)))
    assert np.isfinite(res_f).all() and np.isfinite(mdl_f).all()
    assert mdl_f.max() > 0
    # Both runs deconvolve the diffuse emission substantially; the facet
    # boundaries may cost some depth but not more than half the cleaning.
    assert rms_1 < 0.6 * rms0
    assert rms_f < 0.75 * rms0
    # Flux conservation between the faceted and unfaceted runs.
    assert abs(float(mdl_f.sum()) - float(mdl_1.sum())) <= 0.25 * abs(
        float(mdl_1.sum())
    )
