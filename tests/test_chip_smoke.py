"""chip_smoke.py's checks at tiny sizes on the CPU (the script itself
refuses to run without a GPU)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import radler_tpu as rd  # noqa: E402


def test_refuses_to_run_without_a_gpu(capsys):
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_numpy_hogbom_removes_a_point_source():
    size = 32
    psf = np.zeros((size, size), np.float32)
    psf[16, 16] = 1.0
    psf[16, 17] = 0.5
    res = np.zeros((size, size), np.float32)
    res[10, 12] = 2.0
    res[10, 13] = 1.0
    out, model = cs.numpy_hogbom(psf, res, 200, gain=0.1)
    assert np.abs(out).max() < 1e-6
    assert model[10, 12] == pytest.approx(2.0, rel=1e-6)


def test_dense_hogbom_matches_numpy_loop():
    rec = cs.dense_hogbom(64, n_check=30, n_iter=40)
    assert rec["max_residual_diff"] <= 1e-5
    assert rec["iterations"] == 40


def test_generic_majors_keep_the_major_loop_contract():
    records = cs.generic_majors(96, n_sources=6)
    assert records[0]["iterations"] > 0
    assert all(np.isfinite(r["rms"]) for r in records)


def test_point_source_contract_generic():
    rec = cs.point_source_contract(rd.AlgorithmType.GENERIC_CLEAN)
    assert rec["residual_max"] < 2e-6


def test_within_and_check():
    assert cs.within(1.0099, 1.0) and not cs.within(1.02, 1.0)
    with pytest.raises(AssertionError):
        cs.check(False, "boom")
