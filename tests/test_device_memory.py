"""Memory budget helper (utils/device_memory.py) and the compile-cache
placement done at import time (radler_tpu/__init__.py)."""

import os
import subprocess
import sys

import jax
import pytest

import radler_tpu
from radler_tpu.utils import device_memory as dm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_backend_reads_host_memory():
    assert jax.devices()[0].platform == "cpu"
    assert dm.device_memory_bytes() == dm.host_memory_bytes() > 0


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = "fake"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_reported_limit_wins_and_unknown_device_is_an_error():
    assert dm.device_memory_bytes(_FakeDevice("gpu", {"bytes_limit": 123})) == 123
    with pytest.raises(RuntimeError):
        dm.device_memory_bytes(_FakeDevice("gpu", None))


def test_fits_device_memory_uses_the_fraction():
    dev = _FakeDevice("gpu", {"bytes_limit": 1000})
    assert dm.fits_device_memory(250, 0.25, dev)
    assert not dm.fits_device_memory(251, 0.25, dev)


def _cache_dir_in_child(env):
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import radler_tpu; print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_the_checkout():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    got = _cache_dir_in_child(env)
    assert got == os.path.join(REPO, ".jax_cache") == radler_tpu.COMPILE_CACHE_DIR


def test_compile_cache_env_is_left_alone(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_dir_in_child(env) == str(tmp_path)
