"""Test configuration: run on a virtual 8-device CPU platform.

Unit tests exercise the jitted code paths on the CPU with 8 virtual devices,
so mesh/sharding tests run anywhere (see the multi-chip dry run in
``__graft_entry__.py``); Pallas kernels run in the interpreter.  What needs
a GPU is checked by ``python chip_smoke.py`` on the card (and
``--four-cards`` for the mesh path); tests that need the card carry the
``gpu`` marker and skip here.  The platform is pinned to cpu after
importing jax, whatever ``JAX_PLATFORMS`` says.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("RADLER_TPU_LOG", "none")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
