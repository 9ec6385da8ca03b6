"""How much memory the device that runs the minor loops can hold.

Every routing gate that asks "does this working set fit?" (the fused
multiscale loop, vmapped facets, the Clark interaction matrix) reads its
budget from here, as a fraction of the device's own limit.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def host_memory_bytes() -> int:
    """Physical memory of the host, in bytes."""
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def device_memory_bytes(device: Optional[jax.Device] = None) -> int:
    """The memory a JAX process may allocate on ``device`` (default: the
    first device): ``memory_stats()["bytes_limit"]`` where the backend
    reports it, host physical memory for the CPU backend, which reports
    none.  A device that reports no limit and is not the CPU is an error:
    no size is assumed for it."""
    dev = device if device is not None else jax.devices()[0]
    try:
        stats = dev.memory_stats()
    except Exception:  # backends without memory stats
        stats = None
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return host_memory_bytes()
    raise RuntimeError(
        f"device {dev.device_kind!r} ({dev.platform}) reports no memory limit"
    )


def fits_device_memory(
    n_bytes: float, fraction: float, device: Optional[jax.Device] = None
) -> bool:
    """Whether ``n_bytes`` is within ``fraction`` of the device's memory."""
    return n_bytes <= fraction * device_memory_bytes(device)
