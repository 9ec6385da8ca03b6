"""Profiling hooks (aux subsystem the reference lacks — SURVEY.md §5).

Wraps the JAX profiler so a major iteration (or any region) can be captured
as an xplane trace viewable in TensorBoard / xprof, plus a lightweight
wall-time phase timer for host-side breakdowns.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace (xplane) of the enclosed region:

    >>> with profiling.trace("/tmp/radler-trace"):
    ...     radler.perform(0)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named sub-region inside a trace (shows up in the xplane timeline)."""
    return jax.profiler.TraceAnnotation(name)


class PhaseTimer:
    """Accumulating wall-clock timer for host-side phase breakdowns."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} "
                "calls"
            )
        return "\n".join(lines)
