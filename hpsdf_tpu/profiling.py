"""Phase timing + device profiling.

The reference's only observability is wall-clock phase timing with
std::chrono around whole benchmark phases (Source/Tests/HPBenchmarks.cpp:
27-47, MeshingBenchmarks.cpp:26-34) plus a per-merge printf behind
Config::enableLogging (Source/HP/Octree.cpp:292-296). This module provides
the same phase-level wall clocks, made device-aware (block_until_ready so a
phase measures completed device work, not dispatch), and a bridge to the
JAX profiler for per-kernel traces viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import jax


class PhaseTimer:
    """Accumulating named phase wall-clocks (the chrono-around-phases
    pattern). ``block=True`` waits for device completion before stopping
    the clock -- with JAX's async dispatch, an unblocked timer measures
    only enqueue time."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result: Any = None, block: bool = True):
        t0 = time.perf_counter()
        out: list = []
        try:
            yield out
        finally:
            if block:
                for x in (out if result is None else [result]):
                    jax.block_until_ready(x)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{k}: {v:.4f} s over {self.counts[k]} call(s)"
                 for k, v in sorted(self.times.items())]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Per-kernel device profiling via the JAX profiler: wraps
    ``jax.profiler.trace``; open the result with TensorBoard's profile
    plugin or Perfetto. The replacement for the reference's
    absent tracing subsystem (SURVEY.md section 5.1)."""
    with jax.profiler.trace(log_dir):
        yield


def timed(fn, *args, block: bool = True, **kw):
    """(result, seconds) of one call, blocking on the result."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if block:
        jax.block_until_ready(out)
    return out, time.perf_counter() - t0
