"""Profiling hooks (SURVEY.md section 5.1: the reference has none; the
rebuild adds JAX profiler integration).

Usage:
    with profiling.trace("/tmp/trace"):      # Perfetto/XProf trace of a block
        state, m = run_steps(...)

    t = profiling.Timer()
    with t.block("spawn"):
        ...
    print(t.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XLA profiler trace viewable in XProf/TensorBoard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region visible in profiler traces (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


class Timer:
    """Host-side block timer with device synchronization."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def block(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(
                f"{name:30s} {self.totals[name]*1000:10.1f} ms total "
                f"({self.counts[name]} calls, "
                f"{self.totals[name]/max(self.counts[name],1)*1000:8.2f} ms/call)"
            )
        return "\n".join(lines)
