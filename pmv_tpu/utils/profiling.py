"""Timing and tracing utilities.

The reference carries a hand-rolled nestable stopwatch (``tick``/``tock``,
include/OdometryPipeline.h:113, OdometryPipeline.cpp:84-91) used for the
run-level and per-stage timings printed under ``verbose``. :class:`Stopwatch`
reproduces that stack discipline; :func:`trace` wraps ``jax.profiler`` for
device traces.
"""

from __future__ import annotations

import contextlib
import time


class Stopwatch:
    """Nestable tick/tock stopwatch (stack semantics like the reference)."""

    def __init__(self) -> None:
        self._stack: list[float] = []

    def tick(self) -> None:
        self._stack.append(time.perf_counter())

    def tock(self) -> float:
        if not self._stack:
            return 0.0
        return time.perf_counter() - self._stack.pop()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
