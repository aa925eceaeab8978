"""Logging + timing utilities (SURVEY.md §2 #17, §5.1; reference used
xerial-core ``Logger``/``StopWatch``).

``StopWatch`` prints per-phase wall time to stderr; ``trace_annotation``
wraps ``jax.profiler`` so `gwa align --profile` style runs produce
TensorBoard/Perfetto traces.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time

logger = logging.getLogger("gwa")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class StopWatch:
    def __init__(self, stream=sys.stderr):
        self.t0 = self.last = time.time()
        self.stream = stream

    def lap(self, msg: str) -> float:
        now = time.time()
        dt = now - self.last
        self.last = now
        self.stream.write(f"[gwa +{now - self.t0:7.2f}s] {msg} ({dt:.2f}s)\n")
        return dt


@contextlib.contextmanager
def trace_annotation(name: str):
    """jax.profiler annotation (no-op outside an active trace)."""
    import jax.profiler

    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile_to(dir_path: str | None):
    """Capture a jax.profiler trace to ``dir_path`` if given."""
    if not dir_path:
        yield
        return
    import jax.profiler

    jax.profiler.start_trace(dir_path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
