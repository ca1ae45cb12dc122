"""Tracing / profiling hooks.

The JAX equivalent of the reference's Tracy integration (SURVEY.md §5.1):
ztracy zones wrapping every significant scope (reference main.zig:39-41,
Pipeline.zig:433, ComputePipeline.zig:419, StagingRamp.zig:81, ...) become
`jax.profiler` traces + `jax.named_scope`/TraceAnnotation zones with the
same zone names, viewable in XProf/perfetto instead of the Tracy client.

Usage:
    with profiling.trace_session("/tmp/trace"):   # -Denable_ztracy analog
        with profiling.zone("draw"):
            engine.draw(dt)
    profiling.frame_mark()   # per-frame marker (ztracy.FrameMark analog)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

_ENABLED = os.environ.get("ZVT_PROFILE", "0") == "1"
_frame_counter = 0


def enabled() -> bool:
    return _ENABLED


def enable(value: bool = True) -> None:
    global _ENABLED
    _ENABLED = value


@contextlib.contextmanager
def trace_session(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace for the enclosed scope (the analog of
    running the reference with Tracy attached)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def zone(name: str) -> Iterator[None]:
    """A named profiling zone (ztracy.ZoneN analog). Cheap no-op unless
    profiling is enabled; inside jit traces it adds a named_scope so the
    zone names appear in XLA HLO and XProf."""
    import jax

    if not _ENABLED:
        with jax.named_scope(name):
            yield
        return
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name), jax.named_scope(name):
        yield
    _log(name, time.perf_counter() - t0)


def frame_mark() -> None:
    """Per-frame marker (ztracy.FrameMark, reference main.zig:194)."""
    global _frame_counter
    _frame_counter += 1
    if _ENABLED:
        _log("frame", 0.0, extra=f"#{_frame_counter}")


_log_fn = None


def set_log_fn(fn) -> None:
    global _log_fn
    _log_fn = fn


def _log(name: str, dt: float, extra: str = "") -> None:
    if _log_fn is not None:
        _log_fn(name, dt, extra)
