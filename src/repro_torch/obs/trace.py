"""Phase tracing: spans recorded as Chrome-trace-format events.

``span("retrieval")`` wraps a host-side phase (the serving engine's
prepare/run, the plan's user embedding and retrieval). Spans measure the
host: a span around a CUDA launch ends when the launch is queued, not
when the card finishes it. The tracer is ambient: the `tracing()`
context manager installs one, and `span()` is a cheap no-op when none
is installed, so library code can wrap phases unconditionally. Writing
traces to a run directory and device-level tracing (`torch.profiler`)
come with the observability slice.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["Tracer", "span", "tracing"]

_ACTIVE: "Tracer | None" = None


class Tracer:
    """Accumulates Chrome-trace 'complete' (ph=X) events, microsecond
    timestamps relative to construction."""

    def __init__(self):
        self.events: list[dict] = []
        self._t0 = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    @contextmanager
    def span(self, name: str, **args):
        ts = self._now_us()
        try:
            yield
        finally:
            ev = {"name": name, "ph": "X", "ts": ts,
                  "dur": self._now_us() - ts, "pid": 0, "tid": 0}
            if args:
                ev["args"] = args
            self.events.append(ev)


@contextmanager
def tracing(tracer: Tracer):
    """Install ``tracer`` for the duration of the block (restores the
    previous one)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


@contextmanager
def span(name: str, **args):
    """Record a span on the ambient tracer; a no-op when none is active."""
    t = _ACTIVE
    if t is None:
        yield
        return
    with t.span(name, **args):
        yield
