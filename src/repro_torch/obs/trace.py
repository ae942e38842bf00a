"""Phase tracing: spans recorded as Chrome-trace-format events.

``span("retrieval")`` wraps a host-side phase (the trainer's dispatch
and drain, index maintenance, checkpoints, health probes, the serving
engine's prepare and run, the plan's user embedding, retrieval,
sampling, reward and surrogate). Spans measure the host: a span around
a CUDA launch ends when the launch is queued, not when the card
finishes it, and the plan's spans time every step (the reference's time
one trace of its jitted step). Nested spans nest by ts/dur on one
thread track; load the written ``trace.json`` in chrome://tracing or
Perfetto.

The tracer is ambient: `activate()` / `deactivate()` (or the
`tracing()` context manager) install one, and `span()` is a cheap no-op
when none is installed, so library code can wrap phases
unconditionally.

Device-level timelines come from `torch.profiler`:
`start_torch_profiler(dir)` / `stop_torch_profiler()` record the host's
operators and, on a card, its kernels, and export a Chrome trace into
``dir``. `ObsConfig(torch_profiler=True)` turns them on; they are never
ambient.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

__all__ = [
    "Tracer",
    "activate",
    "current",
    "deactivate",
    "span",
    "start_torch_profiler",
    "stop_torch_profiler",
    "tracing",
]

PROFILE_FILE = "torch_trace.json"

_ACTIVE: "Tracer | None" = None
_PROFILER = None  # (torch.profiler.profile, export path) while one runs


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

    def instant(self, name: str, **args) -> None:
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "pid": 0,
              "tid": 0, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def write(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events, "displayTimeUnit": "ms"}, f)
        return path


# ---------------------------------------------------------------------------
# the ambient tracer
# ---------------------------------------------------------------------------

def activate(tracer: Tracer) -> None:
    global _ACTIVE
    _ACTIVE = tracer


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> Tracer | None:
    return _ACTIVE


@contextmanager
def tracing(tracer: Tracer):
    """Install ``tracer`` for the duration of the block (restores the
    previous one: runs can nest, e.g. serving inside a test)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


@contextmanager
def span(name: str, **args):
    """Record a span on the ambient tracer; a no-op when none is active
    (one global read: safe to leave in library hot paths)."""
    t = _ACTIVE
    if t is None:
        yield
        return
    with t.span(name, **args):
        yield


# ---------------------------------------------------------------------------
# torch.profiler (config opt-in only)
# ---------------------------------------------------------------------------

def start_torch_profiler(log_dir: str) -> bool:
    """Start a `torch.profiler` session over the host's operators and,
    where CUDA is available, the card's kernels; `stop_torch_profiler`
    exports it to ``<log_dir>/torch_trace.json``. Returns False (and
    stays off) when a session is already running or the profiler cannot
    start."""
    global _PROFILER
    if _PROFILER is not None:
        return False
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
    except (OSError, RuntimeError):
        return False
    _PROFILER = (prof, os.path.join(log_dir, PROFILE_FILE))
    return True


def stop_torch_profiler() -> str | None:
    """Stop the running session and export its Chrome trace; returns
    the trace's path (None when no session was running)."""
    global _PROFILER
    if _PROFILER is None:
        return None
    import torch

    prof, path = _PROFILER
    _PROFILER = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the kernels in flight land in the trace
    prof.stop()
    prof.export_chrome_trace(path)
    return path
