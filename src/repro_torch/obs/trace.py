"""Phase tracing: spans recorded as Chrome-trace-format events, and
counters summed on the device.

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
`tracing()` context manager) install one, and `span()`, `count()` and
`device_counters()` are no-ops costing one global read when none is
installed, so library code can wrap phases and count work
unconditionally.

Counters. `count(name, value)` adds ``value`` to a named total; a device
tensor is added on its device, never read. `device_counters(name, n,
device)` hands a kernel a zeroed int64 buffer of ``n`` fields, which the
tracer owns and the kernel adds into across launches (one buffer a
name). `Tracer.counter_totals()` reads every buffer once, after the
owner's synchronize; `ObsRun` puts the totals on its bus at exit.

Device-level timelines come from `torch.profiler`:
`start_torch_profiler(dir)` / `stop_torch_profiler()` record the host's
operators and, on a card, its kernels, and export a Chrome trace into
``dir``. `ObsConfig(torch_profiler=True)` turns them on; they are never
ambient. While any session records (this module's or another's), each
span of a tracer also opens a `record_function` range named
``span:<name>``, so the program's phases sit on the profiler's clock
beside the card's kernels and name its idle gaps.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from contextlib import contextmanager

__all__ = [
    "SPAN_PREFIX",
    "Tracer",
    "activate",
    "count",
    "current",
    "deactivate",
    "device_counters",
    "span",
    "start_torch_profiler",
    "stop_torch_profiler",
    "tracing",
]

PROFILE_FILE = "torch_trace.json"
SPAN_PREFIX = "span:"  # a span's profiler range: span:<name>

_ACTIVE: "Tracer | None" = None
_PROFILER = None  # (torch.profiler.profile, export path) while one runs


def _profiler_range(name: str):
    """A `record_function` range ``span:<name>`` while a profiler session
    records, else a null context (one cheap call to find out)."""
    import torch

    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return contextlib.nullcontext()


class Tracer:
    """Accumulates Chrome-trace 'complete' (ph=X) events, microsecond
    timestamps relative to construction, and the run's counters."""

    def __init__(self):
        self.events: list[dict] = []
        self._t0 = time.perf_counter_ns()
        self._host_counts: dict[str, int] = {}
        self._buffers: dict = {}  # name -> int64 tensor of its fields

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    @contextmanager
    def span(self, name: str, **args):
        ts = self._now_us()
        try:
            with _profiler_range(name):
                yield
        finally:
            ev = {"name": name, "ph": "X", "ts": ts,
                  "dur": self._now_us() - ts, "pid": 0, "tid": 0}
            if args:
                ev["args"] = args
            self.events.append(ev)

    def device_counters(self, name: str, n: int, device):
        """The int64 buffer of ``n`` fields named ``name`` on ``device``,
        zeroed when first asked for; a kernel adds into it."""
        import torch

        buf = self._buffers.get(name)
        if buf is None:
            buf = self._buffers[name] = torch.zeros(n, dtype=torch.int64, device=device)
        elif buf.numel() != n or buf.device != torch.device(device):
            raise ValueError(f"counter {name!r} is {buf.numel()} fields on {buf.device}, "
                             f"asked for {n} on {device}")
        return buf

    def count(self, name: str, value) -> None:
        """Add ``value`` to counter ``name``: a host number on the host, a
        device tensor (an integer scalar) on its device, unread."""
        if hasattr(value, "device"):
            self.device_counters(name, 1, value.device).add_(value.reshape(1))
        else:
            self._host_counts[name] = self._host_counts.get(name, 0) + value

    def counter_totals(self) -> dict:
        """Every counter's total: an int for a single field, a list of ints
        for a buffer of several. Reads each buffer once: call it after
        the owner's synchronize."""
        out = dict(self._host_counts)
        for name, buf in self._buffers.items():
            vals = buf.tolist()
            out[name] = out.get(name, 0) + vals[0] if len(vals) == 1 else vals
        return out

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


def count(name: str, value) -> None:
    """Add ``value`` to the ambient tracer's counter ``name`` (a device
    tensor is summed on its device, unread); a no-op when none is
    active."""
    t = _ACTIVE
    if t is not None:
        t.count(name, value)


def device_counters(name: str, n: int, device):
    """The ambient tracer's int64 buffer ``name`` of ``n`` fields on
    ``device``, for a kernel to add into; None when no tracer is
    active."""
    t = _ACTIVE
    return None if t is None else t.device_counters(name, n, device)


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
