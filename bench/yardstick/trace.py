"""The reduction of one `torch.profiler` session to the numbers a traced
run reports: the device's busy time over the traced window, the device
time of each operation, the host spans, and the device's idle time
named by what the host was doing.

Host spans are `record_function` ranges whose names start with
``span:`` (the harness's own around each call into a layer, and the
program's `repro_torch.obs.trace` spans, which the harness forwards);
``span:window`` bounds the traced window. Device events are every
kernel, copy and fill, on the profiler's clock, which is the host's.
The device-time aggregation follows `chip_smoke.py:device_profile`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

__all__ = ["SPAN_PREFIX", "TraceSummary", "device_seconds", "profiler_events", "summarize"]

SPAN_PREFIX = "span:"
WINDOW = "window"
IDLE_OUTSIDE = "(no span)"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: dict[str, float]  # device seconds by operation name
    op_counts: dict[str, int]
    spans: dict[str, list[float]]  # host seconds of each span, by name
    idle: dict[str, float]  # device idle seconds by the innermost host span

    def top_ops(self, n: int = 10) -> list[list]:
        return [[k, v] for k, v in sorted(self.ops.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> list[list]:
        return [[k, v] for k, v in sorted(self.idle.items(), key=lambda kv: -kv[1])[:n]]


def op_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list."""
    name = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    cut = name.find("(")
    return name[:cut] if cut > 0 else name


def profiler_events(prof) -> list[tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every event of a
    stopped `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() != DeviceType.CPU, start, start + e.duration_ns()))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: Iterable[tuple[str, bool, int, int]]) -> TraceSummary:
    """Reduce ``events`` over the ``span:window`` range (the whole trace
    when there is none). A `record_function` range also leaves a device
    copy of itself; those are dropped, so that only kernels, copies and
    fills count as device work."""
    events = [e for e in events if not (e[1] and e[0].startswith(SPAN_PREFIX))]
    host = [(n[len(SPAN_PREFIX):], a, b) for n, dev, a, b in events
            if not dev and n.startswith(SPAN_PREFIX)]
    win = [(a, b) for n, a, b in host if n == WINDOW]
    if win:
        w0, w1 = min(a for a, _ in win), max(b for _, b in win)
    else:
        w0 = min((a for _, _, a, _ in events), default=0)
        w1 = max((b for _, _, _, b in events), default=0)
    ops: dict[str, float] = {}
    counts: dict[str, int] = {}
    busy = []
    for n, dev, a, b in events:
        if not dev:
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        key = op_name(n)
        ops[key] = ops.get(key, 0.0) + (b - a) * 1e-9
        counts[key] = counts.get(key, 0) + 1
        busy.append((a, b))
    busy = _union(busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    spans: dict[str, list[float]] = {}
    for n, a, b in host:
        if n != WINDOW and a >= w0 and b <= w1:
            spans.setdefault(n, []).append((b - a) * 1e-9)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        ops=ops,
        op_counts=counts,
        spans=spans,
        idle=_name_gaps(gaps, [(n, a, b) for n, a, b in host if n != WINDOW]),
    )


def _name_gaps(gaps: list[tuple[int, int]], host: list[tuple[str, int, int]]) -> dict:
    """Each gap's length, summed by the innermost host span open at its
    midpoint (the open span that started last), by one sweep."""
    marks = []
    for i, (_, a, b) in enumerate(host):
        marks.append((a, 0, i))
        marks.append((b, 2, i))
    for j, (a, b) in enumerate(gaps):
        marks.append(((a + b) // 2, 1, j))
    marks.sort()
    open_spans: list[int] = []
    idle: dict[str, float] = {}
    for _, kind, i in marks:
        if kind == 0:
            open_spans.append(i)
        elif kind == 2:
            open_spans.remove(i)
        else:
            a, b = gaps[i]
            inner = max(open_spans, key=lambda s: host[s][1]) if open_spans else None
            name = IDLE_OUTSIDE if inner is None else host[inner][0]
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    return idle


def device_seconds(summary: TraceSummary, prefixes: tuple[str, ...]) -> float | None:
    """Device seconds of the operations whose names start with one of
    ``prefixes``; None when none ran in the window."""
    hits = [v for k, v in summary.ops.items() if k.startswith(prefixes)]
    return sum(hits) if hits else None
