"""The metrics bus: typed counters/gauges/timings/events with labels.

One recording discipline for the trainer, the health layer and the
serving loop: a record call NEVER reads a device value. Gauges accept a
device scalar (a tensor whose kernel may still be running) and store it
as is; `drain()`, called by the owner after its own
`torch.cuda.synchronize`, is the only place values are materialised
and handed to the sinks. The hot loop therefore pays list appends,
never a host sync.

Sinks are pluggable (`repro_torch.obs.sinks`): an in-memory ring (the
trainer's history backing), a JSONL file (the run report's input) and
human log lines.
"""
from __future__ import annotations

import time
from typing import Any, Iterable

__all__ = ["MetricsBus"]

# record kinds — the one vocabulary every sink and the report understand
KINDS = ("counter", "gauge", "timing", "event")


class MetricsBus:
    """Typed metric recording with deferred (post-drain) sink emission.

    counter(name, inc)      monotonically accumulated count; the record
                            carries the increment, `total(name)` the sum
    gauge(name, value)      point-in-time scalar; `value` may be a
                            pending device scalar — it is NOT read here
    timing(name, seconds)   host-measured duration (already a float)
    event(name, payload)    structured occurrence (dict/tuple payload)

    Every record takes an optional ``step=`` and free-form ``**labels``.
    Records are queued in call order and only reach the sinks on
    `drain()`, where pending device values are materialised via
    ``float()`` — call it after the owner's synchronize, when the
    conversion is a cheap host read, never a sync.
    """

    def __init__(self, sinks: Iterable = (), clock=time.time):
        self.sinks = list(sinks)
        self._clock = clock
        self._pending: list[dict] = []
        self._totals: dict[str, float] = {}

    # -- recording (hot path: appends only, no device reads) -----------
    def counter(self, name: str, inc: float = 1.0, *, step: int | None = None, **labels) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + inc
        self._push("counter", name, inc, step, labels)

    def gauge(self, name: str, value: Any, *, step: int | None = None, **labels) -> None:
        """`value` may be a device scalar still in flight — it is stored
        as-is and only converted on drain()."""
        self._push("gauge", name, value, step, labels)

    def timing(self, name: str, seconds: float, *, step: int | None = None, **labels) -> None:
        self._push("timing", name, float(seconds), step, labels)

    def event(self, name: str, payload: Any = None, *, step: int | None = None, **labels) -> None:
        self._push("event", name, payload, step, labels)

    def log(self, message: str, *, step: int | None = None) -> None:
        """A human log line (the trainer's former bare prints): rendered
        verbatim by the HumanLogSink, persisted like any record."""
        self._push("event", "log", message, step, {})

    def _push(self, kind: str, name: str, value, step, labels) -> None:
        rec = {"t": self._clock(), "kind": kind, "name": name, "value": value}
        if step is not None:
            rec["step"] = int(step)
        if labels:
            rec["labels"] = labels
        self._pending.append(rec)

    # -- draining (the ONLY place device values are read) --------------
    def drain(self) -> int:
        """Materialise queued records and emit them to every sink, in
        call order. Returns the number of records drained."""
        pending, self._pending = self._pending, []
        for rec in pending:
            v = rec["value"]
            if rec["kind"] in ("gauge", "counter") and not isinstance(
                v, (float, int, type(None))
            ):
                rec["value"] = float(v)  # post-block: a host read, not a sync
            for sink in self.sinks:
                sink.emit(rec)
        return len(pending)

    def total(self, name: str) -> float:
        """Accumulated counter total (0.0 for a never-incremented name)."""
        return self._totals.get(name, 0.0)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def close(self) -> None:
        self.drain()
        for sink in self.sinks:
            sink.close()
