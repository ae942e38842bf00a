"""Sinks of the metrics bus, and the trainer's log-line format.

RingSink      bounded (or unbounded) in-memory record buffer: the test
              sink, and the trainer's history backing
JSONLSink     one JSON object per drained record, appended to
              <run_dir>/metrics.jsonl (the stream
              `repro_torch.obs.report` renders)
HumanLogSink  prints the message of each "log" record, verbatim by
              default (timestamps are opt-in, so log scraping keeps
              working)

`format_train_line` and `format_rollback_line` are the single source of
the trainer's log lines, the reference's format.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time
from typing import IO

__all__ = [
    "HumanLogSink",
    "JSONLSink",
    "RingSink",
    "format_rollback_line",
    "format_train_line",
]


class RingSink:
    """Every drained record, in memory. ``capacity=None`` keeps all of
    them (the trainer's history backing); a bounded capacity makes it a
    ring for long-lived monitors and tests."""

    def __init__(self, capacity: int | None = None):
        self.records: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JSONLSink:
    """Appends one JSON line per record to ``path`` (parent directories
    created). A value JSON cannot serialise is written as its repr.

    A failed write is retried with exponential backoff, the file reopened
    (in append mode) between attempts, so a transient IO failure does not
    kill a serving process. The sleep over all retries of one record is
    capped at ``max_sleep_s``: the sink sits on the serving drain path,
    so a disk that keeps failing must not stall a batch interval; once
    the budget is spent the remaining retries reopen at once. After
    ``retries`` failed retries the sink disarms itself (``self._f =
    None``) and says so on stderr: dropped telemetry beats a dead
    dispatcher."""

    def __init__(
        self,
        path: str,
        retries: int = 3,
        backoff: float = 0.01,
        max_sleep_s: float = 0.05,
    ):
        self.path = path
        self.retries = retries
        self.backoff = backoff
        self.max_sleep_s = max_sleep_s
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f: IO[str] | None = open(path, "a")

    def _reopen(self) -> None:
        try:
            if self._f is not None:
                self._f.close()
        except OSError:
            pass
        self._f = open(self.path, "a")

    def emit(self, record: dict) -> None:
        if self._f is None:
            return
        try:
            line = json.dumps(record)
        except TypeError:
            line = json.dumps({**record, "value": repr(record.get("value"))})
        slept = 0.0
        for attempt in range(self.retries + 1):
            try:
                self._f.write(line + "\n")
                return
            except (OSError, ValueError):  # ValueError: a write to a closed file
                if attempt == self.retries:
                    break
                delay = min(self.backoff * (2**attempt), self.max_sleep_s - slept)
                if delay > 0:
                    time.sleep(delay)
                    slept += delay
                try:
                    self._reopen()
                except OSError:
                    continue
        print(
            f"JSONLSink: dropping telemetry after {self.retries + 1} failed "
            f"writes to {self.path}; sink disarmed",
            file=sys.stderr,
        )
        self._f = None

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                self._f.close()
            except (OSError, ValueError):
                pass
            self._f = None


class HumanLogSink:
    """Prints the message of each "log" record, verbatim by default;
    ``timestamps=True`` puts a local ISO wall-clock stamp before it."""

    def __init__(self, stream: IO[str] | None = None, timestamps: bool = False):
        self.stream = stream if stream is not None else sys.stdout
        self.timestamps = timestamps

    def emit(self, record: dict) -> None:
        if record.get("name") != "log":
            return
        msg = record["value"]
        if self.timestamps:
            stamp = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(record["t"]))
            msg = f"{stamp} {msg}"
        print(msg, file=self.stream)

    def close(self) -> None:
        pass


def format_train_line(
    step: int,
    loss: float,
    aux: dict | None = None,
    checks: tuple | list = (),
    degraded: bool = False,
) -> str:
    """The log_every cadence line. ``aux`` carries the SNIS diagnostics
    (ess / rbar / max_wbar) when the estimator produces them, ``checks``
    the guard checks that fired, ``degraded`` the ladder's exact
    fallback."""
    msg = f"step {step}: loss={float(loss):+.5f}"
    if aux and "ess" in aux:
        msg += (
            f" ess={float(aux['ess']):.1f}"
            f" rbar={float(aux['rbar']):+.4f}"
            f" max_wbar={float(aux['max_wbar']):.3f}"
        )
    if checks:
        msg += f" health={','.join(checks)}"
    if degraded:
        msg += " [degraded:exact]"
    return msg


def format_rollback_line(step: int, to_step: int, restarts: int) -> str:
    return f"step {step}: ROLLBACK to {to_step} (restart #{restarts})"
