"""Sinks of the metrics bus, and the trainer's log-line format.

RingSink      in-memory record buffer: the trainer's history backing
HumanLogSink  prints the message of each "log" record, verbatim

`format_train_line` and `format_rollback_line` are the single source of
the trainer's log lines, the reference's format. The JSONL sink and
timestamps come with the observability slice.
"""
from __future__ import annotations

import sys
from typing import IO

__all__ = ["HumanLogSink", "RingSink", "format_rollback_line", "format_train_line"]


class RingSink:
    """Every drained record, in memory (the trainer's history backing)."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class HumanLogSink:
    """Prints the message of each "log" record, verbatim."""

    def __init__(self, stream: IO[str] | None = None):
        self.stream = stream if stream is not None else sys.stdout

    def emit(self, record: dict) -> None:
        if record.get("name") == "log":
            print(record["value"], file=self.stream)

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
