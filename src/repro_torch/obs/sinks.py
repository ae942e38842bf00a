"""Sinks of the metrics bus. This slice ports the human log-line sink;
the ring and JSONL sinks come with the observability slice."""
from __future__ import annotations

import sys
from typing import IO

__all__ = ["HumanLogSink"]


class HumanLogSink:
    """Prints the message of each "log" record, verbatim."""

    def __init__(self, stream: IO[str] | None = None):
        self.stream = stream if stream is not None else sys.stdout

    def emit(self, record: dict) -> None:
        if record.get("name") == "log":
            print(record["value"], file=self.stream)

    def close(self) -> None:
        pass
