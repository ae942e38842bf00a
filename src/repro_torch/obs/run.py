"""ObsRun: one training run's telemetry, for ``obs=None``.

The trainer enters it around `train()`, records through ``run.bus`` and
takes the schema-shaped history back from `run.history()`: the bus's
ring sink is the history's backing store, and the human log sink prints
the cadence lines. Run directories, the JSONL stream, traces written to
disk, the profiler and the drift monitor (an `ObsConfig`) come with the
observability slice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.bus import MetricsBus
from repro_torch.obs.schema import history_from_records
from repro_torch.obs.sinks import HumanLogSink, RingSink

__all__ = ["ObsConfig", "ObsRun"]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The reference's telemetry knobs (`repro/obs/run.py:ObsConfig`);
    not ported yet: constructing one raises."""

    run_dir: str | None = None

    def __post_init__(self):
        raise NotImplementedError(
            "ObsConfig is not ported to repro_torch yet: run directories, the "
            "JSONL stream, traces and the drift monitor come with the "
            "observability slice"
        )


class ObsRun:
    """The bus, a ring sink and a human log sink for one run (the
    reference's ``ObsRun(None)``)."""

    def __init__(self, cfg: ObsConfig | None = None):
        if cfg is not None:
            raise NotImplementedError(
                "ObsRun takes cfg=None only: ObsConfig comes with the "
                "observability slice"
            )
        self.ring = RingSink()
        self.bus = MetricsBus([self.ring, HumanLogSink()])

    def __enter__(self) -> "ObsRun":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.bus.close()

    def observe_step_time(self, seconds: float, step: int) -> None:
        self.bus.timing("step_time", seconds, step=step)

    def history(self) -> dict:
        """The schema-shaped history dict, folded from the ring's
        drained records (drains first)."""
        self.bus.drain()
        return history_from_records(self.ring.records)
