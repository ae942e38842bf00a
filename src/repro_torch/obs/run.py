"""ObsRun: one training or serving run's telemetry, assembled from config.

`ObsConfig` is the single knob surface; `ObsRun` owns the bus, the
sinks, the ambient tracer, the optional `torch.profiler` session and
the roofline-drift monitor for the duration of one run. The trainer
enters it around `train()` (`with ObsRun(...) as run:`), records through
`run.bus`, and takes the schema-shaped history back from
`run.history()`: the bus's ring sink is the history's backing store.

With ``run_dir`` set the run leaves artifacts behind:

    <run_dir>/metrics.jsonl   every drained record, one JSON line each
                              (appended across train() calls of one run)
    <run_dir>/trace.json      Chrome-trace phase spans (chrome://tracing)
    <run_dir>/torchprof/      the torch.profiler Chrome trace
                              (torch_profiler=True only)

`python -m repro_torch.obs.report <run_dir>` renders the JSONL stream
into a markdown run report.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.obs import trace as trace_mod
from repro_torch.obs.bus import MetricsBus
from repro_torch.obs.drift import DriftConfig, DriftMonitor
from repro_torch.obs.schema import history_from_records
from repro_torch.obs.sinks import HumanLogSink, JSONLSink, RingSink

__all__ = ["ObsConfig", "ObsRun"]

TRACE_FILE = "trace.json"
METRICS_FILE = "metrics.jsonl"
PROFILE_DIR = "torchprof"


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs of the telemetry layer (`TrainerConfig.obs`).

    run_dir         directory for run artifacts (metrics.jsonl,
                    trace.json, torchprof/); None keeps telemetry in
                    memory only (bus and history, no files)
    jsonl           write the JSONL record stream (needs run_dir)
    trace           record phase spans into a Chrome trace (written to
                    run_dir when set; recording a span costs one list
                    append)
    torch_profiler  run a torch.profiler session into run_dir/torchprof:
                    host operators and the card's kernels, strictly
                    config-gated
    drift           DriftConfig arming the roofline-drift monitor (None
                    disables; it needs an analytic prediction, so runs
                    without one leave it off)
    log_timestamps  prefix human log lines with wall-clock stamps
                    (default off: the bare lines)
    ring_capacity   bound the in-memory record ring (None = unbounded,
                    required for a faithful history view)
    """

    run_dir: str | None = None
    jsonl: bool = True
    trace: bool = True
    torch_profiler: bool = False
    drift: DriftConfig | None = dataclasses.field(default_factory=DriftConfig)
    log_timestamps: bool = False
    ring_capacity: int | None = None


class ObsRun:
    """Context manager owning one run's telemetry plumbing. With
    cfg=None the bus, the ring and the human log sink still run (that is
    how the trainer backs `history` and its log lines with no config),
    with no files, no tracer and no drift monitor."""

    def __init__(
        self,
        cfg: ObsConfig | None = None,
        *,
        predicted_step_s: float | None = None,
        log_stream=None,
    ):
        self.cfg = cfg
        self.ring = RingSink(cfg.ring_capacity if cfg is not None else None)
        sinks: list = [self.ring]
        self.run_dir = cfg.run_dir if cfg is not None else None
        if self.run_dir:
            os.makedirs(self.run_dir, exist_ok=True)
            if cfg.jsonl:
                sinks.append(JSONLSink(os.path.join(self.run_dir, METRICS_FILE)))
        sinks.append(HumanLogSink(
            stream=log_stream,
            timestamps=cfg.log_timestamps if cfg is not None else False,
        ))
        self.bus = MetricsBus(sinks)
        self.tracer = (
            trace_mod.Tracer() if cfg is not None and cfg.trace else None
        )
        self.drift: DriftMonitor | None = None
        if cfg is not None and cfg.drift is not None and predicted_step_s:
            self.drift = DriftMonitor(predicted_step_s, cfg.drift)
        self._profiling = False

    # -- lifecycle ------------------------------------------------------
    def __enter__(self) -> "ObsRun":
        if self.tracer is not None:
            trace_mod.activate(self.tracer)
        if self.cfg is not None and self.cfg.torch_profiler and self.run_dir:
            self._profiling = trace_mod.start_torch_profiler(
                os.path.join(self.run_dir, PROFILE_DIR)
            )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.tracer is not None:
            trace_mod.deactivate()
            if self.run_dir:
                self.tracer.write(os.path.join(self.run_dir, TRACE_FILE))
        if self._profiling:
            trace_mod.stop_torch_profiler()
            self._profiling = False
        self.bus.close()

    # -- per-step hooks -------------------------------------------------
    def observe_step_time(self, seconds: float, step: int) -> None:
        """Record the step's wall time and feed the drift monitor: the
        EMA ratio lands in the `drift` series, band excursions in
        `drift_events` (one warning per excursion)."""
        self.bus.timing("step_time", seconds, step=step)
        if self.drift is None:
            return
        warning = self.drift.observe(seconds)
        if self.drift.ema is not None:
            self.bus.gauge("drift", self.drift.ema, step=step)
        if warning is not None:
            self.bus.event("drift_events", dict(warning, step=step), step=step)

    # -- the history view ----------------------------------------------
    def history(self) -> dict:
        """The schema-shaped history dict, folded from the ring's
        drained records (drains first)."""
        self.bus.drain()
        return history_from_records(self.ring.records)
