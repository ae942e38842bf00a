"""repro_torch.obs: the telemetry spine of the port.

  bus      `MetricsBus`: typed counters / gauges / timings / events with
           labels; a record call never reads a device value (device
           scalars are stored as they are and read at drain, after the
           owner's synchronize); pluggable sinks (in-memory ring, JSONL
           file, human log lines)
  trace    `span("retrieval")` phase spans -> Chrome-trace JSON, and
           config-gated `torch.profiler` sessions
  drift    `DriftMonitor`: measured step time against the analytic byte
           model, an EMA ratio with hysteresis warnings
  schema   the declared history schema (`validate_history` rejects
           undeclared keys) and the serving and cluster keys
  report   `python -m repro_torch.obs.report <run_dir>` renders the JSONL
           stream into a markdown run report

`ObsRun` / `ObsConfig` (repro_torch.obs.run) bundle all of it for one
run; the trainer takes `TrainerConfig(obs=ObsConfig(...))`.
"""
from repro_torch.obs.bus import MetricsBus
from repro_torch.obs.drift import DriftConfig, DriftMonitor
from repro_torch.obs.run import ObsConfig, ObsRun
from repro_torch.obs.schema import HISTORY_SCHEMA, validate_history
from repro_torch.obs.sinks import HumanLogSink, JSONLSink, RingSink
from repro_torch.obs.trace import Tracer, span, tracing

__all__ = [
    "DriftConfig",
    "DriftMonitor",
    "HISTORY_SCHEMA",
    "HumanLogSink",
    "JSONLSink",
    "MetricsBus",
    "ObsConfig",
    "ObsRun",
    "RingSink",
    "Tracer",
    "span",
    "tracing",
    "validate_history",
]
