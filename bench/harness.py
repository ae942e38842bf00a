"""The harness: one run of one cell, driven by `BENCHMARK.json`.

A cell names a configuration and a traffic mix. The configuration is
`bench/configs/<config>.json` (the sizes as run), the traffic
`bench/traffic/<traffic>.json` (its parameters and the name of the
driver that runs it, `bench/drivers/<driver>.py`), the limits of its
correctness numbers `bench/limits/<cell>.json`, and each per-layer
metric is read by `bench/metrics/<metric>.py`. A later cell, mix or
metric is a new file and a new entry, found by its name.

A run: set-up (inputs made on the device from the seed, the program
built and warmed, its first steps driven), then the measured window of
``seconds``, then the judge (the program's state freed, the reference
run, each number held to its limit). With ``trace`` a run of its own
traces a steady part of the window with `torch.profiler` and reports
the per-layer metrics and a breakdown instead of the end-to-end ones.

A per-layer metric's reader gets ``ctx``: ``trace`` (the traced
window's `TraceSummary`), ``window`` (its stats), ``counters`` (the
driver's own counts of the window's work, `Run.counters`) and
``program`` (the program's own counter totals over the traced window,
`repro_torch.obs.trace.Tracer.counter_totals`; empty where it counted
nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from bench.yardstick import trace as trace_mod

__all__ = ["FORBIDDEN", "ROOT", "PhaseClock", "bench_span", "forbidden_modules", "run_cell"]

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names
PRE_ROLL = 0.25  # share of the window run untraced before the traced part

_PROFILING = False


@contextlib.contextmanager
def bench_span(name: str):
    """A host span around a call into a layer; recorded only while a
    traced window runs."""
    if not _PROFILING:
        yield
        return
    with torch.profiler.record_function(trace_mod.SPAN_PREFIX + name):
        yield


class PhaseClock:
    """Seconds of each phase of a set-up, each ended once the device has
    finished the phase's work."""

    def __init__(self, device: torch.device):
        self.device, self.t, self.phases = device, time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names among ``modules`` (default: the loaded ones)
    that are one of `FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of `BENCHMARK.json` with everything it names loaded."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    driver: object

    @classmethod
    def find(cls, name: str) -> "Cell":
        bm = load_json(ROOT / "BENCHMARK.json")
        wl = next((w for w in bm["workloads"] if w["name"] == name), None)
        if wl is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg = next(c for c in bm["configs"] if c["name"] == wl["config"])
        traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")

        def mine(metric):
            return name in metric.get("workloads", [name])

        e2e = [m for m in bm["end_to_end"] if mine(m)]
        layer = [m for m in bm["per_layer"]
                 if mine(m) and any(e["name"] == m["moves"] for e in e2e)]
        return cls(
            name=name,
            config=load_json(ROOT / cfg["file"]),
            traffic=traffic,
            limits=load_json(BENCH / "limits" / f"{name}.json"),
            end_to_end=e2e,
            per_layer=layer,
            driver=importlib.import_module(f"bench.drivers.{traffic['driver']}"),
        )


def read_metric(name: str, ctx: dict):
    """The value of per-layer metric ``name`` from its reader, or None
    when its reader found nothing to read."""
    mod = _load_file(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")
    value = mod.read(ctx)
    return None if value is None else float(value)


def run_window(run, seconds: float) -> dict:
    """Run units back to back for ``seconds``; returns the window's stats."""
    run.window_begin()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    units = 0
    while units == 0 or time.perf_counter() < deadline:
        run.run_unit()
        units += 1
    stats = run.window_end()
    stats["elapsed_s"] = time.perf_counter() - t0
    stats["units"] = units
    return stats


def _traced_window(run, seconds: float) -> tuple[dict, trace_mod.TraceSummary, dict]:
    """A quarter of the window untraced, then up to ``run.trace_seconds``
    under `torch.profiler` with a `repro_torch.obs.trace.Tracer` active:
    (the traced part's stats, its trace, the program's counter totals).
    The tracer's spans open ``span:<name>`` ranges while the profiler
    records, so the program's phases name the device's idle gaps; its
    counters are read once the device has finished the window."""
    global _PROFILING
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as obs_trace

    run_window(run, seconds * PRE_ROLL)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    tracer = obs_trace.Tracer()
    traced = min(seconds, float(run.trace_seconds))
    with profile(activities=activities) as prof:
        _PROFILING = True
        obs_trace.activate(tracer)
        try:
            with bench_span(trace_mod.WINDOW):
                stats = run_window(run, traced)
        finally:
            obs_trace.deactivate()
            _PROFILING = False
        if cuda:
            torch.cuda.synchronize()
    return stats, trace_mod.summarize(trace_mod.profiler_events(prof)), tracer.counter_totals()


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _finite(x: float) -> float:
    """``x`` as JSON can hold it; a number that is not one reads as huge."""
    return x if math.isfinite(x) else (-1e300 if x < 0 else 1e300)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> tuple[dict, list[str]]:
    """One run of ``workload``: (the result object, the lines for standard
    error: the set-up's phases, the window's notes, then each compared
    number beside its limit). The overrides shrink a cell for the CPU
    tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell.find(workload)
    config = {**cell.config, **(config_overrides or {})}
    traffic = {**cell.traffic, **(traffic_overrides or {})}
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_run = time.perf_counter()
    run = cell.driver.Run(config, traffic, seed, device)
    # what set-up made stays out of the collector's full passes in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if trace:
        stats, summary, program = _traced_window(run, seconds)
    else:
        stats, summary, program = run_window(run, seconds), None, {}
    gc.unfreeze()
    dev_info = device_info(device)
    attempted, failed = run.attempted_failed(stats)
    ctx = {"trace": summary, "window": stats, "counters": run.counters(stats),
           "program": program} if trace else None
    numbers = run.judge()
    checks = {k: {"value": _finite(float(numbers[k])), "limit": float(v)}
              for k, v in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and not failed
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
    else:
        values = dict(run.end_to_end(stats), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.top_idle()}
    result["checks"] = checks
    phases = {"start": t_run - t_start, **run.phases.phases}
    lines = ["set-up phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
             f"window: {json.dumps(stats.get('notes', {}))}"]
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}" for k, c in checks.items()]
    if failed:
        lines.append(f"check failed_operations: {failed} of {attempted} FAILED")
    return result, lines
