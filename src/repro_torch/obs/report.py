"""Run report: render a run dir's metrics.jsonl into markdown.

    PYTHONPATH=src python -m repro_torch.obs.report <run_dir> [-o out.md]

Reads the JSONL record stream a telemetry-enabled run left behind
(`ObsConfig(run_dir=...)`) and writes ``<run_dir>/report.md``:
loss/ESS/step-time percentiles, the health-event timeline, index-ladder
escalations, and the roofline-drift series (as plot-ready CSV data).
The report is the human end of the pipe whose machine end is the JSONL
itself — dashboards should read the records, people read this.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.obs.run import METRICS_FILE
from repro_torch.obs.schema import (
    EVENT_KEYS,
    SERIES_KEYS,
    SERVE_CLUSTER_COUNTER_KEYS,
    SERVE_CLUSTER_TIMING_KEYS,
    SERVE_GAUGE_KEYS,
    SERVE_TIMING_KEYS,
)

__all__ = ["load_records", "percentile", "render", "render_run"]

PCTS = (50, 90, 99)


def load_records(run_dir: str) -> list[dict]:
    path = os.path.join(run_dir, METRICS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — run with ObsConfig(run_dir={run_dir!r}) first"
        )
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile (no numpy dependency in the renderer)."""
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, round(p / 100.0 * (len(vs) - 1))))
    return vs[idx]


def _series(records: list[dict]) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for r in records:
        if r.get("kind") in ("gauge", "timing") and r.get("name") in SERIES_KEYS:
            out.setdefault(r["name"], []).append(r["value"])
    return out


def _serve_series(records: list[dict]) -> dict[str, list[float]]:
    keys = set(SERVE_TIMING_KEYS) | set(SERVE_GAUGE_KEYS)
    out: dict[str, list[float]] = {}
    for r in records:
        if r.get("kind") in ("gauge", "timing") and r.get("name") in keys:
            out.setdefault(r["name"], []).append(r["value"])
    return out


def _events(records: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for r in records:
        if r.get("kind") == "event" and r.get("name") in EVENT_KEYS:
            out.setdefault(r["name"], []).append(r["value"] or {})
    return out


def render(records: list[dict], title: str = "Run report") -> str:
    series, events = _series(records), _events(records)
    lines = [f"# {title}", ""]
    steps = [r.get("step") for r in records if r.get("step") is not None]
    span = f"steps {min(steps)}–{max(steps)}" if steps else "no steps"
    lines += [f"{len(records)} records, {span}.", ""]

    # -- step-metric percentiles ---------------------------------------
    lines += ["## Step metrics", ""]
    header = "| metric | n | " + " | ".join(f"p{p}" for p in PCTS) + " | last |"
    lines += [header, "|---|---|" + "---|" * (len(PCTS) + 1)]
    for name in SERIES_KEYS:
        vs = series.get(name)
        if not vs:
            continue
        pcts = " | ".join(f"{percentile(vs, p):.6g}" for p in PCTS)
        lines.append(f"| {name} | {len(vs)} | {pcts} | {vs[-1]:.6g} |")
    lines.append("")

    # -- health timeline -----------------------------------------------
    health = events.get("health", [])
    rollbacks = events.get("events", [])
    lines += ["## Health events", ""]
    if not health and not rollbacks:
        lines += ["No health events — clean run.", ""]
    else:
        lines += ["| step | event | detail |", "|---|---|---|"]
        timeline = [
            (e.get("step", -1), "verdict", ",".join(e.get("checks", [])) or str(e))
            for e in health
        ] + [
            (e.get("step", -1), e.get("event", "event"),
             f"to step {e['to']} (restart #{e['restarts']})"
             if e.get("event") == "rollback" else json.dumps(e))
            for e in rollbacks
        ]
        for step, kind, detail in sorted(timeline):
            lines.append(f"| {step} | {kind} | {detail} |")
        lines.append("")

    # -- serving --------------------------------------------------------
    serve = _serve_series(records)
    if serve.get("serve_latency"):
        lats = serve["serve_latency"]
        waits = serve.get("serve_queue_wait", [])
        sizes = serve.get("serve_batch_size", [])
        occ = serve.get("serve_occupancy", [])
        lines += ["## Serving", ""]
        lines += [
            f"{len(lats)} requests in {len(sizes)} batches — mean batch "
            f"size {sum(sizes) / len(sizes):.2f}, mean occupancy "
            f"{sum(occ) / len(occ):.2f}." if sizes else
            f"{len(lats)} requests.", "",
        ]
        header = "| metric (ms) | n | " + " | ".join(f"p{p}" for p in PCTS) + " | max |"
        lines += [header, "|---|---|" + "---|" * (len(PCTS) + 1)]
        for name, vs in (("e2e latency", lats), ("queue wait", waits),
                         ("batch service", serve.get("serve_batch_service", []))):
            if not vs:
                continue
            pcts = " | ".join(f"{percentile(vs, p) * 1e3:.3g}" for p in PCTS)
            lines.append(f"| {name} | {len(vs)} | {pcts} | {max(vs) * 1e3:.3g} |")
        lines.append("")

    # -- cluster --------------------------------------------------------
    cluster_t: dict[str, list[float]] = {}
    counters: dict[str, float] = {}
    replicas: dict[int, dict[str, float]] = {}
    for r in records:
        name, kind = r.get("name"), r.get("kind")
        if kind == "timing" and name in SERVE_CLUSTER_TIMING_KEYS:
            cluster_t.setdefault(name, []).append(r["value"])
        elif kind == "counter" and name in SERVE_CLUSTER_COUNTER_KEYS:
            counters[name] = counters.get(name, 0.0) + r["value"]
        rep = (r.get("labels") or {}).get("replica")
        if rep is not None and kind in ("gauge", "timing", "counter"):
            slot = replicas.setdefault(int(rep), {"batches": 0, "requests": 0})
            if name == "serve_batch_size":
                slot["batches"] += 1
                slot["requests"] += int(r["value"])
            elif name == "serve_abandoned":
                slot["abandoned"] = slot.get("abandoned", 0) + int(r["value"])
    if cluster_t or replicas:
        lines += ["## Cluster", ""]
        if counters:
            lines += ["| counter | total |", "|---|---|"]
            for name in SERVE_CLUSTER_COUNTER_KEYS:
                if name in counters:
                    lines.append(f"| {name} | {counters[name]:g} |")
            lines.append("")
        if cluster_t:
            header = (
                "| metric (ms) | n | " + " | ".join(f"p{p}" for p in PCTS) + " | max |"
            )
            lines += [header, "|---|---|" + "---|" * (len(PCTS) + 1)]
            for name, label in (
                ("serve_cluster_latency", "cluster e2e latency"),
                ("serve_cluster_queue_wait", "cluster queue wait"),
            ):
                vs = cluster_t.get(name)
                if not vs:
                    continue
                pcts = " | ".join(f"{percentile(vs, p) * 1e3:.3g}" for p in PCTS)
                lines.append(f"| {label} | {len(vs)} | {pcts} | {max(vs) * 1e3:.3g} |")
            lines.append("")
        if replicas:
            lines += ["| replica | batches | requests | abandoned |", "|---|---|---|---|"]
            for rep in sorted(replicas):
                slot = replicas[rep]
                lines.append(
                    f"| {rep} | {slot['batches']} | {slot['requests']} | "
                    f"{slot.get('abandoned', 0)} |"
                )
            lines.append("")

    # -- index ladder ---------------------------------------------------
    probes = events.get("index_health", [])
    if probes:
        lines += ["## Index health (degradation ladder)", "",
                  "| step | recall | overflow | action |", "|---|---|---|---|"]
        for e in probes:
            recall = e.get("recall")
            lines.append(
                f"| {e.get('step', '—')} | "
                f"{recall if recall is None else f'{recall:.3f}'} | "
                f"{e.get('overflow', 0)} | {e.get('action') or '—'} |"
            )
        lines.append("")

    # -- roofline drift -------------------------------------------------
    drift = series.get("drift")
    if drift:
        warns = events.get("drift_events", [])
        lines += ["## Roofline drift", ""]
        lines += [
            f"{len(drift)} drift-ratio points (measured / analytic model, "
            f"EMA, calibrated); {len(warns)} band excursion(s).", "",
        ]
        for w in warns:
            lines.append(
                f"- step {w.get('step', '—')}: drifted **{w['direction']}** "
                f"(ema {w['ema']:.3f}, band ±{w['band']:.2f})"
            )
        if warns:
            lines.append("")
        # plot-ready data block: (index, ratio) CSV
        lines += ["```csv", "point,drift_ratio"]
        lines += [f"{i},{v:.6f}" for i, v in enumerate(drift)]
        lines += ["```", ""]

    return "\n".join(lines)


def render_run(run_dir: str, out: str | None = None) -> str:
    """Render ``run_dir``'s stream and write the markdown (default
    <run_dir>/report.md). Returns the output path."""
    text = render(load_records(run_dir), title=f"Run report — {run_dir}")
    out = out or os.path.join(run_dir, "report.md")
    with open(out, "w") as f:
        f.write(text)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("run_dir")
    ap.add_argument("-o", "--out", default=None, help="output path (default <run_dir>/report.md)")
    args = ap.parse_args(argv)
    out = render_run(args.run_dir, args.out)
    print(out)


if __name__ == "__main__":
    main()
