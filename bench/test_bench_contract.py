"""`BENCHMARK.json` against the benchmark's contract, every name in it
found by the harness, and the result line a run prints (on the CPU, at a
tiny size; the card's runs are the benchmark's own)."""
from __future__ import annotations

import json
import re

import pytest

from bench import harness
from bench.tinycells import TINY, TINY_DIR, tiny_run
from bench.yardstick.trace import TraceSummary

BM = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WORKLOADS = [w["name"] for w in BM["workloads"]]
PER_LAYER = [m["name"] for m in BM["per_layer"]]


def _reported(metric: dict) -> list[str]:
    return metric.get("workloads", WORKLOADS)


def test_top_level_keys_and_limits():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert 1 <= len(BM["command"]) <= 32 and 1 <= len(BM["paths"]) <= 16
    for p in BM["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    runs = 2 + 14 * 24
    assert runs * (BM["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in BM["paths"]))
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and w["config"] in {c["name"] for c in BM["configs"]}
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BM["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]  # every cell, later ones too
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(workload):
    e2e = {m["name"] for m in BM["end_to_end"] if workload in _reported(m)}
    layer = [m for m in BM["per_layer"] if workload in _reported(m)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:  # a layer metric's cells report the metric it moves
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = harness.Cell.find(workload)
    assert hasattr(cell.driver, "Run")
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    wl = next(w for w in BM["workloads"] if w["name"] == workload)
    cfg = next(c for c in BM["configs"] if c["name"] == wl["config"])
    assert cell.config["name"] == cfg["name"] and cell.config["reduced"] == cfg["reduced"]
    assert cell.config["source"] == cfg["source"]


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_reader_found_and_silent_without_data(metric):
    empty = TraceSummary(window_s=1.0, busy_s=0.0, ops={}, op_counts={}, spans={}, idle={})
    counters = {"steps": 0, "batches": 0}
    assert harness.read_metric(metric, {"trace": empty, "window": {}, "counters": counters}) is None


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_last_line_keys(workload, trace):
    result, lines = tiny_run(workload, seed=2**31 + 7, trace=bool(trace))
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in BM["end_to_end"] if workload in _reported(m)}
        assert set(result["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert result["correct"] and set(result["checks"]) == set(harness.Cell.find(workload).limits)
    assert [line.startswith("check ") for line in lines[-len(result["checks"]):]] == [True] * len(
        result["checks"])
    json.dumps(result, allow_nan=False)
    assert workload in TINY


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_has_its_tiny_size_file(workload):
    """Every cell's CPU size is a file of its own, and `TINY` is what the
    files hold."""
    sizes = harness.load_json(TINY_DIR / f"{workload}.json")
    assert set(sizes) == {"config", "traffic"}
    assert TINY[workload] == (sizes["config"], sizes["traffic"])
    cell = harness.Cell.find(workload)
    assert set(sizes["config"]) <= set(cell.config)
    assert set(sizes["traffic"]) <= set(cell.traffic)


# the tiny sizes as a literal table held them before they became files
_FORMER_TINY = {
    "fopo-paper.exact-b4096": (
        {"num_items": 3000, "embed_dim": 16, "num_samples": 64, "top_k": 32, "num_users": 512},
        {"batch": 64, "catalog_clusters": 32, "positives_from_top": 16, "steps_per_call": 3,
         "trace_seconds": 0.3},
    ),
    "sasrec.bulk-b4096": (
        {"item_vocab": 5000, "embed_dim": 16, "seq_len": 12, "num_clusters": 64, "n_probe": 4},
        {"batch": 64, "users": 1024, "judge_every": 2, "warm_batches": 1, "ahead": 3,
         "trace_seconds": 0.3},
    ),
}


@pytest.mark.parametrize("workload", list(_FORMER_TINY))
def test_moved_tiny_sizes_are_unchanged(workload):
    assert TINY[workload] == _FORMER_TINY[workload]


def test_tinycells_names_no_cell():
    text = (harness.BENCH / "tinycells.py").read_text()
    assert not any(w in text for w in WORKLOADS)
