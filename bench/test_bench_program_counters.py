"""The program's own spans and counters in the tiny cells on the CPU:
what its counts of K7's rows give against the bulk cell's own
recount (`recsys_bulk.Run.counters`), the traced training run's
`train_load_ms`, the counter totals a traced run hands its readers as
``ctx["program"]``, and the readers of those counters."""
from __future__ import annotations

import pytest

from bench import harness
from bench.harness import run_window
from bench.tinycells import tiny_driver, tiny_run
from bench.yardstick import counters, work
from bench.yardstick.peaks import bound_s
from bench.yardstick.trace import TraceSummary

TRAINING = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
            if w["config"] == "fopo-paper"]


def test_program_counts_the_rows_the_bulk_cell_recounts():
    """Every batch of a window, counted by `ivf_topk` from its own probe
    ids, gives the live rows probed and their union exactly as
    `recsys_bulk.Run.counters` recomputes them outside the window."""
    from repro_torch.obs.trace import Tracer, tracing

    run = tiny_driver("sasrec.bulk-b4096", 2**31 + 11)
    tracer = Tracer()
    with tracing(tracer):
        stats = run_window(run, 0.3)
    totals = tracer.counter_totals()
    probed, union, _, _ = totals["ivf_topk.rows"]
    c = run.counters(stats)
    assert c["batches"] > 0
    assert totals["ivf_topk.queries"] == c["batches"] * c["batch"]
    assert probed == sum(c["probed_live"]) and union == sum(c["union_live"])


def test_tiny_traced_training_run_reports_train_load_ms():
    result, _ = tiny_run("fopo-paper.exact-b4096", seed=2**31 + 5, trace=True)
    assert result["correct"] and result["metrics"]["train_load_ms"]["value"] > 0


def _traced_ctx(workload: str, seed: int, monkeypatch) -> tuple[dict, dict]:
    """(the result, the ``ctx`` its readers got) of a tiny traced run."""
    seen = {}
    read = harness.read_metric

    def spy(name, ctx):
        seen["ctx"] = ctx
        return read(name, ctx)

    monkeypatch.setattr(harness, "read_metric", spy)
    result, _ = tiny_run(workload, seed=seed, trace=True)
    return result, seen["ctx"]


@pytest.mark.parametrize("workload", TRAINING)
def test_traced_run_hands_the_program_counters_to_the_readers(workload, monkeypatch):
    result, ctx = _traced_ctx(workload, 2**31 + 13, monkeypatch)
    assert result["correct"]
    program, steps = ctx["program"], ctx["counters"]["steps"]
    assert steps > 0 and program["loader.batches"] == steps
    if ctx["counters"]["n_probe"]:  # the IVF route: K7's counts of the traced steps
        assert program["ivf_topk.queries"] == steps * ctx["counters"]["batch"]
        probed, union, d_probed, d_union = program["ivf_topk.rows"]
        assert probed >= union > 0 and d_probed == d_union == 0
    else:
        assert "ivf_topk.rows" not in program


def _with_device_time(ctx: dict, ops: dict) -> dict:
    """``ctx`` with a trace whose device ran ``ops`` (name -> seconds): on
    the CPU no kernel reaches the profiler's device track."""
    trace = TraceSummary(window_s=1.0, busy_s=sum(ops.values()), ops=ops,
                         op_counts=dict.fromkeys(ops, 1), spans={}, idle={})
    return dict(ctx, trace=trace)


def test_ivf_route_readers_read_the_programs_rows(monkeypatch):
    _, ctx = _traced_ctx("fopo-paper.ivf-b4096", 2**31 + 17, monkeypatch)
    assert harness.read_metric("ivf_topk_roofline.train", ctx) is None  # no device time
    t = 0.25
    ctx = _with_device_time(ctx, {"ivf_topk_kernel<1, 2>": t, "fused_sampler_kernel": 1.0})
    value = harness.read_metric("ivf_topk_roofline.train", ctx)
    c, prog = ctx["counters"], ctx["program"]
    probed, union = prog["ivf_topk.rows"][:2]
    batches = prog["ivf_topk.queries"] / c["batch"]
    flops, nbytes = work.ivf_probe(c["batch"], c["embed_dim"], c["top_k"], c["n_probe"],
                                   union / batches, probed / batches)
    assert value == pytest.approx(100.0 * batches * bound_s(nbytes, flops)[0] / t, rel=1e-12)
    assert 0.0 < value < 100.0
    mfu = harness.read_metric("train_step_mfu.ivf", ctx)
    step = work.fopo_ivf_step_flops(c["batch"], c["embed_dim"], c["num_samples"],
                                    c["num_clusters"], probed / c["steps"])
    assert mfu == pytest.approx(100.0 * c["steps"] * step / (ctx["trace"].window_s * 495e12),
                                rel=1e-12)


def test_k6_readers_split_the_probe_kernels_time_by_its_cycles():
    """`mips_select_ms` and `mips_stage_wait_ms` as
    `tools/probe_program_counters.py` splits K6's cycles: a field's share
    of the scoring warps' counted cycles times the probe kernel's device
    ms a step."""
    k6 = dict(zip(counters.K6_FIELDS, (4096, 10, 20, 30, 110, 480, 205, 205), strict=True))
    ctx = _with_device_time(
        {"window": {}, "counters": {"steps": 4}, "program": {"mips_topk": list(k6.values())}},
        {"mips_probe_kernel<true, true>": 0.144, "mips_merge_kernel": 0.002})
    assert harness.read_metric("mips_select_ms", ctx) == pytest.approx(36.0 * 0.41)
    assert harness.read_metric("mips_stage_wait_ms", ctx) == pytest.approx(36.0 * 0.11)
    silent = dict(ctx, program={})
    assert harness.read_metric("mips_select_ms", silent) is None
    assert harness.read_metric("mips_stage_wait_ms", silent) is None


def test_frozen_counter_fields_are_the_programs():
    from repro_torch.kernels.ivf_topk.ops import ROW_FIELDS
    from repro_torch.kernels.mips_topk.kernel import COUNT_FIELDS

    assert counters.K6_FIELDS == COUNT_FIELDS
    assert counters.K7_ROW_FIELDS == ROW_FIELDS
