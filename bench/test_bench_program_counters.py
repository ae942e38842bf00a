"""The program's own spans and counters in the tiny cells on the CPU:
what its counts of K7's rows give against the bulk cell's own
recount (`recsys_bulk.Run.counters`), and the traced training run's
`train_load_ms`."""
from __future__ import annotations

from bench.harness import run_window
from bench.tinycells import tiny_driver, tiny_run


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
