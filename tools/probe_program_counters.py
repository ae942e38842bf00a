#!/usr/bin/env python3
"""The program's own spans and counters in one of the benchmark's cells,
beside the benchmark's outside readings, and what an active tracer
costs the cell's rate, on one CUDA card.

    python3 tools/probe_program_counters.py --cell <workload> [--seconds S] [--seed N]

Run from the root of a checkout. The cell's `Run` (`bench/drivers`) is
set up at the cell's full size, then four windows of S seconds run back
to back: with no tracer, with a `repro_torch.obs.trace.Tracer` active,
with one again, with none (off, on, on, off); each window's rate is the
cell's end-to-end metric (`Run.end_to_end`). After each traced window
the card is synchronised and the tracer's counters read
(`Tracer.counter_totals`).

fopo-paper.exact-b4096: the mean host ms a step of the program's
`load`, `permute`, `gather`, `h2d`, `dispatch` and `drain` spans, and
K6's counts (`kernels/mips_topk/kernel.py:COUNT_FIELDS`) with the share
of the scoring warps' cycles in each phase, and each traced window's
loader counts (`loader.batches`, `loader.permutations`) with their hit
share, 1 - permutations / batches (none where the loader counts
nothing). sasrec.bulk-b4096: the program's probed and union rows
(`kernels/ivf_topk/ops.py`) against the cell's own recount of the same
batches (`Run.counters`), and the bound of `ivf_topk_roofline.serve`
(`work.ivf_probe` at 3.35 TB/s and 495 TFLOP/s) from each: the outside
count batch by batch, the program's from its totals, as many batches
of their mean. Prints the card and one JSON line; exits 2 without a
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PIN_CORES = 2  # as bench/run.py pins a run
SPANS = ("load", "permute", "gather", "h2d", "dispatch", "drain")


def window(run, seconds: float, traced: bool) -> tuple[dict, dict, list]:
    """(window stats, counter totals, span events) of one window."""
    import torch

    from bench.harness import run_window
    from repro_torch.obs.trace import Tracer, tracing

    if not traced:
        return run_window(run, seconds), {}, []
    tracer = Tracer()
    with tracing(tracer):
        stats = run_window(run, seconds)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return stats, tracer.counter_totals(), tracer.events


def train_report(traced: list) -> dict:
    from repro_torch.kernels.mips_topk.kernel import COUNT_FIELDS

    stats, totals, events = traced[-1]
    steps = stats["steps"]
    spans = {n: [e["dur"] for e in events if e["name"] == n] for n in SPANS}
    k6 = dict(zip(COUNT_FIELDS, totals["mips_topk"]))
    cycles = {f: k6[f] for f in COUNT_FIELDS[4:]}
    all_cycles = sum(cycles.values()) or 1  # none on the CPU
    return {
        "steps": steps,
        "span_ms_a_step": {n: sum(v) / 1e3 / steps for n, v in spans.items() if v},
        "span_calls": {n: len(v) for n, v in spans.items()},
        "k6": k6,
        "k6_per_step": {f: k6[f] / steps for f in COUNT_FIELDS[:4]},
        "k6_cycle_share": {f: c / all_cycles for f, c in cycles.items()},
        "loader": [loader_counts(t) for _, t, _ in traced if "loader.batches" in t],
    }


def loader_counts(totals: dict) -> dict:
    batches, draws = totals["loader.batches"], totals.get("loader.permutations", 0)
    return {"batches": batches, "permutations": draws, "hit_share": 1 - draws / batches}


def probe_bound_s(c: dict, union: float, probed: float) -> float:
    """`ivf_topk_roofline.serve`'s least time of one batch."""
    from bench.yardstick import work
    from bench.yardstick.peaks import bound_s

    flops, nbytes = work.ivf_probe(c["batch"], c["embed_dim"], c["top_k"], c["n_probe"], union,
                                   probed)
    return bound_s(nbytes, flops)[0]


def bulk_report(run, traced: list) -> dict:
    out = []
    for stats, totals, _ in traced:
        c = run.counters(stats)
        batches = totals["ivf_topk.queries"] / c["batch"]
        probed, union, d_probed, d_union = totals["ivf_topk.rows"]
        serve = sum(probe_bound_s(c, u, p)
                    for u, p in zip(c["union_live"], c["probed_live"], strict=True))
        counted = batches * probe_bound_s(c, union / batches, probed / batches)
        out.append({
            "batches_window": c["batches"], "batches_counted": batches,
            "probed_rows": {"program": probed, "outside": sum(c["probed_live"])},
            "union_rows": {"program": union, "outside": sum(c["union_live"])},
            "delta_rows": {"probed": d_probed, "union": d_union},
            "bound_s": {"counted": counted, "serve": serve},
            "counted_over_serve": counted / serve,
        })
    return {"windows": out}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=3_141_592_653)
    args = ap.parse_args(argv)
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > PIN_CORES:
        os.sched_setaffinity(0, cores[-PIN_CORES:])
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("probe_program_counters: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cell = harness.Cell.find(args.cell)
    metric = next(m["name"] for m in cell.end_to_end if m["name"] != "setup_s")
    run = cell.driver.Run(cell.config, cell.traffic, args.seed, torch.device("cuda"))
    rates, traced = [], []
    for on in (False, True, True, False):
        w = window(run, args.seconds, on)
        rates.append({"traced": on, metric: run.end_to_end(w[0])[metric]})
        if on:
            traced.append(w)
    off = [r[metric] for r in rates if not r["traced"]]
    on_ = [r[metric] for r in rates if r["traced"]]
    res = {"cell": args.cell, "seed": args.seed, "seconds": args.seconds, "card": card,
           "rates": rates, "traced_over_untraced": sum(on_) / sum(off)}
    if "steps" in traced[-1][0]:
        res.update(train_report(traced))
    else:
        res.update(bulk_report(run, traced))
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
