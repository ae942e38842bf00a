"""The program's own counters as the readers take them: the fields of
each counter buffer, frozen here so that a change to the program shows
as a failing test (`bench/test_bench_program_counters.py`) and not as a
reading that quietly means something else.

- `K6_FIELDS` is `repro_torch.kernels.mips_topk.kernel.COUNT_FIELDS`:
  the counting probe kernel's queries, tiles, appends and folds, then
  its scoring warps' cycles waiting for a stage, in products, in
  appends and in folds.
- `K7_ROW_FIELDS` is `repro_torch.kernels.ivf_topk.ops.ROW_FIELDS`: the
  live rows of the lists each query probes, summed over the queries,
  and of the union of a batch's probed lists, for the main lists and
  the delta lists.
"""
from __future__ import annotations

from bench.yardstick.trace import device_seconds

__all__ = ["K6_FIELDS", "K7_ROW_FIELDS", "k6_cycle_ms"]

K6_FIELDS = ("queries", "tiles", "appends", "folds", "wait_cycles", "product_cycles",
             "append_cycles", "fold_cycles")
K6_CYCLES = K6_FIELDS[4:]
K7_ROW_FIELDS = ("probed_rows", "union_rows", "delta_probed_rows", "delta_union_rows")


def k6_cycle_ms(ctx: dict, fields: tuple[str, ...]) -> float | None:
    """The device ms a step of K6's probe kernel (`mips_probe_kernel`)
    spent in ``fields``: their share of the scoring warps' counted
    cycles times the kernel's device time, over the traced window's
    steps. None where the program counted nothing or the kernel did not
    run."""
    counts = ctx.get("program", {}).get("mips_topk")
    t = device_seconds(ctx["trace"], ("mips_probe_kernel",))
    steps = ctx["counters"].get("steps")
    if not counts or t is None or not steps:
        return None
    k6 = dict(zip(K6_FIELDS, counts, strict=True))
    cycles = sum(k6[f] for f in K6_CYCLES)
    if cycles <= 0:
        return None
    return 1e3 * t / steps * sum(k6[f] for f in fields) / cycles
