"""K6's selection a step: the device ms of its probe kernel
(`mips_probe_kernel`) a step times the share of its scoring warps'
cycles spent appending candidates and folding them into the running
top-K, by the program's own `mips_topk` counters over the traced
window."""
from bench.yardstick.counters import k6_cycle_ms


def read(ctx):
    return k6_cycle_ms(ctx, ("append_cycles", "fold_cycles"))
