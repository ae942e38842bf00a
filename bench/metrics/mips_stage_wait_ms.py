"""K6's waits a step: the device ms of its probe kernel
(`mips_probe_kernel`) a step times the share of its scoring warps'
cycles spent waiting for the next catalog stage to land, by the
program's own `mips_topk` counters over the traced window."""
from bench.yardstick.counters import k6_cycle_ms


def read(ctx):
    return k6_cycle_ms(ctx, ("wait_cycles",))
