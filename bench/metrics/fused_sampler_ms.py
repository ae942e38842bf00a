"""K5's device ms a step: the in-kernel mixture sampler
(`fused_sampler_kernel`) over the traced window's steps."""
from bench.yardstick.trace import device_seconds


def read(ctx):
    t = device_seconds(ctx["trace"], ("fused_sampler_kernel",))
    steps = ctx["counters"]["steps"]
    return None if t is None or not steps else 1e3 * t / steps
