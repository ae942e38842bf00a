"""K2 + K4's device ms a step: the covgrad forward (`snis_fwd_*`) and
backward (`snis_bwd_*`) kernels over the traced window's steps."""
from bench.yardstick.trace import device_seconds


def read(ctx):
    t = device_seconds(ctx["trace"], ("snis_fwd_", "snis_bwd_"))
    steps = ctx["counters"]["steps"]
    return None if t is None or not steps else 1e3 * t / steps
