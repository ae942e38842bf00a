"""The held and shared experts' share of their roofline: the least time
of every grouped expert product in the traced window, forward and
backward passes (`lm_work.expert_work` of the program's ``moe.rows``
fields, bf16 at 989 TFLOP/s or the bytes at 3.35 TB/s, the larger a
pass), over the device time of the kernels that compute them
(`lm_work.GROUPED_MM_KERNELS`)."""
from bench.yardstick import lm_work
from bench.yardstick.trace import device_seconds


def read(ctx):
    c, rows = ctx["counters"], ctx.get("program", {}).get("moe.rows")
    t = device_seconds(ctx["trace"], lm_work.GROUPED_MM_KERNELS)
    if "lm" not in c or not rows or t is None:
        return None
    bound = sum(lm_work.bf16_bound_s(*lm_work.expert_work(c["lm"], part, bwd))
                for part, bwd in ((rows[:3], False), (rows[3:], True)))
    return 100.0 * bound / t
