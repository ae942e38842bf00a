"""The FOPO-LM step's share of the chip's peak: the least time of a
step's useful work (`lm_work.step_least_time`: one forward and one
backward of the differentiated pass, counted by the program's backward
counters, each product at its operands' dense peak, bf16 at 989 TFLOP/s
and fp32 at 495; and the head's centroid stage, K7's probed rows by
`ivf_topk.rows`, the sampled scores and their gradient) over the traced
window's steps, over the window's length."""
from bench.yardstick import lm_work


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    if "lm" not in c or not c.get("steps") or tr.window_s <= 0:
        return None
    t = lm_work.step_least_time(c["lm"], ctx.get("program", {}), c["steps"])
    return None if t is None else 100.0 * t / tr.window_s
