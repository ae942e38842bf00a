"""The whole step's share of the chip's peak: useful FLOPs a step (the
tower, the 2 B P L scoring, the S sampled scores and their gradient, the
weight gradient; `work.fopo_step_flops`) times the traced window's
steps, over the window's length at 495 TFLOP/s."""
from bench.yardstick.peaks import TF32_FLOPS


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    if not c["steps"] or tr.busy_s <= 0:
        return None
    return 100.0 * c["step_flops"] * c["steps"] / (tr.window_s * TF32_FLOPS)
