"""The whole batch's share of the chip's peak: the tower's FLOPs
(`work.sasrec_tower_flops`), the centroid stage's and 2 L a probed live
candidate, summed over the traced batches, over the traced window's
length at 495 TFLOP/s."""
from bench.yardstick.peaks import TF32_FLOPS


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    if not c["batches"] or tr.busy_s <= 0:
        return None
    flops = (c["batches"] * (c["tower_flops"] + c["centroid_flops"])
             + 2.0 * c["embed_dim"] * sum(c["probed_live"]))
    return 100.0 * flops / (tr.window_s * TF32_FLOPS)
