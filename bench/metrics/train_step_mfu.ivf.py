"""The whole step's share of the chip's peak on the IVF route: useful
FLOPs a step (`work.fopo_ivf_step_flops`: the tower, the centroid
stage, 2 L a probed live candidate by the program's own
`ivf_topk.rows` counts, the S sampled scores and their gradient, the
weight gradient) over the traced window's steps, over the window's
length at 495 TFLOP/s."""
from bench.yardstick import work
from bench.yardstick.counters import K7_ROW_FIELDS
from bench.yardstick.peaks import TF32_FLOPS


def read(ctx):
    prog, c, tr = ctx.get("program", {}), ctx["counters"], ctx["trace"]
    rows = prog.get("ivf_topk.rows")
    if not rows or not c.get("steps") or not c.get("num_clusters") or tr.busy_s <= 0:
        return None
    probed = dict(zip(K7_ROW_FIELDS, rows, strict=True))["probed_rows"]
    flops = (c["steps"] * work.fopo_ivf_step_flops(c["batch"], c["embed_dim"], c["num_samples"],
                                                   c["num_clusters"], 0.0)
             + 2.0 * c["embed_dim"] * probed)
    return 100.0 * flops / (tr.window_s * TF32_FLOPS)
