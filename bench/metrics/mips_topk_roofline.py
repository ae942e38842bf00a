"""K6's share of its roofline a step: the least time of the exact top-K
(2 B P L FLOPs of fp32 operands at 495 TFLOP/s, or the catalog and
queries read once and the top-K written once at 3.35 TB/s, the larger)
over the device time of its kernels (`mips_sample`, `mips_floor`,
`mips_probe`, `mips_merge`) in the traced window, a step."""
from bench.yardstick import work
from bench.yardstick.peaks import bound_s
from bench.yardstick.trace import device_seconds


def read(ctx):
    c = ctx["counters"]
    t = device_seconds(ctx["trace"], ("mips_",))
    if t is None or not c["steps"]:
        return None
    flops, nbytes = work.mips_topk(c["batch"], c["num_items"], c["embed_dim"], c["top_k"])
    bound, _ = bound_s(nbytes, flops)
    return 100.0 * bound * c["steps"] / t
