"""K7's share of its roofline a batch: the least time of the batch's IVF
probe (the live rows of the lists the batch probes, each read once with
its id, the queries and probe ids read and the top-K written, at 3.35
TB/s; 2 L FLOPs of fp32 operands for each query's live candidates at
495 TFLOP/s; the larger) over the device time of `ivf_topk_kernel`
(its main and delta passes) in the traced window."""
from bench.yardstick import work
from bench.yardstick.peaks import bound_s
from bench.yardstick.trace import device_seconds


def read(ctx):
    c = ctx["counters"]
    t = device_seconds(ctx["trace"], ("ivf_topk_kernel",))
    if t is None or not c["batches"]:
        return None
    bound = 0.0
    for union, probed in zip(c["union_live"], c["probed_live"], strict=True):
        flops, nbytes = work.ivf_probe(c["batch"], c["embed_dim"], c["top_k"], c["n_probe"],
                                       union, probed)
        bound += bound_s(nbytes, flops)[0]
    return 100.0 * bound / t
