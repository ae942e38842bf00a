"""K7's share of its roofline a training step: the least time of the
steps' IVF probes over the device time of `ivf_topk_kernel` in the
traced window. The work comes from the program's own counts of the
traced window (`ivf_topk.queries`, and `ivf_topk.rows`: the live rows
each query's lists hold, summed over the queries, and those of the
union of each batch's probed lists), charged as `work.ivf_probe`
charges a batch (the union's rows each read once with its id, the
queries and probe ids read and the top-K written, at 3.35 TB/s; 2 L
FLOPs a probed live candidate at 495 TFLOP/s; the larger), each step
its mean batch."""
from bench.yardstick import work
from bench.yardstick.counters import K7_ROW_FIELDS
from bench.yardstick.peaks import bound_s
from bench.yardstick.trace import device_seconds


def read(ctx):
    prog, c = ctx.get("program", {}), ctx["counters"]
    rows, queries = prog.get("ivf_topk.rows"), prog.get("ivf_topk.queries")
    t = device_seconds(ctx["trace"], ("ivf_topk_kernel",))
    if not rows or not queries or t is None or not c.get("n_probe"):
        return None
    rows = dict(zip(K7_ROW_FIELDS, rows, strict=True))
    batches = queries / c["batch"]
    flops, nbytes = work.ivf_probe(c["batch"], c["embed_dim"], c["top_k"], c["n_probe"],
                                   rows["union_rows"] / batches, rows["probed_rows"] / batches)
    return 100.0 * batches * bound_s(nbytes, flops)[0] / t
