"""The device ms a batch of the retrieval batch's work before K7: every
kernel of the traced window but `ivf_topk_kernel` and the copies (the
SASRec tower's GEMMs and elementwise kernels, the centroid stage's
product and top-n_probe), over the traced batches."""

SKIP = ("ivf_topk_kernel", "Memcpy", "Memset")


def read(ctx):
    ops = ctx["trace"].ops
    batches = ctx["counters"]["batches"]
    hits = [v for k, v in ops.items() if not k.startswith(SKIP)]
    return None if not hits or not batches else 1e3 * sum(hits) / batches
