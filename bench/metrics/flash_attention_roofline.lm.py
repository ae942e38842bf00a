"""K9's and K10's share of their roofline in the FOPO-LM step: the least
time of every attention call of the traced window (`lm_work.attention_work`
of the program's ``attention.pairs.*`` counts, forward and backward, bf16
at 989 TFLOP/s or the bytes at 3.35 TB/s, the larger) over the device
time of `flash_fwd_kernel`, `flash_bwd_dq_kernel` and
`flash_bwd_dkv_kernel`."""
from bench.yardstick import lm_work
from bench.yardstick.trace import device_seconds


def read(ctx):
    c, prog = ctx["counters"], ctx.get("program", {})
    t = device_seconds(ctx["trace"], lm_work.ATTN_KERNELS)
    fwd = [prog.get(f"attention.pairs.{k}") for k in ("sliding", "full")]
    bwd = [prog.get(f"attention.pairs.{k}_backward") for k in ("sliding", "full")]
    if "lm" not in c or t is None or None in fwd + bwd:
        return None
    bound = sum(lm_work.bf16_bound_s(*lm_work.attention_work(c["lm"], sum(p), b))
                for p, b in ((fwd, False), (bwd, True)))
    return 100.0 * bound / t
