"""The work of a FOPO-LM step of an AFMoE model (Trinity-Mini), counted
from the configuration's shapes and the program's own counters, and what
the three readers charge it against. Nothing of the program is imported.

Counters (`repro_torch.obs.trace`, summed over the traced window):

- ``moe.rows``: six fields, `MOE_ROWS_FIELDS` for every forward pass of
  an MoE layer, then the same for every backward pass: the tokens, the
  assignments to held experts, the rows of the most loaded held expert.
- ``attention.pairs.<type>`` and ``attention.pairs.<type>_backward``
  (type "sliding" or "full"): B times the (query, key) pairs inside each
  attention call's mask, forward and backward passes.
- ``ivf_topk.rows``, ``ivf_topk.queries``: K7's, as `counters.K7_ROW_FIELDS`.

A step's useful work is one forward and one backward of the pass that is
differentiated (3x its forward products, its pass counted by the
backward counters), plus the head: the centroid stage, 2 L a probed live
candidate, the S sampled scores and their gradient. The proposal pass
and the recomputation inside the backward run on the device but are not
useful work. Each product is charged at its operands' dense peak: bf16
at 989 TFLOP/s, fp32 (the router, the head) at the TF32 rate, 495.
"""
from __future__ import annotations

import dataclasses

from bench.yardstick.peaks import HBM_BYTES_PER_S, TF32_FLOPS

__all__ = ["ATTN_KERNELS", "BF16_FLOPS", "GROUPED_MM_KERNELS", "LMShape", "MOE_ROWS_FIELDS",
           "attention_work", "bf16_bound_s", "expert_work", "live_pairs", "step_least_time"]

BF16_FLOPS = 989e12  # one H100 SXM, bf16 tensor cores, dense
BF16, F32 = 2, 4
MOE_ROWS_FIELDS = ("tokens", "held_rows", "max_expert_rows")
ATTN_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
# the kernels of `torch._grouped_mm` on the card (torch 2.11, CUDA 12.8), as its trace
# names them (the mangled name: CUTLASS's sm90 grouped GEMM), forward and backward
GROUPED_MM_KERNELS = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9x"
                      "INS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape",)


@dataclasses.dataclass(frozen=True)
class LMShape:
    d: int
    heads: int
    kv_heads: int
    dh: int
    layers: int
    dense_layers: int
    d_ff: int
    f: int  # an expert's width
    experts: int  # the router's outputs
    held: int
    shared: int
    sequences: int
    seq_len: int
    window: int
    sliding_layers: int
    num_samples: int
    num_clusters: int

    @classmethod
    def of(cls, c: dict, sequences: int, seq_len: int, num_clusters: int) -> "LMShape":
        n = c["num_hidden_layers"]
        types = c["layer_types"][:n]
        return cls(d=c["hidden_size"], heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"], dh=c["head_dim"], layers=n,
                   dense_layers=c["num_dense_layers"], d_ff=c["intermediate_size"],
                   f=c["moe_intermediate_size"], experts=c["num_experts_published"],
                   held=c["held_experts"][1] - c["held_experts"][0],
                   shared=c["num_shared_experts"], sequences=sequences, seq_len=seq_len,
                   window=c["sliding_window"],
                   sliding_layers=sum(t == "sliding_attention" for t in types),
                   num_samples=c["num_samples"], num_clusters=num_clusters)

    @property
    def tokens(self) -> int:
        return self.sequences * self.seq_len


def live_pairs(s: int, window: int | None) -> int:
    """The (query, key) pairs of a causal mask over ``s`` positions, with
    query i seeing keys i - window < j <= i where a window is given."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_work(sh: LMShape, pairs: float, backward: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of the attention calls over ``pairs`` (B x the live
    pairs, summed over the calls): each of the 2 forward products (q k^T,
    p v) or the 5 backward ones takes 2 Dh FLOPs a pair and head; the
    bytes are q, k, v (and dO, dq, dk, dv backward) read or written once a
    call in bf16 plus the fp32 row statistics, the calls being ``pairs``
    over one call's pairs, averaged over the layer types."""
    products = 5 if backward else 2
    flops = pairs * sh.heads * 2 * sh.dh * products
    per_call = (sh.sequences * (sh.sliding_layers * live_pairs(sh.seq_len, sh.window)
                                + (sh.layers - sh.sliding_layers) * live_pairs(sh.seq_len, None))
                / sh.layers)
    calls = pairs / per_call
    t, q_elems, kv_elems = sh.tokens, sh.tokens * sh.heads * sh.dh, sh.tokens * sh.kv_heads * sh.dh
    if backward:
        nbytes = (3 * q_elems + 4 * kv_elems) * BF16 + 2 * t * sh.heads * F32
    else:
        nbytes = (2 * q_elems + 2 * kv_elems) * BF16 + t * sh.heads * F32
    return flops, calls * nbytes


def expert_work(sh: LMShape, moe_rows: list, backward: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of the grouped expert products of the passes whose
    three ``moe.rows`` fields are ``moe_rows``, forward or ``backward``: 3
    products of 2 d f a row forward and 6 backward, a row each held
    assignment and each shared expert's token; the bytes are the held and
    shared experts' weights read once a call (and their gradients written
    once backward) and each row's input, its two [f] products and its
    output, in bf16."""
    fields = dict(zip(MOE_ROWS_FIELDS, moe_rows, strict=True))
    rows = fields["held_rows"] + sh.shared * fields["tokens"]
    calls = fields["tokens"] / sh.tokens
    per_row = 2 * sh.d * sh.f * 3
    weights = (sh.held + sh.shared) * 3 * sh.d * sh.f * BF16
    io = rows * (2 * sh.d + 3 * sh.f) * BF16
    if backward:
        return 2 * per_row * rows, calls * 2 * weights + 2 * io
    return per_row * rows, calls * weights + io


def _dense_forward(sh: LMShape) -> tuple[float, float]:
    """(bf16 FLOPs, fp32 FLOPs) of one pass's products outside the
    attention kernels and the experts: the q, k, v, gate and output
    projections, the dense layers' MLP, and the router (fp32)."""
    t, d = sh.tokens, sh.d
    proj = 2 * t * (2 * d * sh.heads * sh.dh + 2 * d * sh.kv_heads * sh.dh
                    + sh.heads * sh.dh * d)
    bf16 = sh.layers * proj + sh.dense_layers * 2 * t * 3 * d * sh.d_ff
    return bf16, (sh.layers - sh.dense_layers) * 2 * t * d * sh.experts


def step_least_time(sh: LMShape, program: dict, steps: int) -> float | None:
    """The least time of the useful work of ``steps`` steps, each product
    at its dtype's dense peak, from the program's counters; None where
    they are missing."""
    rows = program.get("moe.rows")
    k7 = program.get("ivf_topk.rows")
    pairs = {k: program.get(f"attention.pairs.{k}_backward") for k in ("sliding", "full")}
    if not rows or not k7 or not steps or any(v is None for v in pairs.values()):
        return None
    passes = rows[3] / (sh.tokens * (sh.layers - sh.dense_layers))
    bf16, f32 = _dense_forward(sh)
    bf16 = 3 * passes * bf16 + 3 * attention_work(sh, sum(pairs.values()), False)[0]
    bf16 += 3 * expert_work(sh, rows[3:], False)[0]
    f32 = 3 * passes * f32
    n = sh.tokens
    f32 += steps * (2 * n * sh.num_clusters * sh.d + 4 * n * sh.num_samples * sh.d)
    f32 += 2 * sh.d * k7[0]
    return bf16 / BF16_FLOPS + f32 / TF32_FLOPS


def bf16_bound_s(flops: float, nbytes: float) -> float:
    """The larger of the bf16 FLOPs over the bf16 peak and the bytes over
    the memory's."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
