"""The plain PyTorch versions of the flash-attention kernels.

`flash_attention_ref` is the reference's oracle
(`repro/kernels/flash_attention/ref.py`): the naive masked softmax
attention over [BH, S, D], with the [BH, Sq, Skv] score matrix
materialised, plus the per-row logsumexp the kernel also returns (a
logsumexp over the masked scores). `flash_attention_bwd_ref` is the
plain version of the backward (the reference's `flash_backward_pallas`):
the FlashAttention-2 formulas of `repro/kernels/flash_attention/
backward.py` on the materialised tiles, from the saved lse and
D = rowsum(dO * O).

Both keep the reference kernels' own ``NEG_INF = -2e38`` (not
`repro_torch.constants`'): a masked score, finite, that underflows
``exp`` to 0 against any live one. The CPU path and the tests use them;
on the card they are only the yardsticks the kernels are held to. They
count their calls in ``.calls``.

`flash_attention_mma` and `flash_attention_bwd_mma` emulate, in plain
fp32 torch, the arithmetic of the tensor-core kernels: products of the
kernels' operand terms summed in fp32 (bf16 inputs exact; the forward's
p split into three bf16 terms, the backward's p and ds into two; fp32
inputs split into tf32 terms, 3xTF32), the scale applied after the sum,
the forward's p unnormalised until the end. The tensor cores' own
accumulation, which is not IEEE, is not emulated: the kernels keep its
chains to one tile. The tests (`tests/test_torch_flash_mma.py`) hold
them to the reference by the chip gates' tolerances, and
`chip_smoke.py` holds the kernels to them on the card at the same
gates; nothing on the main path calls them.
"""
from __future__ import annotations

import torch

__all__ = [
    "NEG_INF", "flash_attention_bwd_mma", "flash_attention_bwd_ref",
    "flash_attention_mma", "flash_attention_ref", "mma_product",
]

NEG_INF = -2.0e38


def _live(sq: int, skv: int, seq_kv: int, causal: bool, window: int | None,
          q_offset: int, device) -> torch.Tensor:
    """[Sq, Skv] bool: the (query, key) pairs the masks leave live."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = kpos < seq_kv
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Skv, D]
    v: torch.Tensor,  # [BH, Skv, D]
    *,
    seq_kv: int | None = None,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [BH, Sq, D] in q's dtype, lse [BH, Sq] float32); arithmetic
    in fp32 on the inputs upcast."""
    flash_attention_ref.calls += 1
    sq, dh = q.shape[1], q.shape[2]
    skv = k.shape[1]
    seq_kv = skv if seq_kv is None else seq_kv
    scale = 1.0 / float(dh) ** 0.5
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = _live(sq, skv, seq_kv, causal, window, q_offset, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype), lse


flash_attention_ref.calls = 0


def flash_attention_bwd_ref(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Skv, D]
    v: torch.Tensor,  # [BH, Skv, D]
    do: torch.Tensor,  # [BH, Sq, D], the output's cotangent
    lse: torch.Tensor,  # [BH, Sq] float32, from the forward
    dsum: torch.Tensor,  # [BH, Sq] float32, rowsum(dO * O)
    *,
    seq_kv: int | None = None,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's dtypes; arithmetic in fp32, in the
    reference kernel's order: q scaled first; with a cap, t = tanh(s /
    cap) and the cap's derivative 1 - t^2 taken on the uncapped s; masked
    scores set to NEG_INF; p = exp(s - lse); ds = p (dp - D) (1 - t^2),
    then exactly 0 where masked; dk from the scaled q, dq scaled by the
    scale."""
    flash_attention_bwd_ref.calls += 1
    sq, dh = q.shape[1], q.shape[2]
    skv = k.shape[1]
    seq_kv = skv if seq_kv is None else seq_kv
    scale = 1.0 / float(dh) ** 0.5
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.einsum("bqd,bkd->bqk", qs, kf)
    dcap = None
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        s = logit_cap * t
        dcap = 1.0 - t * t
    mask = _live(sq, skv, seq_kv, causal, window, q_offset, q.device)[None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - dsum[..., None])
    if dcap is not None:
        ds = ds * dcap
    ds = torch.where(mask, ds, 0.0)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_ref.calls = 0


# ---------------------------------------------------------------------------
# the tensor-core kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor, *, truncate: bool = False) -> torch.Tensor:
    """x as tf32 (10 fraction bits): rounded to nearest with ties away
    from zero (add half of the dropped 13 bits to the magnitude, then
    clear them), or with ``truncate`` cut, as an mma reads an fp32
    register."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits if truncate else bits + 0x1000) & -0x2000).view(torch.float32)


def _bf16_terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x (fp32) as n bf16 terms, each the bf16 rounding of what the
    earlier ones leave; an exact bf16 x is its first term."""
    terms, rest = [], x.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def mma_product(eq: str, a: torch.Tensor, b: torch.Tensor, fp32: bool, terms: int = 2):
    """The kernels' product of operands a and b, summed in fp32.
    bf16 inputs: b exact in bf16 and a split into ``terms`` bf16 terms
    (exact when a is bf16; two terms keep ~16 bits of p or ds, three
    ~24). fp32 inputs (3xTF32): both split into big = tf32(x) + small =
    x - big, which the mma cuts to tf32; the three products but small *
    small."""
    if not fp32:
        return torch.einsum(eq, sum(_bf16_terms(a, terms)), b.float())  # the sum is exact
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a.float() - ab, truncate=True), _tf32(b.float() - bb, truncate=True)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)) + torch.einsum(eq, ab, bb)


def flash_attention_mma(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BKV, Skv, D], BH a multiple of BKV (GQA)
    v: torch.Tensor,  # [BKV, Skv, D]
    *,
    seq_kv: int | None = None,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [BH, Sq, D] in q's dtype, lse [BH, Sq] float32) as K9's
    tensor-core arithmetic computes them: s = scale * (q k^T), p =
    exp(s - max) unnormalised (three bf16 terms for bf16 inputs), out =
    (p v) / sum p. q's row i reads k's and v's row i // (BH / BKV)."""
    n_rep = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(n_rep, 0), v.repeat_interleave(n_rep, 0)
    sq, dh = q.shape[1], q.shape[2]
    skv = k.shape[1]
    seq_kv = skv if seq_kv is None else seq_kv
    fp32 = q.dtype == torch.float32
    scale = 1.0 / float(dh) ** 0.5
    s = mma_product("bqd,bkd->bqk", q, k, fp32) * scale
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = _live(sq, skv, seq_kv, causal, window, q_offset, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = mma_product("bqk,bkd->bqd", p, v, fp32, terms=3) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_mma(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BKV, Skv, D], BH a multiple of BKV (GQA)
    v: torch.Tensor,  # [BKV, Skv, D]
    do: torch.Tensor,  # [BH, Sq, D]
    lse: torch.Tensor,  # [BH, Sq] float32
    dsum: torch.Tensor,  # [BH, Sq] float32
    *,
    seq_kv: int | None = None,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes as K10's tensor-core arithmetic
    computes them: s and dp as products of the inputs, p and ds split
    for dv = p^T dO, dq = scale * (ds k) and dk = scale * (ds^T q); dk
    and dv of a GQA group summed in fp32 and rounded once."""
    n_rep = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(n_rep, 0), v.repeat_interleave(n_rep, 0)
    sq, dh = q.shape[1], q.shape[2]
    skv = k.shape[1]
    seq_kv = skv if seq_kv is None else seq_kv
    fp32 = q.dtype == torch.float32
    scale = 1.0 / float(dh) ** 0.5
    s = mma_product("bqd,bkd->bqk", q, k, fp32) * scale
    dcap = None
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        s = logit_cap * t
        dcap = 1.0 - t * t
    mask = _live(sq, skv, seq_kv, causal, window, q_offset, q.device)[None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = mma_product("bqd,bkd->bqk", do, v, fp32)
    ds = p * (dp - dsum[..., None])
    if dcap is not None:
        ds = ds * dcap
    ds = torch.where(mask, ds, 0.0)
    dv = mma_product("bqk,bqd->bkd", p, do, fp32)
    dq = mma_product("bqk,bkd->bqd", ds, k, fp32) * scale
    dk = mma_product("bqk,bqd->bkd", ds, q, fp32) * scale
    group = lambda x: x.reshape(-1, n_rep, *x.shape[1:]).sum(1)  # noqa: E731
    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)
