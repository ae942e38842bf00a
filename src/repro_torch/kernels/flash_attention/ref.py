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
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_bwd_ref", "flash_attention_ref"]

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
