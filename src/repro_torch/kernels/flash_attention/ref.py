"""The plain PyTorch version of the flash-attention forward kernel.

The reference's oracle (`repro/kernels/flash_attention/ref.py`): the
naive masked softmax attention over [BH, S, D], with the [BH, Sq, Skv]
score matrix materialised, plus the per-row logsumexp the kernel also
returns (a logsumexp over the masked scores). It keeps the reference
kernel's own ``NEG_INF = -2e38`` (not `repro_torch.constants`'): a
masked score, finite, that underflows ``exp`` to 0 against any live
one. The CPU path and the tests use it; on the card it is only the
yardstick the kernel is held to. It counts its calls in
``flash_attention_ref.calls``.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_ref"]

NEG_INF = -2.0e38


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
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos < seq_kv
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask[None], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype), lse


flash_attention_ref.calls = 0
