"""The plain PyTorch versions of the fused covgrad kernels.

`snis_fwd_ref` is the same function as `snis_fwd_cuda` (sampled scores,
and in covgrad mode the SNIS covariance gradient with the weight exactly
0 where log q >= LOG_Q_VALID_MAX and the normaliser floored at 1e-30);
`snis_bwd_ref` the same as `snis_bwd_cuda` (the select-masked
gather-reduce). Unlike the kernels they gather the [B, S, L] tensor of
item rows. The CPU path and the tests use them; on the card they are
only the yardsticks the kernels are held to. They count their calls in
``snis_fwd_ref.calls`` and ``snis_bwd_ref.calls``.
"""
from __future__ import annotations

import torch

from repro_torch.constants import LOG_Q_VALID_MAX

__all__ = ["snis_bwd_ref", "snis_fwd_ref"]


def snis_fwd_ref(
    h: torch.Tensor,  # [B, L]
    beta: torch.Tensor,  # [P, L]
    actions: torch.Tensor,  # [B, S] int32, -1 marks masked slots
    log_q: torch.Tensor,  # [B, S]
    rewards: torch.Tensor,  # [B, S]
    *,
    covgrad: bool,
):
    """scores [B, S] (covgrad=False), or (scores [B, S], grad [B, L])."""
    snis_fwd_ref.calls += 1
    emb = beta[actions.clamp(min=0).long()]  # [B, S, L]: a masked slot gathers row 0
    scores = torch.einsum("bl,bsl->bs", h, emb)
    if not covgrad:
        return scores
    valid = log_q < LOG_Q_VALID_MAX
    logw = torch.where(valid, scores - log_q, torch.full_like(scores, -torch.inf))
    m = logw.max(dim=-1, keepdim=True).values
    w = torch.where(valid, torch.exp(logw - torch.where(valid, m, 0.0)), 0.0)
    z = w.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    rbar = (w * rewards).sum(dim=-1, keepdim=True) / z
    grad = torch.einsum("bs,bsl->bl", w * (rewards - rbar), emb) / z
    return scores, grad


def snis_bwd_ref(
    coeff: torch.Tensor,  # [B, S]
    actions: torch.Tensor,  # [B, S] int32
    beta: torch.Tensor,  # [P, L]
) -> torch.Tensor:
    """grad_h [B, L] = sum_s select(a >= 0, coeff, 0) * beta[a]."""
    snis_bwd_ref.calls += 1
    live = actions >= 0
    emb = beta[actions.clamp(min=0).long()]
    return torch.einsum("bs,bsl->bl", torch.where(live, coeff, 0.0), emb)


snis_fwd_ref.calls = 0
snis_bwd_ref.calls = 0
