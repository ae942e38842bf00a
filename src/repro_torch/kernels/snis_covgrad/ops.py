"""Public wrappers of the fused SNIS covariance-gradient kernels.

The reference's three ops (`repro/kernels/snis_covgrad/ops.py`), with
its tile rule: ``sample_tile`` is clamped by `resolve_sample_tile`, and
S is padded up to a multiple of TS with dead slots (action -1, log_q
LOG_Q_PAD, reward 0 / coefficient 0), which carry an exact zero weight;
padded score columns are cropped before return. On the card the tiling
is only this padding: the kernels read their own actions, so TS = 1 and
TS > 1 run the same kernel.

Masking is by value: callers mark dead sample slots with action -1 and
log_q LOG_Q_PAD. A row whose slots are all masked gets an exactly-zero
gradient row and zero SNIS weights.

Dispatch is by the device of the tensors: on the CPU the plain PyTorch
versions (`ref.py`); on CUDA the hand-written kernels, or an error.
There is no fallback from a kernel to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.constants import LOG_Q_PAD
from repro_torch.kernels.snis_covgrad import kernel as _kernel
from repro_torch.kernels.snis_covgrad import ref as _ref

__all__ = [
    "DEFAULT_SAMPLE_TILE",
    "resolve_sample_tile",
    "snis_covgrad_bwd",
    "snis_covgrad_fused",
    "snis_scores_fused",
]

DEFAULT_SAMPLE_TILE = 8


def resolve_sample_tile(sample_tile: int, s: int) -> int:
    """The single tile-clamp rule: at least 1, never wider than the
    sample count (a wider tile would be pure padding)."""
    return max(1, min(int(sample_tile), s))


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _tile_pad(x: torch.Tensor, sp: int, fill) -> torch.Tensor:
    b, s = x.shape
    if sp == s:
        return x
    return torch.cat([x, torch.full((b, sp - s), fill, dtype=x.dtype, device=x.device)], 1)


def _padded(s: int, sample_tile: int) -> int:
    ts = resolve_sample_tile(sample_tile, s)
    return -(-s // ts) * ts


def _forward(h, beta, actions, log_q, rewards, sample_tile, covgrad):
    s = actions.shape[1]
    sp = _padded(s, sample_tile)
    args = (
        h.float().contiguous(),
        beta.float().contiguous(),
        _tile_pad(actions.to(torch.int32), sp, -1).contiguous(),
        _tile_pad(log_q.float(), sp, LOG_Q_PAD).contiguous(),
        _tile_pad(rewards.float(), sp, 0.0).contiguous(),
    )
    fn = _kernel.snis_fwd_cuda if _on_cuda(args[0]) else _ref.snis_fwd_ref
    out = fn(*args, covgrad=covgrad)
    if covgrad:
        return out[0][:, :s], out[1]
    return out[:, :s]


def snis_covgrad_fused(
    h: torch.Tensor,  # [B, L]
    beta: torch.Tensor,  # [P, L]
    actions: torch.Tensor,  # [B, S]; -1 marks masked slots
    log_q: torch.Tensor,  # [B, S]; LOG_Q_PAD on masked slots
    rewards: torch.Tensor,  # [B, S]
    *,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
):
    """In-kernel gather + SNIS + covariance gradient. Returns (grad
    [B, L], wbar [B, S], scores [B, S]); wbar is recovered from the
    scores with one softmax, masked to exact zero on dead slots."""
    scores, grad = _forward(h, beta, actions, log_q, rewards, sample_tile, True)
    wbar = torch.softmax(scores - log_q.float(), dim=-1) * (actions >= 0)
    return grad, wbar, scores


def snis_scores_fused(
    h: torch.Tensor,
    beta: torch.Tensor,
    actions: torch.Tensor,
    log_q: torch.Tensor,
    rewards: torch.Tensor,
    *,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
) -> torch.Tensor:
    """Loss-only forward: sampled scores [B, S] with the in-kernel
    gather (the autograd forward of the fused step)."""
    return _forward(h, beta, actions, log_q, rewards, sample_tile, False)


def snis_covgrad_bwd(
    coeff: torch.Tensor,  # [B, S] per-sample score gradients dL/df
    actions: torch.Tensor,  # [B, S]
    beta: torch.Tensor,  # [P, L]
    *,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
) -> torch.Tensor:
    """grad_h [B, L] = sum_s coeff[b, s] beta[actions[b, s]], dead lanes
    adding nothing whatever their coefficient."""
    sp = _padded(actions.shape[1], sample_tile)
    cf = _tile_pad(coeff.float(), sp, 0.0).contiguous()
    acts = _tile_pad(actions.to(torch.int32), sp, -1).contiguous()
    b32 = beta.float().contiguous()
    fn = _kernel.snis_bwd_cuda if _on_cuda(cf) else _ref.snis_bwd_ref
    return fn(cf, acts, b32)
