"""The plain PyTorch version of the in-kernel mixture sampler.

Same function as `fused_sampler_cuda`, step for step: the splitmix32
counter hash (uint32 arithmetic emulated in int64, masked to 32 bits,
including the int32 wrap of the counter), the arm choice, the
Gumbel-argmax over the top-K row, the 32-bit uniform draw mod P, and the
membership log q with the reference's logaddexp. It materialises the
[B, Sp, K] Gumbel tensor the kernel never stores. The CPU path and the
tests use it; on the card it is only the yardstick the kernel is held
to. It counts its calls in ``fused_sampler_ref.calls``.
"""
from __future__ import annotations

import torch

from repro_torch.constants import LOG_Q_PAD

__all__ = ["hash_u32", "fused_sampler_ref", "uniform01"]

# splitmix32 finalizer constants (the reference's _GOLDEN, _MIX1, _MIX2)
_GOLDEN = 0x9E3779B9
_MIX1 = 0x21F0AAAD
_MIX2 = 0x735A2D97
_M32 = 0xFFFFFFFF
_TINY = 1e-12  # keeps both logs of the Gumbel finite at u in {0, 1}


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32), in int64 without overflow:
    the product is taken in 16-bit halves."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_u32(seed: int, ctr: torch.Tensor) -> torch.Tensor:
    """The reference's `_hash_u32`: int64 tensor of uint32 counters ->
    int64 tensor of uint32 hashes."""
    x = (_mul32(ctr, _GOLDEN) + (seed & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 15)


def uniform01(seed: int, ctr: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) with 24 mantissa bits."""
    return (hash_u32(seed, ctr) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's form: max + log1p(exp(-|a - b|)), a + b where the
    difference is NaN."""
    delta = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-delta.abs()))
    return torch.where(torch.isnan(delta), a + b, out)


def fused_sampler_ref(
    seed: int,
    epsilon: torch.Tensor,  # 0-d float32
    topk_ids: torch.Tensor,  # [B, K] int32
    topk_scores: torch.Tensor,  # [B, K] float32
    *,
    num_samples: int,
    num_items: int,
    sample_tile: int,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(actions [B, Sp] int32, log_q [B, Sp] float32, topk_slot [B, Sp]
    int32), Sp = ceil(S / TS) * TS; positions >= S are dead slots."""
    fused_sampler_ref.calls += 1
    b, k = topk_ids.shape
    dev = topk_ids.device
    sp = -(-num_samples // sample_tile) * sample_tile
    eps = epsilon.to(torch.float32)
    pos = torch.arange(sp, dtype=torch.int64, device=dev)[None, :]
    rows = row_offset + torch.arange(b, dtype=torch.int64, device=dev)[:, None]
    live = pos < num_samples
    # the reference computes the counter in int32 and casts it to uint32:
    # the same bits as the exact value mod 2^32
    ctr0 = (((rows * sp + pos) & _M32) * (k + 2)) & _M32  # [B, Sp]

    u_arm = uniform01(seed, ctr0)
    bits_uni = hash_u32(seed, (ctr0 + 1) & _M32)
    ctr_g = (ctr0[:, :, None] + 2 + torch.arange(k, dtype=torch.int64, device=dev)) & _M32
    u_gum = uniform01(seed, ctr_g)  # [B, Sp, K]

    gum = -torch.log(-torch.log(u_gum + _TINY) + _TINY)
    slot = torch.argmax(topk_scores[:, None, :] + gum, dim=-1)  # first on ties
    kappa_draw = torch.gather(topk_ids, 1, slot)
    uniform_draw = (bits_uni % num_items).to(torch.int32)
    take_uniform = u_arm < eps
    actions = torch.where(take_uniform, uniform_draw, kappa_draw)

    hit = actions[:, :, None] == topk_ids[:, None, :]
    in_topk = hit.any(dim=-1)
    m = topk_scores.max(dim=-1, keepdim=True).values
    log_z = m + torch.log(torch.exp(topk_scores - m).sum(dim=-1, keepdim=True))
    log_kappa_full = topk_scores - log_z
    log_kappa = torch.where(hit, log_kappa_full[:, None, :], 0.0).sum(dim=-1)
    log_u = torch.log(eps) - torch.log(torch.full((), float(num_items), device=dev))
    log_mix = _logaddexp(log_u.expand_as(log_kappa), torch.log1p(-eps) + log_kappa)
    log_q = torch.where(in_topk, log_mix, log_u)

    actions = torch.where(live, actions, -1).to(torch.int32)
    log_q = torch.where(live, log_q, LOG_Q_PAD).to(torch.float32)
    slots = torch.where(live & ~take_uniform, slot, -1).to(torch.int32)
    return actions, log_q, slots


fused_sampler_ref.calls = 0
