"""The plain PyTorch version of the in-kernel mixture sampler.

Same function as `fused_sampler_cuda`, step for step: the splitmix32
counter hash (uint32 arithmetic emulated in int64, masked to 32 bits,
including the int32 wrap of the counter), the arm choice, the
Gumbel-argmax over the top-K row, the 32-bit uniform draw mod P, and the
membership log q with the reference's logaddexp. It materialises the
[B, Sp, K] Gumbel tensor the kernel never stores, and tests membership
by K compares a draw. The CPU path and the tests use it; on the card it
is only the yardstick the kernel is held to. It counts its calls in
``fused_sampler_ref.calls``.

`membership_table` is the kernel's membership lookup written out in
plain torch (its open-addressing table of the row's ids, the duplicate
flags, each slot's log kappa summed over its id): the tests hold it to
the compares.
"""
from __future__ import annotations

import torch

from repro_torch.constants import LOG_Q_PAD

__all__ = [
    "bucket_of", "fused_sampler_ref", "hash_u32", "membership_table", "mixture_log_q",
    "uniform01",
]

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


def bucket_of(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernel's home bucket of each id: the top `bits` bits of
    uint32(id) * golden (int64 in, int64 out)."""
    return _mul32(ids.to(torch.int64) & _M32, _GOLDEN) >> (32 - bits)


def _log_kappa_full(topk_scores: torch.Tensor) -> torch.Tensor:
    """log kappa at each slot: score - log Z, log Z = m + log sum exp(s - m)."""
    m = topk_scores.max(dim=-1, keepdim=True).values
    log_z = m + torch.log(torch.exp(topk_scores - m).sum(dim=-1, keepdim=True))
    return topk_scores - log_z


def membership_table(
    topk_ids: torch.Tensor,  # [B, K] int32
    topk_scores: torch.Tensor,  # [B, K] float32
    actions: torch.Tensor,  # [B, N] int
    bits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(in_topk [B, N] bool, log kappa [B, N] float32, 0 where not in the
    row) of each action, as the kernel finds them: a table of 2^bits > K
    buckets (the kernel's has at least 2K) holding slot + 1 (0 empty),
    each id entered by linear probing from `bucket_of`; a second slot of
    an id flags the first one's bucket as repeated; a slot's log kappa is
    summed over every slot of its id in slot order where its bucket is
    flagged; an action reads the log kappa of the slot its probe finds, or
    misses at an empty bucket. The order in which slots are entered
    changes no lookup."""
    b, k = topk_ids.shape
    size = 1 << bits
    if size <= k:
        raise ValueError(f"a table of 2^{bits} buckets cannot hold K={k} ids")
    dev = topk_ids.device
    ids = topk_ids.to(torch.int64)
    rows = torch.arange(b, device=dev)
    tab = torch.zeros((b, size), dtype=torch.int64, device=dev)
    dup = torch.zeros((b, size), dtype=torch.bool, device=dev)
    home = torch.empty((b, k), dtype=torch.int64, device=dev)  # each slot's id's bucket
    start = bucket_of(ids, bits)
    for e in range(k):
        h = start[:, e].clone()
        pending = torch.ones(b, dtype=torch.bool, device=dev)
        while bool(pending.any()):
            v = tab[rows, h]
            same = (v > 0) & (ids[rows, (v - 1).clamp(min=0)] == ids[:, e])
            claim = pending & (v == 0)
            tab[rows[claim], h[claim]] = e + 1
            dup[rows[pending & same], h[pending & same]] = True
            done = claim | (pending & same)
            home[done, e] = h[done]
            pending &= ~done
            h = torch.where(pending, (h + 1) % size, h)
    lk_full = _log_kappa_full(topk_scores)
    lk = lk_full.clone()
    repeated = dup[rows[:, None], home]  # [B, K]
    for r, e in repeated.nonzero().tolist():  # the id repeats: its slots, in slot order
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for j in (ids[r] == ids[r, e]).nonzero()[:, 0].tolist():
            acc = acc + lk_full[r, j]
        lk[r, e] = acc

    acts = actions.to(torch.int64)
    n = acts.shape[1]
    h = bucket_of(acts, bits)
    found = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    pending = torch.ones((b, n), dtype=torch.bool, device=dev)
    while bool(pending.any()):
        v = tab.gather(1, h)
        miss = v == 0
        hit = ~miss & (ids.gather(1, (v - 1).clamp(min=0)) == acts)
        found = torch.where(pending & hit, v - 1, found)
        pending &= ~(miss | hit)
        h = torch.where(pending, (h + 1) % size, h)
    in_topk = found >= 0
    log_kappa = torch.where(in_topk, lk.gather(1, found.clamp(min=0)), 0.0)
    return in_topk, log_kappa


def mixture_log_q(in_topk: torch.Tensor, log_kappa: torch.Tensor, eps: torch.Tensor,
                  num_items: int) -> torch.Tensor:
    """log q of a draw from its membership: logaddexp(log eps - log P,
    log1p(-eps) + log kappa) in the top-K row, log eps - log P outside."""
    log_u = torch.log(eps) - torch.log(torch.full((), float(num_items), device=eps.device))
    log_mix = _logaddexp(log_u.expand_as(log_kappa), torch.log1p(-eps) + log_kappa)
    return torch.where(in_topk, log_mix, log_u)


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
    log_kappa = torch.where(hit, _log_kappa_full(topk_scores)[:, None, :], 0.0).sum(dim=-1)
    log_q = mixture_log_q(in_topk, log_kappa, eps, num_items)

    actions = torch.where(live, actions, -1).to(torch.int32)
    log_q = torch.where(live, log_q, LOG_Q_PAD).to(torch.float32)
    slots = torch.where(live & ~take_uniform, slot, -1).to(torch.int32)
    return actions, log_q, slots


fused_sampler_ref.calls = 0
