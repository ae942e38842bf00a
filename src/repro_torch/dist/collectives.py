"""Collective building blocks of the multi-device FOPO step.

The reference runs one controller over a mesh (`shard_map`); the port
runs one process per device, and each function here is that process's
part of a collective over a `torch.distributed` process group:

* `rebase_ids` — global sampled-action ids -> (local row ids, ownership
  mask) against this rank's contiguous beta row range. Foreign ids
  become -1, the covgrad kernels' dead-slot sentinel, so a shard scores
  and accumulates exactly its own rows and contributes exact zeros
  everywhere else: that is what makes the cross-shard sum exact.
* `gather_samples` — the id-routing collective: an all-gather of
  sample-sharded (B, S/n) tensors back to the full (B, S) sample set,
  concatenated in group-rank order (the reference's tiled all-gather).
* `psum_scores` — THE one reduction of the per-shard SNIS score
  partials (an all-reduce SUM over the model group). The SNIS
  normaliser is derived from its result locally, never reduced again.

Padding helpers (`pad_rows`, `pad_samples`): ragged catalogs pad beta
with zero rows that no real id addresses (`pad_rows`' ceil rule is the
row partition of the dist step; checkpoints use `shard_bounds`' rule
instead), ragged sample counts pad with dead slots (action -1,
`LOG_Q_PAD`, reward 0) that carry exactly zero weight.

Every collective of the port goes through `all_reduce` / `all_gather`
below, which count the calls, the bytes and the host seconds of each
(`STATS`, for the logs). The backend is whatever initialised process
group the caller gives: NCCL for CUDA tensors, gloo for the CPU. gloo
also takes CUDA tensors for every collective used here (all-reduce SUM
and MAX of fp32 and int32, all-gather), so nothing is staged through
the host on either backend.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.constants import LOG_Q_PAD

__all__ = [
    "STATS",
    "all_gather",
    "all_reduce",
    "gather_samples",
    "pad_rows",
    "pad_samples",
    "padded_len",
    "psum_scores",
    "rebase_ids",
    "reset_stats",
]

# {collective name: {"calls", "bytes", "seconds"}}
STATS: dict[str, dict[str, float]] = {}


def reset_stats() -> None:
    STATS.clear()


def _count(name: str, nbytes: int, seconds: float) -> None:
    s = STATS.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += seconds


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None, name: str = "all_reduce"):
    """A new tensor: ``t`` all-reduced with ``op`` over ``group`` (the
    input is not written)."""
    out = t.clone()
    t0 = time.perf_counter()
    dist.all_reduce(out, op=op, group=group)
    _count(name, out.numel() * out.element_size(), time.perf_counter() - t0)
    return out


def all_gather(t: torch.Tensor, group=None, dim: int = 0, name: str = "all_gather"):
    """``t`` of every rank of ``group``, concatenated along ``dim`` in
    group-rank order (the reference's tiled all-gather)."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    t0 = time.perf_counter()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=dim)
    _count(name, n * t.numel() * t.element_size(), time.perf_counter() - t0)
    return out


def padded_len(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def pad_rows(table: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad a [P, L] table to P % mult == 0 (ragged catalogs). The
    pad rows are unaddressable: every real id is < P."""
    p = table.shape[0]
    pp = padded_len(p, mult)
    if pp == p:
        return table
    pad = torch.zeros((pp - p,) + tuple(table.shape[1:]), dtype=table.dtype, device=table.device)
    return torch.cat([table, pad], dim=0)


def pad_samples(actions: torch.Tensor, log_q: torch.Tensor, rewards: torch.Tensor, mult: int):
    """Pad the sample dim of (B, S) tensors to S % mult == 0 with dead
    slots (action -1, log_q LOG_Q_PAD, reward 0): the kernels' exact
    zero-weight contract makes them inert."""
    b, s = actions.shape
    sp = padded_len(s, mult)
    if sp == s:
        return actions, log_q, rewards

    def pad(x, fill):
        return torch.cat([x, torch.full((b, sp - s), fill, dtype=x.dtype, device=x.device)], 1)

    return pad(actions, -1), pad(log_q, LOG_Q_PAD), pad(rewards, 0.0)


def rebase_ids(ids: torch.Tensor, rows: int, shard_id: int):
    """Global ids -> (local ids int32, owned mask) for the contiguous row
    range [shard_id * rows, (shard_id + 1) * rows). Foreign and already
    masked (< 0) ids map to -1, the kernels' dead-slot value."""
    local = ids.long() - shard_id * rows
    owned = (ids >= 0) & (local >= 0) & (local < rows)
    return torch.where(owned, local, -1).to(torch.int32), owned


def gather_samples(group, *tensors: torch.Tensor) -> tuple:
    """Route sample-sharded (B, S/n) tensors to every rank of ``group``:
    an all-gather along the sample dim, restoring the global (B, S)
    column order."""
    return tuple(all_gather(t, group, dim=1, name="gather_samples") for t in tensors)


def psum_scores(partials: torch.Tensor, group) -> torch.Tensor:
    """The single cross-shard reduction of the dist step: the per-shard
    sampled-score partials (owner value + exact zeros) summed over the
    model group."""
    return all_reduce(partials, group=group, name="psum_scores")
