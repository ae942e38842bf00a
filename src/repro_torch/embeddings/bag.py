"""EmbeddingBag in PyTorch: gather + segment reduce, with the reference's
semantics (`repro/embeddings/bag.py`). Two layouts:

  * COO/ragged: flat `indices [nnz]` + `segment_ids [nnz]` (the bag of
    each entry), the general layout for ragged multi-hot fields.
  * padded: `indices [B, max_len]` with -1 padding, the layout the
    Hopper kernel `repro_torch.kernels.embedding_bag` computes natively.

Both support the sum / mean / max combiners and optional per-entry
weights. Out-of-range ids follow `jnp.take`'s fill: the gathered row is
NaN (torch's indexing would raise on the CPU and assert on the card, so
the ids are masked explicitly). `hash_bucket` is the reference's uint32
multiplicative hash, bit for bit, in int64 arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_sampler.ref import _M32, _mul32

__all__ = ["embedding_bag_coo", "embedding_bag_padded", "hash_bucket"]


def _take_fill(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`jnp.take(table, ids, axis=0)`: a negative id counts from the end,
    an id outside [-V, V) gives a NaN row."""
    v = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    inside = (ids >= 0) & (ids < v)
    rows = table[torch.where(inside, ids, 0)]
    return torch.where(inside[..., None], rows, torch.nan)


def embedding_bag_coo(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [nnz] int
    segment_ids: torch.Tensor,  # [nnz] int, sorted or not
    num_segments: int,
    combiner: str = "sum",
    weights: torch.Tensor | None = None,  # [nnz]
) -> torch.Tensor:
    """[num_segments, D]. Segment ids outside [0, num_segments) are
    dropped, as `jax.ops.segment_sum` drops them. Under ``max`` an empty
    segment is -inf (`jax.ops.segment_max`'s identity); under ``mean`` it
    is 0."""
    rows = _take_fill(table, indices)  # [nnz, D]
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    rows, seg = rows[keep], seg[keep]
    shape = (num_segments, rows.shape[1])
    if combiner == "max":
        out = torch.full(shape, -torch.inf, dtype=rows.dtype, device=rows.device)
        return out.scatter_reduce_(
            0, seg[:, None].expand_as(rows), rows, reduce="amax", include_self=False
        )
    summed = torch.zeros(shape, dtype=rows.dtype, device=rows.device).index_add_(0, seg, rows)
    if combiner == "sum":
        return summed
    if combiner == "mean":
        ones = weights[keep] if weights is not None else torch.ones(
            seg.shape, dtype=torch.float32, device=seg.device
        )
        counts = torch.zeros(
            num_segments, dtype=ones.dtype, device=ones.device
        ).index_add_(0, seg, ones)
        return summed / torch.clamp(counts[:, None], min=1e-9)
    raise ValueError(f"unknown combiner {combiner!r}")


def embedding_bag_padded(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [B, T] int, -1 = padding
    combiner: str = "sum",
    weights: torch.Tensor | None = None,  # [B, T]
) -> torch.Tensor:
    """[B, D]. Padding (id < 0) adds nothing; under ``max`` a bag with no
    valid id is 0; an id >= V makes its bag's row NaN."""
    valid = indices >= 0  # [B, T]
    rows = _take_fill(table, torch.clamp(indices, min=0))  # [B, T, D]
    w = valid.to(table.dtype)
    if weights is not None:
        w = w * weights
    if combiner == "max":
        neg = torch.finfo(table.dtype).min
        out = torch.amax(torch.where(valid[..., None], rows, neg), dim=1)
        return torch.where(valid.any(dim=1, keepdim=True), out, 0.0)
    summed = torch.sum(rows * w[..., None], dim=1)  # [B, D]
    if combiner == "sum":
        return summed
    if combiner == "mean":
        counts = torch.sum(w, dim=1, keepdim=True)
        return summed / torch.clamp(counts, min=1e-9)
    raise ValueError(f"unknown combiner {combiner!r}")


def hash_bucket(ids: torch.Tensor, num_buckets: int, salt: int = 0x9E3779B9) -> torch.Tensor:
    """Multiplicative hashing for the hashing trick: unbounded categorical
    ids -> [0, num_buckets), int32. ``ids`` are read as uint32 (an int32
    -1 is 2^32 - 1, as `astype(uint32)` reads it; int64 values are taken
    mod 2^32); the arithmetic is the reference's uint32 arithmetic."""
    x = _mul32(ids.long() & _M32, salt & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    return (x % num_buckets).to(torch.int32)
