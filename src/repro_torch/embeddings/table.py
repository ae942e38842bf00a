"""Embedding tables (the reference's `repro/embeddings/table.py`).

The table abstraction is deliberately thin: parameters are plain
tensors, so they move and convert like everything else. `spec()` is the
row (vocab) sharding over the model group, as a `torch.distributed`
tensor placement where the reference names a PartitionSpec.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.embeddings.bag import _take_fill, embedding_bag_padded

__all__ = ["EmbeddingTableSpec"]


@dataclasses.dataclass(frozen=True)
class EmbeddingTableSpec:
    name: str
    vocab_size: int
    dim: int
    combiner: str = "sum"

    def init(
        self, generator: torch.Generator, device=None, dtype=torch.float32
    ) -> torch.Tensor:
        """A [vocab_size, dim] table drawn from ``generator`` (normal,
        scaled by 1/sqrt(dim) in fp32, then cast), as the reference's
        scale; its draws differ (another generator)."""
        table = torch.randn(
            (self.vocab_size, self.dim), generator=generator, device=device
        ) / self.dim**0.5
        return table.to(dtype)

    def spec(self) -> tuple:
        """The table's placement over the model group: rows sharded,
        ``(Shard(0),)`` (the reference's ``P("model", None)``), for
        `torch.distributed.tensor.distribute_tensor` over a 1-D mesh of
        the model group."""
        from torch.distributed.tensor import Shard

        return (Shard(0),)

    def lookup(self, table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """Padded multi-hot lookup [B, T] -> [B, D] with the spec's
        combiner, through `embedding_bag_padded` as the reference."""
        return embedding_bag_padded(table, indices, combiner=self.combiner)

    def lookup_single(self, table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """One-hot lookup [...] -> [..., D]; a negative id reads row 0, an
        id >= V a NaN row (`jnp.take`'s fill)."""
        return _take_fill(table, torch.clamp(indices, min=0))
