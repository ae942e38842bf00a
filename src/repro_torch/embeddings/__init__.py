"""Embedding substrate of the port: bag reductions, hashing and tables
(the reference's `repro.embeddings`). The padded sum is also a
hand-written Hopper kernel, `repro_torch.kernels.embedding_bag`."""
from repro_torch.embeddings.bag import (
    embedding_bag_coo,
    embedding_bag_padded,
    hash_bucket,
)
from repro_torch.embeddings.table import EmbeddingTableSpec

__all__ = [
    "embedding_bag_coo",
    "embedding_bag_padded",
    "hash_bucket",
    "EmbeddingTableSpec",
]
