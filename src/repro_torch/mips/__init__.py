"""MIPS substrate of the port: exact search, the IVF index and its
maintained state. All retrievers return the same `TopK(scores, indices)`."""
from repro_torch.mips.exact import TopK, merge_topk, recall_at_k, topk_exact
from repro_torch.mips.ivf import IVFIndex, build_ivf, ivf_query, kmeans
from repro_torch.mips.refresh import (
    RefreshConfig,
    RefreshState,
    build_refresh_state,
    init_refresh_state,
    sampled_recall,
)

__all__ = [
    "IVFIndex",
    "RefreshConfig",
    "RefreshState",
    "TopK",
    "build_ivf",
    "build_refresh_state",
    "init_refresh_state",
    "ivf_query",
    "kmeans",
    "merge_topk",
    "recall_at_k",
    "sampled_recall",
    "topk_exact",
]
