"""repro_torch.dist — the multi-device FOPO step on `torch.distributed`.

The reference's `repro.dist` runs one controller over a device mesh
(`shard_map`); the port runs one process per device. `DistConfig` holds
this rank's two process groups of the (data, model) grid, and
`repro_torch.dist.fopo` the step: beta's rows sharded over `model`, the
batch over `data`, the per-device kernels unchanged and one reduction of
the score partials. `repro_torch.dist.collectives` holds the collectives
it is made of. The reference's static PartitionSpec tables
(`repro.dist.sharding`) describe its TPU meshes and have no counterpart.
"""
from repro_torch.dist.collectives import (
    gather_samples,
    pad_rows,
    pad_samples,
    padded_len,
    psum_scores,
    rebase_ids,
)
from repro_torch.dist.fopo import (
    DistConfig,
    data_rows,
    dist_fopo_loss,
    dist_fused_covariance_loss,
    dist_fused_mixture_sample,
    dist_ivf_topk,
    dist_score_partials,
    dist_scores,
    dist_sharded_topk,
    dist_verdict_agree,
    make_debug_dist,
    shard_rows,
    slab_rows,
)

__all__ = [
    "DistConfig",
    "data_rows",
    "dist_fopo_loss",
    "dist_fused_covariance_loss",
    "dist_fused_mixture_sample",
    "dist_ivf_topk",
    "dist_score_partials",
    "dist_scores",
    "dist_sharded_topk",
    "dist_verdict_agree",
    "gather_samples",
    "make_debug_dist",
    "pad_rows",
    "pad_samples",
    "padded_len",
    "psum_scores",
    "rebase_ids",
    "shard_rows",
    "slab_rows",
]
