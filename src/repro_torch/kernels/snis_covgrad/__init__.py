"""Fused SNIS covariance gradient, forward and backward: hand-written
Hopper kernels (`csrc/snis_covgrad_fwd.cu`, `csrc/snis_covgrad_bwd.cu`),
their plain PyTorch versions (`ref.py`) and the dispatching wrappers
(`ops.py`). `repro_torch.core.gradients` wraps them in a
`torch.autograd.Function`: the forward runs the scores-only kernel, the
backward the gather-reduce."""
from repro_torch.kernels.snis_covgrad.ops import (
    DEFAULT_SAMPLE_TILE,
    resolve_sample_tile,
    snis_covgrad_bwd,
    snis_covgrad_fused,
    snis_scores_fused,
)

__all__ = [
    "DEFAULT_SAMPLE_TILE",
    "resolve_sample_tile",
    "snis_covgrad_bwd",
    "snis_covgrad_fused",
    "snis_scores_fused",
]
