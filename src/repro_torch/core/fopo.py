"""FOPOConfig: the knob set an `ExecutionPlan` is resolved from.

The same fields and defaults as the reference's `repro/core/fopo.py`.
The serving slice resolves only ``retriever="ivf_pallas"`` with
``index_refresh``; `repro_torch.core.plan` raises NotImplementedError for
the knobs of later slices (other retrievers, ``fused``,
``fused_sampler``, ``dist``). The loss entry points come with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["DEFAULT_SAMPLE_TILE", "FOPOConfig"]

# sample-tile width of the fused training kernels (the reference's
# `repro/kernels/snis_covgrad/ops.py` default)
DEFAULT_SAMPLE_TILE = 8


@dataclasses.dataclass(frozen=True)
class FOPOConfig:
    num_items: int
    num_samples: int = 1000  # S
    top_k: int = 256  # K
    epsilon: float = 0.8
    # exact | streaming | ivf | ivf_pallas | sharded | pallas; "ivf_pallas"
    # is the kernel-grade IVF query (repro_torch.kernels.ivf_topk)
    retriever: str = "streaming"
    fused: bool = False
    fused_interpret: bool | None = None
    sample_tile: int = DEFAULT_SAMPLE_TILE
    fused_sampler: bool = False
    dist: Any = None
    # RefreshConfig: the maintained-index route (requires "ivf_pallas")
    index_refresh: Any = None
