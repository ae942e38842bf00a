"""FOPO, Algorithm 1 assembled: fast offline policy learning.

One training step:
  1. h = h_theta(x)                       (user tower)
  2. top-K = retrieve(h)                  (MIPS: exact | streaming |
                                           pallas | ivf | ivf_pallas)
  3. q = eps/P + (1-eps) softmax(top-K)   (mixture proposal)
  4. a_1..a_S ~ q                         (S draws per context)
  5. SNIS weights + covariance gradient   (O(S), catalog-free)
  6. optimizer update

How the step runs (which retriever, which sampler, which surrogate) is
resolved once from `FOPOConfig` into a frozen `repro_torch.core.plan
.ExecutionPlan`, whose `execute()` is the step body. `fopo_loss` is the
config-level entry point that resolves a plan per call; the trainer
resolves once and passes ``plan=``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.gradients import reinforce_surrogate
from repro_torch.core.plan import ExecutionPlan, Retriever, make_retriever
from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.kernels.snis_covgrad.ops import DEFAULT_SAMPLE_TILE

__all__ = [
    "DEFAULT_SAMPLE_TILE",
    "FOPOConfig",
    "Retriever",
    "fopo_loss",
    "make_retriever",
    "reinforce_loss",
]


@dataclasses.dataclass(frozen=True)
class FOPOConfig:
    """The same fields and defaults as the reference's `FOPOConfig`."""

    num_items: int
    num_samples: int = 1000  # S
    top_k: int = 256  # K
    epsilon: float = 0.8
    # exact | streaming | ivf | ivf_pallas | sharded | pallas; "pallas" is
    # the exact streamed top-K kernel (repro_torch.kernels.mips_topk),
    # "ivf_pallas" the IVF query kernel (repro_torch.kernels.ivf_topk)
    retriever: str = "streaming"
    # fused=True runs the SNIS + covariance-gradient step through the
    # covgrad kernels (an autograd Function; no [B, S, L] gather)
    fused: bool = False
    # accepted and written back as the reference does; the port ignores
    # it (the tensor's device picks the kernel or its plain version)
    fused_interpret: bool | None = None
    # the kernels' sample tile TS: S is padded to a multiple of it
    sample_tile: int = DEFAULT_SAMPLE_TILE
    # fused_sampler=True draws the eps-mixture actions in-kernel
    # (repro_torch.kernels.fused_sampler), tile-aligned for the covgrad
    # kernels, from the reference's counter-hash stream
    fused_sampler: bool = False
    dist: Any = None  # the multi-device route: the dist slice
    # RefreshConfig: the maintained-index route (requires "ivf_pallas")
    index_refresh: Any = None


def fopo_loss(
    policy: SoftmaxPolicy,
    params,
    seed: int,
    x: torch.Tensor,  # [B, Dx]
    beta: torch.Tensor,  # [P, L] fixed item embeddings
    reward_fn,  # actions [B, S] -> [B, S]
    cfg: FOPOConfig,
    retriever: Retriever | None = None,
    epsilon: float | torch.Tensor | None = None,
    *,
    plan: ExecutionPlan | None = None,
    index_state=None,
) -> tuple[torch.Tensor, dict]:
    """Scalar surrogate loss whose gradient is the SNIS covariance
    gradient, and the `snis_diagnostics` aux dict (``ess`` / ``rbar`` /
    ``max_wbar``). Resolves a plan from ``cfg`` unless ``plan`` is given;
    an injected ``retriever`` overrides the configured one. ``seed`` is
    the step's int32 seed (see `ExecutionPlan.execute`)."""
    if plan is None:
        plan = ExecutionPlan.resolve(cfg, retriever=retriever)
    return plan.execute(
        policy, params, seed, x, beta, reward_fn, epsilon=epsilon,
        index_state=index_state,
    )


def reinforce_loss(
    policy: SoftmaxPolicy,
    params,
    generator: torch.Generator,
    x: torch.Tensor,
    beta: torch.Tensor,
    reward_fn,
    num_samples: int,
) -> torch.Tensor:
    """The paper's O(P) REINFORCE baseline (exact sampling from pi)."""
    return reinforce_surrogate(policy, params, generator, x, beta, reward_fn, num_samples)
