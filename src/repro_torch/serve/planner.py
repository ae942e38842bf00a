"""QueryPlanner: the serve-side owner of one resolved ExecutionPlan.

At server start it builds the IVF index over the item table and resolves
ONE `ExecutionPlan` over an ``index_refresh`` route with every=0 and
compact_every=0 (serving schedules no maintenance), so the maintained
index (`RefreshState`) and the pre-resolved exact fallback come from the
plan, not from serve-side code. `query(x)` runs the plan's query-only
path and returns without synchronising: the engine owns the wait.

`warmup` runs both the primary and the fallback path once before
traffic: the first run builds the `ivf_topk` kernel, so its `nvcc` time
never lands in a request's latency, and a later `degrade()` swaps to a
path that has already run. The ladder's recall probe (``probe_x``,
``probe_k``) and its compact/rebuild rungs come with the health slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.fopo import FOPOConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.device import resolve_device
from repro_torch.mips.ivf import DEFAULT_N_PROBE, build_ivf
from repro_torch.mips.refresh import RefreshConfig

__all__ = ["QueryPlanner"]

DELTA_CAP = 8  # per-centroid delta-buffer slots (the reference's default)


class QueryPlanner:
    """One policy + one beta table + one resolved plan, serving queries.

    ``policy`` maps (params, x) -> h via `user_embedding`; ``beta`` is the
    [P, L] item table (the LM route's unembed rows), moved to ``device``
    (default "cuda"; see `repro_torch.device`), where ``params`` must
    already be. The index is built over beta in fp32 with
    ``num_clusters`` clusters (default 2^round(log2 sqrt P))."""

    def __init__(
        self,
        policy,
        params,
        beta: torch.Tensor,
        *,
        top_k: int,
        num_clusters: int | None = None,
        n_probe: int | None = None,
        probe_x=None,
        probe_k: int | None = None,
        seed: int = 0,
        device=None,
    ):
        if probe_x is not None or probe_k is not None:
            raise NotImplementedError(
                "the ladder's recall probe (probe_x / probe_k) is not ported to "
                "repro_torch yet; it comes with the health slice"
            )
        self.device = resolve_device(device)
        self.policy = policy
        self.params = params
        self.beta = beta = beta.to(self.device)
        self.n_probe = n_probe or DEFAULT_N_PROBE
        index = build_ivf(beta, num_clusters=num_clusters, seed=seed, device=self.device)
        fcfg = FOPOConfig(
            num_items=beta.shape[0],
            num_samples=1,  # unused on the query-only path
            top_k=top_k,
            retriever="ivf_pallas",
            index_refresh=RefreshConfig(
                every=0, compact_every=0, delta_cap=DELTA_CAP
            ),
        )
        self.plan = ExecutionPlan.resolve(
            fcfg, retriever_kwargs={"index": index, "n_probe": self.n_probe}
        )
        self.index_state = self.plan.initial_index_state
        self._fallback_plan = self.plan.degrade_to_fallback()

    @property
    def degraded(self) -> bool:
        return self.plan.degraded

    @torch.inference_mode()
    def _run(self, plan: ExecutionPlan, x: torch.Tensor):
        return plan.execute_query(
            self.policy, self.params, x, self.beta, index_state=self.index_state
        )

    def query(self, x: torch.Tensor):
        """(x [B, Dx]) -> TopK, launched without waiting for the device."""
        return self._run(self.plan, x)

    def warmup(self, x_example: torch.Tensor) -> None:
        """Run the primary AND the fallback path once before traffic."""
        self._run(self.plan, x_example)
        self._run(self._fallback_plan, x_example)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def degrade(self) -> None:
        """Swap to the pre-resolved (and pre-warmed) exact-fallback plan.
        Idempotent."""
        self.plan = self._fallback_plan
