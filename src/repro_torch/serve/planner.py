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
path that has already run.

The ladder: `probe()`, `overflow()`, `heal(action)` and `degrade()` are
the hooks the engine's `IndexHealthMonitor` drives: the sampled recall
over a held probe set (``probe_x``, embedded once at start), the
compact / rebuild rungs against the live state, and the swap to the
exact fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.fopo import FOPOConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.device import resolve_device
from repro_torch.mips import refresh as refresh_ops
from repro_torch.mips.ivf import DEFAULT_N_PROBE, build_ivf
from repro_torch.mips.refresh import RefreshConfig

__all__ = ["QueryPlanner"]


class QueryPlanner:
    """One policy + one beta table + one resolved plan, serving queries.

    ``policy`` maps (params, x) -> h via `user_embedding`; ``beta`` is the
    [P, L] item table (the LM route's unembed rows), moved to ``device``
    (default "cuda"; see `repro_torch.device`), where ``params`` must
    already be. The index is built over beta in fp32 with
    ``num_clusters`` clusters (default 2^round(log2 sqrt P)), each list
    with ``delta_cap`` delta-buffer slots; the ladder's rebuild rung runs
    ``rebuild_iters`` Lloyd iterations.
    ``probe_x`` arms the ladder's recall probe: without it `probe()`
    returns None and the ladder can only watch overflow."""

    def __init__(
        self,
        policy,
        params,
        beta: torch.Tensor,
        *,
        top_k: int,
        num_clusters: int | None = None,
        n_probe: int | None = None,
        delta_cap: int = 8,
        probe_x=None,
        probe_k: int = 32,
        rebuild_iters: int = 4,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.policy = policy
        self.params = params
        self.beta = beta = beta.to(self.device)
        self.probe_k = min(probe_k, beta.shape[0])
        self.n_probe = n_probe or DEFAULT_N_PROBE
        self.rebuild_iters = rebuild_iters
        index = build_ivf(beta, num_clusters=num_clusters, seed=seed, device=self.device)
        fcfg = FOPOConfig(
            num_items=beta.shape[0],
            num_samples=1,  # unused on the query-only path
            top_k=top_k,
            retriever="ivf_pallas",
            index_refresh=RefreshConfig(
                every=0, compact_every=0, delta_cap=delta_cap
            ),
        )
        self.plan = ExecutionPlan.resolve(
            fcfg, retriever_kwargs={"index": index, "n_probe": self.n_probe}
        )
        self.index_state = self.plan.initial_index_state
        self._fallback_plan = self.plan.degrade_to_fallback()
        self._probe_h = None
        if probe_x is not None:
            with torch.inference_mode():
                self._probe_h = policy.user_embedding(
                    params, torch.as_tensor(probe_x).to(self.device)
                )

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

    # -- degradation-ladder hooks (driven by the engine's monitor) ------
    def probe(self) -> float | None:
        """Sampled recall@probe_k of the live index against exact search
        over the current beta; None when no probe set was armed. It reads
        the result on the host, which is why the engine probes
        periodically, not per batch."""
        if self._probe_h is None:
            return None
        with torch.inference_mode():
            return refresh_ops.sampled_recall(
                self.index_state, self.beta, self._probe_h, self.probe_k,
                n_probe=self.n_probe,
            )

    def overflow(self) -> int:
        return int(self.index_state.overflow)

    def heal(self, action: str) -> None:
        """Run a compact or rebuild rung against the live state."""
        with torch.inference_mode():
            if action == "compact":
                self.index_state = refresh_ops.compact(self.index_state, self.beta)
            elif action == "rebuild":
                self.index_state = refresh_ops.rebuild(
                    self.index_state, self.beta, iters=self.rebuild_iters
                )
            else:
                raise ValueError(f"unknown heal action {action!r}")

    def degrade(self) -> None:
        """The ladder's last rung: swap to the pre-resolved (and
        pre-warmed) exact-fallback plan. Idempotent."""
        self.plan = self._fallback_plan
