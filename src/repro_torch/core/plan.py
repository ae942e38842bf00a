"""The resolved ExecutionPlan, serving subset.

`FOPOConfig` is a knob matrix; `ExecutionPlan.resolve` validates it and
resolves it once into a frozen object that knows which retriever runs.
This slice ports the route the serving planner takes:
``retriever="ivf_pallas"`` with ``index_refresh``, where the maintained
index rides every query as a `RefreshState` operand, the retriever is
(h, beta, state) -> TopK through the `ivf_topk` kernel with its delta
pass, and a pre-resolved exact retriever with the same signature is the
fallback that `degrade_to_fallback` swaps in.

Every other knob raises NotImplementedError naming the slice that brings
it: the other retrievers, ``fused`` and ``fused_sampler`` (training), and
``dist`` (multiple devices). `execute_query` is the serve path; the
training step (`execute`) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.mips.exact import TopK

__all__ = ["ExecutionPlan", "RETRIEVERS"]

Retriever = Callable[..., TopK]

RETRIEVERS = ("exact", "streaming", "ivf", "ivf_pallas", "sharded", "pallas")


def _resolve_ivf_pallas_kwargs(kw: dict):
    """Tile-align the prebuilt index once (the reference's layout) and pin
    the n_probe default. Returns (aligned index, n_probe)."""
    from repro_torch.kernels.ivf_topk.ops import tile_align_index
    from repro_torch.mips.ivf import DEFAULT_N_PROBE

    index, _ = tile_align_index(kw["index"], kw.get("cap_tile"))
    return index, kw.get("n_probe", DEFAULT_N_PROBE)


def _validate(cfg, retriever_kwargs: dict) -> None:
    """Construction-time knob validation: every invalid or not-yet-ported
    combination fails here, before any query runs."""
    if cfg.num_items <= 0:
        raise ValueError(
            f"FOPOConfig.num_items must be > 0, got {cfg.num_items}"
        )
    if cfg.num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {cfg.num_samples}")
    if cfg.top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {cfg.top_k}")
    if isinstance(cfg.epsilon, (int, float)) and not 0.0 <= cfg.epsilon <= 1.0:
        raise ValueError(f"epsilon must lie in [0, 1], got {cfg.epsilon}")
    if cfg.retriever not in RETRIEVERS:
        raise ValueError(
            f"unknown retriever {cfg.retriever!r} (one of {RETRIEVERS})"
        )
    if cfg.dist is not None:
        raise NotImplementedError(
            "FOPOConfig.dist is not ported yet: the multi-device route comes "
            "with the dist slice"
        )
    if cfg.fused or cfg.fused_sampler:
        raise NotImplementedError(
            "fused / fused_sampler are not ported yet: the fused training "
            "kernels come with the training slice"
        )
    if cfg.retriever != "ivf_pallas" or cfg.index_refresh is None:
        raise NotImplementedError(
            f"retriever={cfg.retriever!r} with index_refresh="
            f"{cfg.index_refresh!r} is not ported yet: the serving slice "
            "resolves retriever='ivf_pallas' with an index_refresh route; "
            "the other retrievers come with the training slice"
        )
    from repro_torch.mips.ivf import IVFIndex
    from repro_torch.mips.refresh import RefreshConfig

    if "index" not in retriever_kwargs:
        raise ValueError(
            'retriever="ivf_pallas" needs a prebuilt index: pass '
            "retriever_kwargs={'index': build_ivf(...)}"
        )
    if not isinstance(retriever_kwargs["index"], IVFIndex):
        raise ValueError(
            'retriever="ivf_pallas" takes a single IVFIndex (got '
            f"{type(retriever_kwargs['index']).__name__})"
        )
    rc = cfg.index_refresh
    if not isinstance(rc, RefreshConfig):
        raise ValueError(
            "FOPOConfig.index_refresh must be a RefreshConfig (or None), "
            f"got {type(rc).__name__}"
        )
    if rc.every < 0 or rc.compact_every < 0:
        raise ValueError(
            "RefreshConfig.every / compact_every must be >= 0 "
            f"(0 disables), got {rc.every} / {rc.compact_every}"
        )
    if rc.every > 0 and rc.minibatch < 1:
        raise ValueError(f"RefreshConfig.minibatch must be >= 1, got {rc.minibatch}")
    if rc.delta_cap < 1:
        raise ValueError(f"RefreshConfig.delta_cap must be >= 1, got {rc.delta_cap}")
    if not 0.0 < rc.count_decay <= 1.0:
        raise ValueError(
            f"RefreshConfig.count_decay must lie in (0, 1], got {rc.count_decay}"
        )


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """What `FOPOConfig` leaves implicit, resolved once.

    retriever            (h, beta, state) -> TopK through `ivf_topk`
    initial_index_state  the RefreshState built from the caller's index
    fallback_retriever   the exact retriever with the same signature
    degraded             True once `degrade_to_fallback` was taken
    """

    cfg: Any  # the normalised FOPOConfig (resolved knobs written back)
    retriever: Retriever
    initial_index_state: Any
    fallback_retriever: Retriever
    degraded: bool = False

    def degrade_to_fallback(self) -> "ExecutionPlan":
        """A new frozen plan whose retriever is the pre-resolved exact
        fallback, with the same operands. Idempotent."""
        if self.degraded:
            return self
        return dataclasses.replace(
            self, retriever=self.fallback_retriever, degraded=True
        )

    @classmethod
    def resolve(cls, cfg, *, retriever_kwargs: dict | None = None) -> "ExecutionPlan":
        """Validate ``cfg`` and resolve its retriever from
        ``retriever_kwargs`` (the prebuilt "index", "n_probe",
        "cap_tile")."""
        from repro_torch.kernels.ivf_topk.ops import ivf_topk
        from repro_torch.mips import refresh as refresh_mod
        from repro_torch.mips.exact import topk_exact

        kw = retriever_kwargs or {}
        _validate(cfg, kw)
        if cfg.top_k > cfg.num_items:
            # a top_k past the catalog must not reach the retriever
            cfg = dataclasses.replace(cfg, top_k=cfg.num_items)
        index, n_probe = _resolve_ivf_pallas_kwargs(kw)
        top_k, num_items = cfg.top_k, cfg.num_items
        state = refresh_mod.init_refresh_state(
            index, num_items, cfg.index_refresh.delta_cap
        )

        def retriever(h, beta, state):  # noqa: ARG001 — uniform signature
            return ivf_topk(
                h, state.as_index(num_items), top_k, n_probe=n_probe,
                delta=state.delta(),
            )

        def fallback(h, beta, state):  # noqa: ARG001 — uniform signature
            return topk_exact(h, beta, top_k)

        return cls(
            cfg=cfg,
            retriever=retriever,
            initial_index_state=state,
            fallback_retriever=fallback,
        )

    # -- the query-only serve path --------------------------------------
    def execute_query(self, policy, params, x, beta, index_state=None) -> TopK:
        """h_theta(x) through the resolved retriever: no sampling, no
        reward, no surrogate. The maintained index rides as
        ``index_state`` (default: the plan's initial state)."""
        from repro_torch.obs.trace import span

        with span("user_embedding", route="serve"):
            h = policy.user_embedding(params, x).detach()
        return self.retrieve(h, beta, index_state)

    def retrieve(self, h: torch.Tensor, beta: torch.Tensor, index_state=None) -> TopK:
        from repro_torch.obs.trace import span

        state = index_state if index_state is not None else self.initial_index_state
        with span("retrieval", route=self.cfg.retriever):
            return self.retriever(h, beta, state)
