"""The resolved ExecutionPlan of one FOPO training step, and of the
query-only serve path.

`FOPOConfig` is a knob matrix (`retriever`, `fused`, `fused_sampler`,
`sample_tile`, `index_refresh`, `dist`); `ExecutionPlan.resolve`
validates it and resolves it once into a frozen object that knows which
retriever, which sampler and which surrogate run:

  cfg.sample_tile    -> plan.sample_tile    the clamped tile (S padding)
  cfg.retriever      -> plan.retriever      (h, beta) -> TopK; with
                                            index_refresh (h, beta, state)
  cfg.fused_sampler  -> plan.fused_sampler  the in-kernel sampler vs the
                                            generator-driven MixtureProposal
  cfg.fused          -> plan.fused          the fused autograd Function
                                            (covgrad kernels) vs plain torch

  cfg.dist           -> plan.dist           the multi-device step of
                                            `repro_torch.dist` (dist
                                            implies fused)

`execute` is the Algorithm-1 step body (retrieval -> sample -> reward ->
surrogate); `execute_query` the serve path (user embedding -> retrieval).
``fused_interpret`` is accepted and written back as the reference does,
but the port ignores it: a tensor's device picks the kernel or its plain
version.

Under ``dist`` the skeleton is the same; what it is handed is this
rank's: ``x`` its batch rows, ``beta`` its slab (`dist.shard_rows`), the
index state its shard. Retrieval is the sharded exact top-K merge
(`dist_sharded_topk`), or, with ``retriever="ivf_pallas"``, the IVF
kernel over the rank's shard of a `ShardedIVFIndex` (``n_shards`` must
equal ``n_model``); the in-kernel sampler runs per data rank at its row
offset, the generator-driven samplers draw the full batch and keep the
rank's rows; the surrogate is `dist_fused_covariance_loss`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.snis_covgrad.ops import resolve_sample_tile
from repro_torch.mips.exact import TopK

__all__ = ["ExecutionPlan", "RETRIEVERS", "make_retriever"]

Retriever = Callable[..., TopK]

RETRIEVERS = ("exact", "streaming", "ivf", "ivf_pallas", "sharded", "pallas")


def make_retriever(cfg, **kw) -> Retriever:
    """Build the configured MIPS retriever (h, beta) -> TopK."""
    if cfg.retriever == "exact":
        from repro_torch.mips.exact import topk_exact

        return lambda h, beta: topk_exact(h, beta, cfg.top_k)
    if cfg.retriever == "streaming":
        from repro_torch.mips.streaming import topk_streaming

        block = kw.get("block_items", 4096)
        return lambda h, beta: topk_streaming(h, beta, cfg.top_k, block_items=block)
    if cfg.retriever == "pallas":
        from repro_torch.kernels.mips_topk.ops import mips_topk

        return lambda h, beta: mips_topk(h, beta, cfg.top_k)
    if cfg.retriever == "ivf":
        from repro_torch.mips.ivf import DEFAULT_N_PROBE, ivf_query

        index = kw["index"]  # prebuilt IVFIndex (Assumption 1: beta fixed)
        n_probe = kw.get("n_probe", DEFAULT_N_PROBE)
        return lambda h, beta: ivf_query(index, h, cfg.top_k, n_probe=n_probe)
    if cfg.retriever == "ivf_pallas":
        from repro_torch.kernels.ivf_topk.ops import ivf_topk

        index, n_probe = _resolve_ivf_pallas_kwargs(kw)
        return lambda h, beta: ivf_topk(h, index, cfg.top_k, n_probe=n_probe)
    if cfg.retriever == "sharded":
        from repro_torch.mips.sharded import make_sharded_topk_fn

        # beta is this rank's slab of the group's row partition
        return make_sharded_topk_fn(kw["group"], cfg.top_k, kw.get("block_items", 4096))
    raise ValueError(f"unknown retriever {cfg.retriever!r}")


def _resolve_ivf_pallas_kwargs(kw: dict):
    """Tile-align the prebuilt index once (the reference's layout) and pin
    the n_probe default. Returns (aligned index, n_probe)."""
    from repro_torch.kernels.ivf_topk.ops import tile_align_index
    from repro_torch.mips.ivf import DEFAULT_N_PROBE

    index, _ = tile_align_index(kw["index"], kw.get("cap_tile"))
    return index, kw.get("n_probe", DEFAULT_N_PROBE)


def _dist_retriever(cfg, kw: dict) -> Retriever:
    """The dist route's (h, beta_slab) -> TopK: the IVF kernel over this
    rank's shard of a `ShardedIVFIndex` (moved once to the queries'
    device), else the sharded exact top-K merge."""
    from repro_torch.dist.fopo import dist_ivf_topk, dist_sharded_topk

    d, top_k, n_items = cfg.dist, cfg.top_k, cfg.num_items
    if cfg.retriever != "ivf_pallas":
        return lambda h, beta: dist_sharded_topk(h, beta, top_k, d, num_items=n_items)
    index, n_probe = _resolve_ivf_pallas_kwargs(kw)
    shard = {"index": index.shard(d.model_rank)}

    def retriever(h, beta):  # noqa: ARG001 — uniform signature
        ix = shard["index"]
        if ix.lists.device != h.device:
            ix = shard["index"] = type(ix)(*(t.to(h.device) for t in ix[:3]), ix.num_items)
        return dist_ivf_topk(h, ix, top_k, d, n_probe=n_probe)

    return retriever


def _validate(cfg, *, injected_retriever: bool, retriever_kwargs: dict) -> None:
    """Construction-time knob validation: every invalid combination fails
    here, before any step runs."""
    if cfg.num_items <= 0:
        raise ValueError(
            f"FOPOConfig.num_items must be > 0, got {cfg.num_items}"
        )
    if cfg.num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {cfg.num_samples}")
    if cfg.top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {cfg.top_k}")
    if cfg.dist is not None:
        from repro_torch.dist.fopo import DistConfig

        if not isinstance(cfg.dist, DistConfig):
            raise ValueError(
                "FOPOConfig.dist must be a DistConfig (or None), got "
                f"{type(cfg.dist).__name__}"
            )
    if isinstance(cfg.epsilon, (int, float)) and not 0.0 <= cfg.epsilon <= 1.0:
        raise ValueError(f"epsilon must lie in [0, 1], got {cfg.epsilon}")
    if not injected_retriever and cfg.retriever not in RETRIEVERS:
        # the typo guard fires under dist too: a misspelt retriever must
        # never fall back to the sharded exact scan
        raise ValueError(
            f"unknown retriever {cfg.retriever!r} (one of {RETRIEVERS})"
        )
    if not injected_retriever and cfg.dist is not None and cfg.retriever == "ivf":
        raise ValueError(
            'retriever="ivf" has no dist route (the plain query would '
            "materialise the candidate tensor per shard); use "
            'retriever="ivf_pallas" with build_ivf_sharded, or drop the '
            "knob to take the sharded top-K merge"
        )
    if not injected_retriever and cfg.dist is None:
        if cfg.retriever in ("ivf", "ivf_pallas") and "index" not in retriever_kwargs:
            raise ValueError(
                f'retriever="{cfg.retriever}" needs a prebuilt index: pass '
                "retriever_kwargs={'index': build_ivf(...)}"
            )
        if cfg.retriever == "ivf_pallas":
            from repro_torch.mips.ivf import IVFIndex

            if not isinstance(retriever_kwargs["index"], IVFIndex):
                raise ValueError(
                    'retriever="ivf_pallas" without dist= takes a single '
                    f"IVFIndex (got {type(retriever_kwargs['index']).__name__}); "
                    "under dist= pass a ShardedIVFIndex from build_ivf_sharded"
                )
        if cfg.retriever == "sharded" and "group" not in retriever_kwargs:
            raise ValueError(
                'retriever="sharded" needs retriever_kwargs={"group": ...} (the '
                "process group beta's rows are split over)"
            )
    if not injected_retriever and cfg.dist is not None and cfg.retriever == "ivf_pallas":
        # the one retriever the dist path resolves itself: each model
        # rank probes its LOCAL inverted lists, so the index must be the
        # per-shard stacked build
        from repro_torch.mips.ivf import ShardedIVFIndex

        index = retriever_kwargs.get("index")
        if not isinstance(index, ShardedIVFIndex):
            raise ValueError(
                'retriever="ivf_pallas" under dist= needs retriever_kwargs='
                "{'index': build_ivf_sharded(...)} with n_shards == the "
                f"mesh model-axis size (got {type(index).__name__})"
            )
        if index.n_shards != cfg.dist.n_model:
            raise ValueError(
                f"ShardedIVFIndex has {index.n_shards} shards but the mesh "
                f"model axis is {cfg.dist.n_model}"
            )
    rc = cfg.index_refresh
    if rc is None:
        return
    from repro_torch.mips.refresh import RefreshConfig

    if not isinstance(rc, RefreshConfig):
        raise ValueError(
            "FOPOConfig.index_refresh must be a RefreshConfig (or None), "
            f"got {type(rc).__name__}"
        )
    if injected_retriever:
        raise ValueError(
            "index_refresh= cannot combine with an injected retriever: the "
            "refresh path owns retriever construction"
        )
    if cfg.retriever != "ivf_pallas":
        raise ValueError(
            "index_refresh= requires retriever='ivf_pallas' (the only "
            f"maintained index layout), got {cfg.retriever!r}"
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
    if cfg.dist is not None and cfg.num_items % cfg.dist.n_model:
        raise ValueError(
            "index_refresh under dist= needs num_items divisible by the mesh "
            f"model axis (got {cfg.num_items} rows over {cfg.dist.n_model} "
            "shards): the per-shard slot_of maps are sized by the uniform row slab"
        )


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """What `FOPOConfig` leaves implicit, resolved once.

    retriever            (h, beta) -> TopK; with a refresh route
                         (h, beta, state) -> TopK through `ivf_topk`
    sample_tile          the clamped kernel tile
    fused_sampler        in-kernel sampler (True) or MixtureProposal
    fused                fused covgrad autograd Function (True) or the
                         plain-torch surrogate (dist implies fused)
    dist                 the DistConfig of the multi-device step, or None
    refresh              the RefreshConfig, or None
    initial_index_state  the RefreshState built from the caller's index
    fallback_retriever   the exact retriever with the refresh signature
    degraded             True once `degrade_to_fallback` was taken
    """

    cfg: Any  # the normalised FOPOConfig (resolved knobs written back)
    sample_tile: int
    fused: bool
    fused_sampler: bool
    retriever: Retriever
    dist: Any = None
    refresh: Any = None
    initial_index_state: Any = None
    fallback_retriever: Retriever | None = None
    degraded: bool = False

    def degrade_to_fallback(self) -> "ExecutionPlan":
        """A new frozen plan whose retriever is the pre-resolved exact
        fallback, with the same operands. Idempotent."""
        if self.degraded:
            return self
        if self.fallback_retriever is None:
            raise ValueError(
                "plan has no fallback retriever (only refresh plans resolve "
                "one: nothing to degrade to)"
            )
        return dataclasses.replace(
            self, retriever=self.fallback_retriever, degraded=True
        )

    @classmethod
    def resolve(
        cls,
        cfg,
        *,
        retriever: Retriever | None = None,
        retriever_kwargs: dict | None = None,
    ) -> "ExecutionPlan":
        """Validate ``cfg`` and resolve it. ``retriever`` injects a
        prebuilt (h, beta) -> TopK retriever and skips construction;
        otherwise ``retriever_kwargs`` feeds the configured one (the
        prebuilt "index", "n_probe", "cap_tile", "block_items")."""
        kw = retriever_kwargs or {}
        _validate(cfg, injected_retriever=retriever is not None, retriever_kwargs=kw)
        tile = resolve_sample_tile(cfg.sample_tile, cfg.num_samples)
        # write the resolved knobs back, so what runs is what plan.cfg says
        if tile != cfg.sample_tile:
            cfg = dataclasses.replace(cfg, sample_tile=tile)
        if cfg.top_k > cfg.num_items:
            # a top_k past the catalog must not reach the retriever
            cfg = dataclasses.replace(cfg, top_k=cfg.num_items)
        if (cfg.fused or cfg.fused_sampler) and cfg.fused_interpret is None:
            # the reference writes its resolved interpret mode back; the
            # port has none (the tensor's device picks kernel or plain)
            cfg = dataclasses.replace(cfg, fused_interpret=False)
        refresh = cfg.index_refresh
        state = fallback = None
        d = cfg.dist
        if refresh is not None and d is None:
            from repro_torch.kernels.ivf_topk.ops import ivf_topk
            from repro_torch.mips import refresh as refresh_mod
            from repro_torch.mips.exact import topk_exact

            index, n_probe = _resolve_ivf_pallas_kwargs(kw)
            top_k, n_items = cfg.top_k, cfg.num_items
            state = refresh_mod.init_refresh_state(index, n_items, refresh.delta_cap)

            def retriever(h, beta, state):  # noqa: ARG001 — uniform signature
                return ivf_topk(
                    h, state.as_index(n_items), top_k, n_probe=n_probe,
                    delta=state.delta(),
                )

            def fallback(h, beta, state):  # noqa: ARG001 — uniform signature
                return topk_exact(h, beta, top_k)

        elif refresh is not None:
            # this rank maintains the shard of its model coordinate: the
            # per-shard op gives that shard of `init_refresh_sharded`
            from repro_torch.dist.fopo import dist_ivf_topk, dist_sharded_topk
            from repro_torch.mips import refresh as refresh_mod

            index, n_probe = _resolve_ivf_pallas_kwargs(kw)
            top_k, n_items = cfg.top_k, cfg.num_items
            rows = n_items // d.n_model
            state = refresh_mod.init_refresh_state(
                index.shard(d.model_rank), rows, refresh.delta_cap,
                id_base=d.model_rank * rows,
            )

            def retriever(h, beta, state):  # noqa: ARG001 — uniform signature
                return dist_ivf_topk(
                    h, state.as_index(n_items), top_k, d, n_probe=n_probe,
                    delta=state.delta(),
                )

            def fallback(h, beta, state):  # noqa: ARG001 — uniform signature
                return dist_sharded_topk(h, beta, top_k, d, num_items=n_items)

        elif retriever is None and d is None:
            retriever = make_retriever(cfg, **kw)
        elif retriever is None:
            retriever = _dist_retriever(cfg, kw)
        return cls(
            cfg=cfg,
            sample_tile=tile,
            fused=bool(cfg.fused or d is not None),
            fused_sampler=bool(cfg.fused_sampler),
            retriever=retriever,
            dist=d,
            refresh=refresh,
            initial_index_state=state,
            fallback_retriever=fallback,
        )

    # -- the query-only serve path --------------------------------------
    def execute_query(self, policy, params, x, beta, index_state=None) -> TopK:
        """h_theta(x) through the resolved retriever: no sampling, no
        reward, no surrogate. A maintained index rides as
        ``index_state`` (default: the plan's initial state)."""
        h = self._user_embedding(policy, params, x, route="serve")
        return self.retrieve(h, beta, index_state)

    def _user_embedding(self, policy, params, x, route="train") -> torch.Tensor:
        """h_theta(x), detached: the training and serving paths embed
        identically."""
        from repro_torch.obs.trace import span

        with span("user_embedding", route=route):
            return policy.user_embedding(params, x).detach()

    # -- the step skeleton: retrieval -> sample -> reward -> surrogate ---
    def execute(
        self,
        policy,
        params,
        seed: int,
        x: torch.Tensor,  # [B, Dx]
        beta: torch.Tensor,  # [P, L] fixed item embeddings
        reward_fn,  # actions [B, S] -> [B, S]
        epsilon: float | torch.Tensor | None = None,
        index_state=None,
    ) -> tuple[torch.Tensor, dict]:
        """One Algorithm-1 step body; returns (loss, aux). ``seed`` is
        this step's int32 seed: the in-kernel sampler's counter-hash
        seed, or the seed of the generator the other samplers draw
        from. The spans time the host side of each phase (a span around
        a CUDA launch ends when the launch is queued)."""
        from repro_torch.obs.trace import span

        eps = self.cfg.epsilon if epsilon is None else epsilon
        h_prop = self._user_embedding(policy, params, x)
        sample = self.draw(seed, h_prop, beta, eps, index_state=index_state)
        # clamp keeps reward lookups in range on pre-masked (padded) slots;
        # their reward is zeroed and their SNIS weight is 0
        valid = sample.actions >= 0
        with span("reward"):
            rewards = (reward_fn(sample.actions.clamp(min=0)) * valid).detach()
        with span("surrogate"):
            return self.surrogate(policy, params, x, beta, sample, rewards)

    def retrieve(self, h: torch.Tensor, beta: torch.Tensor, index_state=None) -> TopK:
        from repro_torch.obs.trace import span

        with span("retrieval", route=self.cfg.retriever):
            if self.refresh is not None:
                state = index_state if index_state is not None else self.initial_index_state
                return self.retriever(h, beta, state)
            return self.retriever(h, beta)

    def draw(self, seed: int, h_prop, beta, eps, index_state=None):
        """Step 4: S proposal draws per context. A float eps >= 1 skips
        retrieval (pure uniform proposal); a tensor eps takes the
        mixture route, which reproduces the uniform pmf at eps == 1."""
        from repro_torch.obs.trace import span

        if isinstance(eps, (int, float)) and eps >= 1.0:
            with span("sample", route="uniform"):
                return self._draw_uniform(seed, h_prop.shape[0], h_prop.device)
        topk = self.retrieve(h_prop, beta, index_state)
        with span("sample", route="fused" if self.fused_sampler else "mixture"):
            return self._draw_mixture(seed, topk, eps)

    def _draw_uniform(self, seed: int, batch: int, device):
        from repro_torch.core.proposals import ProposalSample, UniformProposal

        gen = _generator(device, seed)
        prop = UniformProposal(self.cfg.num_items)
        if self.dist is None:
            return prop.sample(gen, batch, self.cfg.num_samples, device=device)
        # the full batch from the same generator state on every rank
        from repro_torch.dist.fopo import data_rows

        full = prop.sample(gen, batch * self.dist.n_data, self.cfg.num_samples, device=device)
        return ProposalSample(*(data_rows(t, self.dist) for t in full))

    def _draw_mixture(self, seed: int, topk: TopK, eps):
        from repro_torch.core.proposals import MixtureProposal, ProposalSample

        cfg = self.cfg
        if self.fused_sampler and self.dist is not None:
            from repro_torch.dist.fopo import dist_fused_mixture_sample

            return dist_fused_mixture_sample(
                seed, topk, num_samples=cfg.num_samples, epsilon=eps,
                num_items=cfg.num_items, sample_tile=self.sample_tile, dist=self.dist,
            )
        if self.fused_sampler:
            from repro_torch.kernels.fused_sampler.ops import fused_mixture_sample

            actions, log_q, slots = fused_mixture_sample(
                seed, topk.indices, topk.scores, num_samples=cfg.num_samples,
                epsilon=eps, num_items=cfg.num_items, sample_tile=self.sample_tile,
            )
            return ProposalSample(actions=actions, log_q=log_q, topk_slot=slots)
        gen = _generator(topk.scores.device, seed)

        def draw(indices, scores):
            return MixtureProposal(cfg.num_items, eps).sample(
                gen, indices, scores, cfg.num_samples
            )

        if self.dist is None:
            return draw(topk.indices, topk.scores)
        from repro_torch.dist.fopo import sample_replicated

        return sample_replicated(self.dist, draw, topk.indices, topk.scores)

    def surrogate(self, policy, params, x, beta, sample, rewards) -> tuple[torch.Tensor, dict]:
        """Step 5: SNIS weights + covariance-gradient surrogate, through
        the fused kernels or in plain torch as the plan resolved."""
        from repro_torch.core.gradients import covariance_surrogate

        return covariance_surrogate(
            policy, params, x, beta, sample.actions, sample.log_q, rewards,
            fused=self.fused, sample_tile=self.sample_tile, dist=self.dist,
        )


def _generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``; on the meta device
    (a trace that runs no draw, `launch.dryrun`) a CPU one, which meta
    tensors take."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
