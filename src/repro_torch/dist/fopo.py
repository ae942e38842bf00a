"""The multi-device fused FOPO training step, one process per device.

Single-device FOPO caps the catalog at one device's memory: beta [P, L]
must be resident wherever the gather kernels run. This module lifts the
cap as the reference's `repro/dist/fopo.py` does, by sharding beta's
rows over the `model` group and the batch over the `data` group, while
keeping the per-device kernels:

  1. retrieval — `mips.sharded.sharded_topk` over the rank's slab and a
     K-merge along `model` (communication O(n B K), never O(P)); or the
     IVF kernel over the rank's own inverted lists (`dist_ivf_topk`);
  2. sampling — the in-kernel sampler (K5) per data rank with
     ``row_offset = d * B_local``, so rank d draws exactly rows
     [d B_local, (d+1) B_local) of the single-device stream; the
     generator-driven samplers draw the full batch from the same
     generator state on every rank and keep their rows
     (`sample_replicated`);
  3. id routing — `collectives.gather_samples` (``routing="gather"``)
     and `collectives.rebase_ids`: foreign ids become the kernels'
     dead-slot sentinel -1;
  4. local kernels — K2 (scores mode) scores only owned slots, K4
     regathers only owned rows;
  5. reduction — ONE all-reduce of the score partials over `model`
     (`collectives.psum_scores`): each slot receives its owner's bits
     plus exact zeros, so the scores equal the single-device path's bit
     for bit; the SNIS normaliser is computed locally after it. grad_h
     sums over `model` the same way.

The grid: `DistConfig` holds two process groups cut from the default
group. Rank r sits at data coordinate ``r // n_model`` and model
coordinate ``r % n_model`` (the row-major layout of the reference's
``jax.make_mesh((data, model))``). Each rank holds theta (replicated),
beta's slab of ``rows = ceil(P / n_model)`` rows ``[m rows, (m+1) rows)``
(zero-padded at a ragged tail: `pad_rows`' rule) and its batch rows
``[d B / n_data, (d+1) B / n_data)``; `shard_rows` and `data_rows` cut
them. Every function here takes the rank's own pieces and must be
called by every rank of the groups it names, in the same order.

The loss: each data rank's surrogate is ``-(1/B) sum`` over its own rows
(B the global batch); its value and the SNIS diagnostics are summed over
`data` in the forward, so every rank reports (and guards on) the global
numbers, and the backward hands each rank the gradient of its own rows.
The theta gradient is then summed over `data` by the caller (the
trainer), the reference's data-sharded batch reduction. Gradients flow
to h only; beta is fixed (Assumption 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as tdist

from repro_torch.core.proposals import ProposalSample
from repro_torch.core.snis import effective_sample_size, snis_covariance_coefficients
from repro_torch.dist.collectives import (
    all_gather,
    all_reduce,
    gather_samples,
    pad_rows,
    pad_samples,
    padded_len,
    psum_scores,
    rebase_ids,
)
from repro_torch.kernels.snis_covgrad.ops import (
    DEFAULT_SAMPLE_TILE,
    resolve_sample_tile,
    snis_covgrad_bwd,
    snis_scores_fused,
)
from repro_torch.mips.exact import TopK
from repro_torch.mips.ivf import DEFAULT_N_PROBE

__all__ = [
    "DistConfig",
    "data_rows",
    "dist_fopo_loss",
    "dist_fused_covariance_loss",
    "dist_fused_mixture_sample",
    "dist_ivf_topk",
    "dist_scores",
    "dist_score_partials",
    "dist_sharded_topk",
    "dist_verdict_agree",
    "make_debug_dist",
    "sample_replicated",
    "shard_rows",
    "slab_rows",
]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """This rank's place on the (data, model) grid: the process group of
    the ranks that share its model coordinate (``data_group``, over which
    the batch is split) and of those that share its data coordinate
    (``model_group``, over which beta's rows are split).

    ``routing`` picks how sampled ids reach the beta shards, as the
    reference's does: "gather" slices each rank's S/n columns and
    all-gathers them back along `model` (the explicit collective);
    "replicate" uses the full draw every rank already holds. Both give
    the same bits."""

    data_group: Any
    model_group: Any
    routing: str = "gather"

    def __post_init__(self):
        if self.routing not in ("gather", "replicate"):
            raise ValueError(f"unknown routing {self.routing!r}")

    @property
    def n_data(self) -> int:
        return tdist.get_world_size(self.data_group)

    @property
    def n_model(self) -> int:
        return tdist.get_world_size(self.model_group)

    @property
    def data_rank(self) -> int:
        return tdist.get_rank(self.data_group)

    @property
    def model_rank(self) -> int:
        return tdist.get_rank(self.model_group)


def make_debug_dist(data: int = 2, model: int = 2, **kw) -> DistConfig:
    """The `DistConfig` of this rank on a (data, model) grid over the
    initialised default group, whose size must be ``data * model``.
    Every rank must call it (it makes every group, in one order)."""
    if not tdist.is_initialized():
        raise ValueError("make_debug_dist needs an initialised default process group")
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if world != data * model:
        raise ValueError(f"a {data} x {model} grid needs {data * model} ranks, not {world}")
    mine = {}
    for m in range(model):
        g = tdist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            mine["data_group"] = g
    for d in range(data):
        g = tdist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            mine["model_group"] = g
    return DistConfig(**mine, **kw)


def slab_rows(num_items: int, n_model: int) -> int:
    """Rows of each beta slab: ceil(P / n_model), `pad_rows`' rule."""
    return padded_len(num_items, n_model) // n_model


def shard_rows(beta: torch.Tensor, dist_cfg: DistConfig) -> torch.Tensor:
    """This rank's slab of a full [P, L] table: rows [m rows, (m+1) rows)
    of the table zero-padded to n_model * rows."""
    rows = slab_rows(beta.shape[0], dist_cfg.n_model)
    lo = dist_cfg.model_rank * rows
    return pad_rows(beta, dist_cfg.n_model)[lo:lo + rows]


def data_rows(x: torch.Tensor, dist_cfg: DistConfig) -> torch.Tensor:
    """This rank's rows of a global batch [B, ...]: [d B/n, (d+1) B/n)."""
    b = x.shape[0]
    n = dist_cfg.n_data
    if b % n:
        raise ValueError(f"batch {b} must be a multiple of the data-axis size ({n})")
    bl = b // n
    return x[dist_cfg.data_rank * bl:(dist_cfg.data_rank + 1) * bl]


def _my_columns(t: torch.Tensor, dist_cfg: DistConfig) -> torch.Tensor:
    """This model rank's S/n columns of a [B, S] tensor (S % n == 0): the
    sample-sharded operand the "gather" routing starts from."""
    w = t.shape[1] // dist_cfg.n_model
    return t[:, dist_cfg.model_rank * w:(dist_cfg.model_rank + 1) * w]


def _routed(dist_cfg: DistConfig, *tensors: torch.Tensor) -> tuple:
    """The full (B, S) operands every model rank needs: under "gather"
    each rank's column share all-gathered along `model`."""
    if dist_cfg.routing == "gather":
        return gather_samples(
            dist_cfg.model_group, *(_my_columns(t, dist_cfg) for t in tensors)
        )
    return tensors


def _local_score_partial(dist_cfg, tile, h, beta_slab, actions, log_q, rewards):
    """One rank's score partial: route ids, rebase them to the slab, run
    K2 in scores mode and zero the slots this rank does not own (a dead
    slot scores h . beta_slab[0] in the kernel, so the mask is what makes
    the sum over `model` the owner's value exactly)."""
    actions, log_q, rewards = _routed(dist_cfg, actions, log_q, rewards)
    local, owned = rebase_ids(actions, beta_slab.shape[0], dist_cfg.model_rank)
    part = snis_scores_fused(h, beta_slab, local, log_q, rewards, sample_tile=tile)
    return torch.where(owned, part, 0.0)


def _pad_for_routing(dist_cfg, actions, log_q, rewards):
    if dist_cfg.routing == "gather":
        return pad_samples(actions, log_q, rewards, dist_cfg.n_model)
    return actions, log_q, rewards


def dist_score_partials(
    h, beta_slab, actions, log_q, rewards, *, dist: DistConfig,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
) -> torch.Tensor:
    """This rank's score partial [B_local, S_routed] BEFORE the sum over
    `model`: an observability hook (a shard that owns no sampled id must
    give exact zeros)."""
    tile = resolve_sample_tile(sample_tile, actions.shape[1])
    actions, log_q, rewards = pad_samples(actions, log_q, rewards, dist.n_model)
    return _local_score_partial(dist, tile, h, beta_slab, actions, log_q, rewards)


def dist_scores(
    h, beta_slab, actions, log_q, rewards, *, dist: DistConfig,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
) -> torch.Tensor:
    """The sampled scores [B_local, S] of this rank's rows: the partials
    summed once over `model`, cropped to S (bit for bit the single-device
    K2 scores)."""
    s = actions.shape[1]
    tile = resolve_sample_tile(sample_tile, s)
    actions, log_q, rewards = _pad_for_routing(dist, actions, log_q, rewards)
    part = _local_score_partial(dist, tile, h, beta_slab, actions, log_q, rewards)
    return psum_scores(part, dist.model_group)[:, :s]


def _row_sums(coeff, scores, wbar, rewards) -> torch.Tensor:
    """[4]: this rank's sums over its rows of the loss term and of the
    three diagnostics' row values (`snis_diagnostics`' terms)."""
    return torch.stack([
        torch.sum(torch.sum(coeff * scores, dim=-1)),
        torch.sum(effective_sample_size(wbar)),
        torch.sum(torch.sum(wbar * rewards, dim=-1)),
        torch.sum(torch.max(wbar, dim=-1).values),
    ])


class DistCovarianceLoss(torch.autograd.Function):
    """(loss, ess, rbar, max_wbar) of the dist step, global values; the
    gradient flows to this rank's h rows only."""

    @staticmethod
    def forward(ctx, h, beta_slab, actions, log_q, rewards, dist_cfg, tile):
        s = actions.shape[1]
        b_global = h.shape[0] * dist_cfg.n_data
        actions_r, log_q_r, rewards_r = _pad_for_routing(dist_cfg, actions, log_q, rewards)
        part = _local_score_partial(dist_cfg, tile, h, beta_slab, actions_r, log_q_r, rewards_r)
        # crop the routing pad BEFORE the SNIS chain, as the reference does:
        # on equal shapes the softmax and the sums match the single path
        scores = psum_scores(part, dist_cfg.model_group)[:, :s]
        wbar = torch.softmax(scores - log_q, dim=-1) * (actions >= 0)
        coeff = snis_covariance_coefficients(wbar, rewards)
        sums = all_reduce(_row_sums(coeff, scores, wbar, rewards),
                          group=dist_cfg.data_group, name="loss_sums")
        loss = -sums[0] / b_global
        diag = tuple(sums[1:] / b_global)
        ctx.save_for_backward(coeff, actions_r, beta_slab)
        ctx.dist_cfg, ctx.tile, ctx.b_global = dist_cfg, tile, b_global
        ctx.mark_non_differentiable(*diag)
        return (loss,) + diag

    @staticmethod
    def backward(ctx, ct_loss, *_ct_aux):  # diagnostics' cotangents are discarded
        coeff, actions_r, beta_slab = ctx.saved_tensors
        d = ctx.dist_cfg
        g = (-ct_loss / ctx.b_global) * coeff  # [B_local, S]
        sp = actions_r.shape[1]
        if sp != g.shape[1]:  # re-pad to the routed width; pad slots are dead
            g = torch.cat([g, g.new_zeros((g.shape[0], sp - g.shape[1]))], dim=1)
        g, acts = _routed(d, g, actions_r)
        local, _ = rebase_ids(acts, beta_slab.shape[0], d.model_rank)
        part = snis_covgrad_bwd(g, local, beta_slab, sample_tile=ctx.tile)
        grad_h = all_reduce(part, group=d.model_group, name="grad_h")
        return grad_h, None, None, None, None, None, None


def dist_fused_covariance_loss(
    h: torch.Tensor,  # [B_local, L] this rank's user embeddings (differentiable)
    beta_slab: torch.Tensor,  # [rows, L] this rank's slab (`shard_rows`)
    actions: torch.Tensor,  # [B_local, S] int global ids; -1 marks masked slots
    log_q: torch.Tensor,  # [B_local, S]; LOG_Q_PAD on masked slots
    rewards: torch.Tensor,  # [B_local, S]
    *,
    dist: DistConfig,
    sample_tile: int = DEFAULT_SAMPLE_TILE,
) -> tuple[torch.Tensor, dict]:
    """The multi-device fused FOPO step: (loss, aux), both the global
    batch's, through `DistCovarianceLoss`. Equal to the single-device
    `fused_covariance_loss` per slot bit for bit on the scores; the loss
    and grad_h differ only by the reassociation of the sums over the
    sharded dims (~1e-6 relative)."""
    tile = resolve_sample_tile(sample_tile, actions.shape[1])
    loss, *diag = DistCovarianceLoss.apply(
        h, beta_slab, actions, log_q.float(), rewards.float(), dist, tile
    )
    return loss, dict(zip(("ess", "rbar", "max_wbar"), diag))


# ---------------------------------------------------------------------------
# retrieval, sampling and the whole step on the grid
# ---------------------------------------------------------------------------

def dist_sharded_topk(
    h: torch.Tensor,  # [B_local, L]
    beta_slab: torch.Tensor,  # [rows, L]
    k: int,
    dist: DistConfig,
    *,
    num_items: int | None = None,
    block_items: int = 4096,
) -> TopK:
    """Retrieval over the row-sharded (and, if ragged, padded) catalog:
    the plain streaming top-K over the slab and a K-merge along `model`.
    Pad rows are masked out before the merge (``num_items``)."""
    from repro_torch.mips.sharded import sharded_topk

    return sharded_topk(h, beta_slab, k, dist.model_group, block_items, num_items)


def dist_ivf_topk(
    h: torch.Tensor,  # [B_local, L]
    index,  # this rank's IVFIndex (global ids), or the ShardedIVFIndex
    k: int,
    dist: DistConfig,
    *,
    n_probe: int = DEFAULT_N_PROBE,
    delta=None,  # this shard's (lists [C, dcap], embs [C, dcap, L]), or stacked
) -> TopK:
    """Sublinear retrieval on the grid: the IVF kernel (K7) over this
    rank's own inverted lists (ids global, the slab offset baked in by
    `build_ivf_sharded`), delta buffers included, then the same K-merge
    along `model` as the exact route."""
    from repro_torch.kernels.ivf_topk.ops import ivf_topk
    from repro_torch.mips.ivf import ShardedIVFIndex
    from repro_torch.mips.sharded import merge_topk_along_axis

    m = dist.model_rank
    if isinstance(index, ShardedIVFIndex):
        index = index.shard(m)
    if delta is not None and delta[0].dim() == 3:
        delta = (delta[0][m], delta[1][m])
    loc = ivf_topk(h, index, k, n_probe=n_probe, delta=delta)
    return merge_topk_along_axis(loc.scores, loc.indices, k, dist.model_group)


def sample_replicated(dist: DistConfig, draw, *row_tensors: torch.Tensor) -> ProposalSample:
    """A generator-driven draw with the single-device stream: each
    operand's rows are gathered over `data`, every rank draws the full
    batch from the same generator state (``draw(*full_operands)``), and
    keeps its own rows."""
    full = [all_gather(t, dist.data_group, name="sample_rows") for t in row_tensors]
    sample = draw(*full)
    return ProposalSample(*(data_rows(t, dist) for t in sample))


def dist_fused_mixture_sample(
    seed,
    topk: TopK,  # [B_local, K] this rank's rows
    *,
    num_samples: int,
    epsilon,
    num_items: int,
    sample_tile: int,
    dist: DistConfig,
) -> ProposalSample:
    """The in-kernel eps-mixture sampler (K5) on the grid: one launch per
    rank over its own top-K rows, with ``row_offset = d * B_local`` so its
    counter-hash stream is keyed by the GLOBAL batch row: rank d draws
    exactly rows [d B_local, (d+1) B_local) of the single-device stream.
    The seed is folded once (`seed_from`) and is the same on every rank."""
    from repro_torch.kernels.fused_sampler.ops import fused_mixture_sample, seed_from

    b_local = topk.indices.shape[0]
    actions, log_q, slots = fused_mixture_sample(
        seed_from(seed), topk.indices, topk.scores, num_samples=num_samples,
        epsilon=epsilon, num_items=num_items, sample_tile=sample_tile,
        row_offset=dist.data_rank * b_local,
    )
    return ProposalSample(actions=actions, log_q=log_q, topk_slot=slots)


def dist_fopo_loss(
    policy,
    params,
    seed: int,
    x: torch.Tensor,  # [B_local, Dx] this rank's rows
    beta_slab: torch.Tensor,  # [rows, L] this rank's slab
    reward_fn,
    cfg,  # FOPOConfig with cfg.dist set
    retriever=None,
    epsilon=None,
) -> tuple[torch.Tensor, dict]:
    """Algorithm 1 on the grid: the `ExecutionPlan` skeleton with the
    dist hooks resolved (new code resolves a plan once and calls
    ``plan.execute``)."""
    from repro_torch.core.plan import ExecutionPlan

    plan = ExecutionPlan.resolve(cfg, retriever=retriever)
    return plan.execute(policy, params, seed, x, beta_slab, reward_fn, epsilon=epsilon)


def dist_verdict_agree(verdict: torch.Tensor, dist: DistConfig) -> torch.Tensor:  # noqa: ARG001
    """Agreement on a health verdict ([] int32 bitmask): MAX over the
    whole grid (the default group), so if ANY rank saw a bad step every
    rank sees a nonzero verdict and takes the same skip. MAX, never SUM:
    summing bitmasks aliases bits (2 x ESS_COLLAPSE would read as
    GRAD_SPIKE | NONFINITE_*), while MAX keeps any-bad -> all-bad."""
    return all_reduce(verdict.to(torch.int32), op=tdist.ReduceOp.MAX, name="verdict")
