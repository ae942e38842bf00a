"""The FOPO training driver, Algorithm 1 end to end, on one device or
one rank of the multi-device grid.

Wires together: the data loader, the linear policy and beta
(Assumption 1: fixed within a step; `update_items` churns it between
steps), the resolved `ExecutionPlan` (retriever, sampler, surrogate),
the optimizer, rotated checkpoints with restart from the latest, and
the run's telemetry. The same driver runs the REINFORCE baseline
(`estimator="reinforce"`) and the dense exact gradient
(`estimator="exact"`), as the reference's does.

Per-step randomness: the reference splits a JAX key per step and folds
it to the sampler's int32 seed. The port draws each step's int32 seed
from a CPU `torch.Generator` seeded from ``cfg.seed + 17``, unless a
callable ``step -> int32 seed`` is injected (``step_seeds=``): the
parity tests inject the reference's seeds. A step reads no device value
on the host; its loss is read after the step, as the reference's is.

With ``fopo.index_refresh`` the trainer maintains the IVF index
(`repro_torch.mips.refresh`) between steps: the scheduled refresh and
compaction, and `update_items`' delta appends, only launch work (they
read nothing on the host), so the step in flight never waits for them
and the next step sees the new state through the stream's order. The
refresh rows come from a device `torch.Generator` seeded from
``cfg.seed + 31``, unless ``refresh_rows`` (``step -> [minibatch] ids``)
is injected.

With ``health`` set the step runs guarded (`repro_torch.health.guard`):
a verdict over the loss, the gradient norm and the SNIS diagnostics,
skip-step recovery by a device-side select, rollback to the last good
snapshot after ``max_consecutive_bad`` bad steps, and (with
``health.index``) the retrieval degradation ladder: forced compaction,
warm rebuild, the plan's exact fallback. On rollback the reference
folds the restart count into its training key; the port sets its
step-seed generator back to the snapshot's state and reseeds it from a
draw of it and the restart count: the two are equal in distribution
only. A `FaultPlan` (`repro_torch.health.faults`) can be injected for
deterministic fault drills.

With ``obs`` set (`repro_torch.obs.ObsConfig`) the run leaves its
telemetry behind: the JSONL record stream, the phase spans' Chrome
trace, an optional `torch.profiler` trace and the roofline-drift series
against `predict_step_seconds`. Telemetry only observes: the trajectory
is the same bit for bit with it on or off.

With ``fopo.dist`` (a `repro_torch.dist.DistConfig`) this process is one
rank of the (data, model) grid and runs the FOPO estimator's dist step:
beta is taken in full and the rank keeps only its slab on the device;
each batch (the same on every rank: one loader seed) is cut to the
rank's data rows; the theta gradient is summed over the data group
before the update, so theta stays the same on every rank; the guard
agrees its verdict over the grid. A maintained index keeps the rank's
shard: the per-shard ops run on the slab, refresh rows come from a
per-shard device generator (``cfg.seed + 31 + model rank``; an injected
``refresh_rows`` returns [n_model, minibatch] slab rows, one row a
shard), and the ladder's monitor sees the worst overflow of the shards
(a MAX over the model group) and the recall of the merged shards.
Checkpoints go to a directory per rank (``rank_00000``, ...) under
``checkpoint_dir``. Every rank must run the same calls in the same order.
"""
from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from repro_torch.core.fopo import FOPOConfig, fopo_loss, reinforce_loss
from repro_torch.core.gradients import exact_objective
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.policy import SoftmaxPolicy, linear_tower_apply, linear_tower_init
from repro_torch.core.proposals import adaptive_epsilon
from repro_torch.core.rewards import make_session_reward
from repro_torch.core.snis import DIAGNOSTIC_KEYS
from repro_torch.data.loader import BatchLoader
from repro_torch.data.synthetic import SessionDataset
from repro_torch.device import resolve_device
from repro_torch.health.guard import (
    decode_verdict,
    grad_global_norm,
    guarded_update,
    init_guard_state,
    verdict_record,
)
from repro_torch.kernels.fused_sampler.ops import INT32_MAX
from repro_torch.mips import refresh as refresh_ops
from repro_torch.mips.exact import topk_exact
from repro_torch.mips.refresh import RefreshState
from repro_torch.obs.drift import predict_step_seconds
from repro_torch.obs.run import ObsConfig, ObsRun
from repro_torch.obs.schema import validate_history
from repro_torch.obs.sinks import format_rollback_line, format_train_line
from repro_torch.obs.trace import span
from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.train import checkpoint as ckpt

if TYPE_CHECKING:
    from repro_torch.health.faults import FaultPlan
    from repro_torch.health.guard import HealthConfig

__all__ = ["FOPOTrainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    """The reference's fields and defaults."""

    estimator: str = "fopo"  # fopo | reinforce | exact
    fopo: FOPOConfig = dataclasses.field(default_factory=lambda: FOPOConfig(num_items=0))
    batch_size: int = 32
    learning_rate: float = 1e-4
    num_steps: int = 1000
    grad_clip: float = 0.0
    adaptive_eps: bool = False  # beyond-paper: schedule eps 1.0 -> 0.1
    checkpoint_dir: str | None = None
    checkpoint_every: int = 500
    keep_checkpoints: int = 3
    eval_every: int = 0
    seed: int = 0
    # None runs the bare step; a HealthConfig guards it (verdict + skip),
    # rolls bad runs back, and HealthConfig.index arms the ladder
    health: "HealthConfig | None" = None
    # telemetry (repro_torch.obs): history and log lines always go through
    # the bus; an ObsConfig adds the run directory, the trace, the
    # profiler and the roofline-drift monitor
    obs: ObsConfig | None = None


class FOPOTrainer:
    """``device`` defaults to "cuda" and raises without CUDA. ``params``
    and ``opt_state`` start the run from given values (the parity tests
    pass the reference's, carried across by `repro_torch.convert`);
    ``step_seeds`` maps a step number to its int32 seed and
    ``refresh_rows`` a step number to the rows of its index refresh."""

    def __init__(
        self,
        cfg: TrainerConfig,
        dataset: SessionDataset,
        *,
        retriever_kwargs: dict | None = None,
        fault_plan: "FaultPlan | None" = None,
        device=None,
        params: dict | None = None,
        opt_state: dict | None = None,
        step_seeds: Callable[[int], int] | None = None,
        refresh_rows: Callable[[int], Any] | None = None,
    ):
        self.device = resolve_device(device)
        self.dataset = dataset
        p, l = dataset.item_embeddings.shape
        fopo_cfg = cfg.fopo
        if fopo_cfg.num_items == 0:
            fopo_cfg = dataclasses.replace(fopo_cfg, num_items=p)
        self.plan = None
        if cfg.estimator == "fopo":
            # the whole knob matrix, resolved once and validated here
            self.plan = ExecutionPlan.resolve(
                fopo_cfg, retriever_kwargs=retriever_kwargs or {}
            )
            fopo_cfg = self.plan.cfg
        elif cfg.estimator not in ("reinforce", "exact"):
            raise ValueError(f"unknown estimator {cfg.estimator!r}")
        if fopo_cfg is not cfg.fopo:
            cfg = dataclasses.replace(cfg, fopo=fopo_cfg)
        self.cfg = cfg
        # the grid (None on one device); the plan validated its type
        self.dist = fopo_cfg.dist
        if self.dist is not None:
            if cfg.estimator != "fopo":
                raise ValueError(f"dist= runs the fopo estimator only, not {cfg.estimator!r}")
            if cfg.batch_size % self.dist.n_data:
                raise ValueError(
                    f"batch {cfg.batch_size} must be a multiple of the data-axis "
                    f"size ({self.dist.n_data})"
                )
        self.policy = SoftmaxPolicy(tower=linear_tower_apply, item_dim=l)
        if params is None:
            params = linear_tower_init(torch.Generator().manual_seed(cfg.seed), l, l)
        self.params = tree_map(lambda t: t.to(self.device, torch.float32), params)
        beta = torch.as_tensor(dataset.item_embeddings, dtype=torch.float32)
        self.num_items = p
        self._shard = 0  # this rank's model coordinate (its slab under dist)
        if self.dist is not None:
            from repro_torch.dist.fopo import shard_rows

            beta = shard_rows(beta, self.dist)
            self._shard = self.dist.model_rank
        self._rows = beta.shape[0]
        self._id_base = self._shard * self._rows
        self.beta = beta.to(self.device)
        self.optimizer: Optimizer = adam(cfg.learning_rate)
        self.opt_state = (
            tree_map(lambda t: t.to(self.device), opt_state)
            if opt_state is not None else self.optimizer.init(self.params)
        )
        self.step = 0
        self.loader = BatchLoader(
            {"contexts": dataset.contexts, "positives": dataset.positives},
            cfg.batch_size,
            seed=cfg.seed,
        )
        self._seed_gen = torch.Generator().manual_seed(cfg.seed + 17)
        self._step_seeds = step_seeds
        # the maintained index (cfg.fopo.index_refresh): the plan built the
        # initial RefreshState from the caller's index; the trainer owns it
        state = self.plan.initial_index_state if self.plan is not None else None
        self.index_state = (
            RefreshState(*(t.to(self.device) for t in state)) if state is not None else None
        )
        self._refresh_fns = self._build_refresh() if state is not None else None
        # one generator a shard: data replicas of a shard draw the same rows
        self._refresh_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 31 + self._shard
        )
        self._refresh_rows = refresh_rows
        # the health layer (all None / zero when cfg.health is None)
        self.fault_plan = fault_plan
        self.guard_state = None
        self._snapshot: dict | None = None
        self._restarts = 0  # rollbacks taken (they reseed the step seeds)
        self._degraded = False  # the ladder's last rung taken
        self._monitor = None
        if cfg.health is not None:
            self.guard_state = init_guard_state(self.device)
            if cfg.health.index is not None:
                from repro_torch.health.index_health import IndexHealthMonitor

                self._monitor = IndexHealthMonitor(cfg.health.index)

    # ------------------------------------------------------------------
    def _next_seed(self) -> int:
        if self._step_seeds is not None:
            return int(self._step_seeds(self.step))
        return int(torch.randint(0, INT32_MAX, (), generator=self._seed_gen))

    def _loss(self, params, seed: int, contexts, positives, eps):
        cfg = self.cfg
        reward_fn = make_session_reward(positives)
        if cfg.estimator == "fopo":
            return fopo_loss(
                self.policy, params, seed, contexts, self.beta, reward_fn, cfg.fopo,
                epsilon=eps if cfg.adaptive_eps else None, plan=self.plan,
                index_state=self.index_state,
            )
        if cfg.estimator == "reinforce":
            gen = torch.Generator(device=self.device).manual_seed(seed)
            loss = reinforce_loss(
                self.policy, params, gen, contexts, self.beta, reward_fn,
                cfg.fopo.num_samples,
            )
            return loss, {}
        # exact: the dense [B, P] reward matrix 1[a in Y]
        b, p = contexts.shape[0], self.beta.shape[0]
        dense = torch.zeros((b, p), device=self.device)
        rows = torch.arange(b, device=self.device)[:, None].expand_as(positives)
        live = positives >= 0
        dense[rows[live], positives[live].long()] = 1.0
        return exact_objective(self.policy, params, contexts, self.beta, dense), {}

    def train_step(
        self, seed: int, contexts, positives, eps, fault: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, dict, torch.Tensor | None]:
        """One step: loss and gradient, the fault injection (``fault``,
        a `FaultPlan.signals` vector on the device), the grad norm into
        aux["grad_norm"], optional clipping, the optimizer update, and
        with ``health`` the verdict and the select. Launches only:
        nothing here waits for the device. Returns (loss, aux, verdict
        or None)."""
        cfg = self.cfg
        params = tree_map(lambda t: t.detach().requires_grad_(True), self.params)
        loss, aux = self._loss(params, seed, contexts, positives, eps)
        leaves = tree_leaves(params)
        grad_leaves = torch.autograd.grad(loss, leaves)
        it = iter(grad_leaves)
        grads = tree_map(lambda _: next(it), params)
        if self.dist is not None:
            # the data-sharded batch reduction: each rank's gradient covers
            # its own rows of the -(1/B) sum
            from repro_torch.dist.collectives import all_reduce

            grads = tree_map(
                lambda g: all_reduce(g, group=self.dist.data_group, name="grad_theta"), grads
            )
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        if fault is not None:
            from repro_torch.health.faults import inject_aux, inject_grads

            grads = inject_grads(grads, fault)
            aux = inject_aux(aux, fault)
        gnorm = grad_global_norm(grads)
        aux = dict(aux, grad_norm=gnorm)

        def do_update(p, o):
            g = grads
            if cfg.grad_clip > 0:
                g = clip_by_global_norm(g, cfg.grad_clip)
            return self.optimizer.update(g, o, p)

        params = tree_map(lambda t: t.detach(), params)
        verdict = None
        with torch.no_grad():
            if self.guard_state is None:
                self.params, self.opt_state = do_update(params, self.opt_state)
            else:
                self.params, self.opt_state, self.guard_state, verdict = guarded_update(
                    cfg.health, self.guard_state, loss, gnorm, aux, params,
                    self.opt_state, do_update, dist=self.dist,
                )
        return loss, aux, verdict

    # ------------------------------------------------------------------
    # index maintenance (repro_torch.mips.refresh)
    # ------------------------------------------------------------------
    def _build_refresh(self) -> dict:
        """The maintenance ops with the schedule's knobs bound; under dist
        the per-shard ops of this rank's shard (its slab's id base)."""
        rc = self.plan.refresh
        health = self.cfg.health
        iters = (
            health.index.rebuild_iters
            if health is not None and health.index is not None else 4
        )
        base = self._id_base
        return {
            "refresh": partial(
                refresh_ops.refresh_step, minibatch=rc.minibatch,
                count_decay=rc.count_decay,
            ),
            "append": partial(refresh_ops.delta_append, id_base=base),
            "compact": partial(refresh_ops.compact, id_base=base),
            "rebuild": partial(refresh_ops.rebuild, iters=iters, id_base=base),
        }

    def update_items(self, ids, embs) -> None:
        """Catalog churn: overwrite beta rows `ids` with `embs` and (when
        maintaining an index) delta-append them, so the very next
        retrieval serves the fresh embeddings. Pad with id -1 rows to
        keep a batch shape; they are dropped. Beta is replaced, not
        written in place: a snapshot holding the old one stays valid.
        Under dist the ids are global: each rank writes (and appends) the
        rows of its own slab."""
        from repro_torch.dist.collectives import rebase_ids

        ids = torch.as_tensor(ids).to(self.device, torch.int32)
        embs = torch.as_tensor(embs).to(self.device, self.beta.dtype)
        rows = self._rows
        local, _ = rebase_ids(ids, rows, self._shard)
        # pad rows land on a spare row past the end, then cut off (never
        # -1, which wraps, nor a clamped 0, which would race a real write)
        ext = torch.cat([self.beta, self.beta[:1]])
        ext[torch.where(local >= 0, local.long(), rows)] = embs
        self.beta = ext[:rows]
        if self._refresh_fns is not None and not self._degraded:
            self.index_state = self._refresh_fns["append"](self.index_state, local, embs)

    def _maybe_refresh_index(self) -> None:
        """Launch this step's scheduled maintenance without waiting: the
        step in flight never waits for it, and the next step reads the
        new state in stream order. A degraded trainer (exact fallback)
        skips maintenance: the index is out of the path."""
        if self._degraded:
            return
        rc = self.plan.refresh
        done = self.step + 1  # steps completed incl. the one in flight
        if rc.every and done % rc.every == 0:
            rows = None
            if self._refresh_rows is not None:
                rows = torch.as_tensor(np.asarray(self._refresh_rows(self.step)))
                if self.dist is not None:  # [n_model, minibatch]: this shard's row
                    rows = rows[self.dist.model_rank]
            self.index_state = self._refresh_fns["refresh"](
                self.index_state, self._refresh_gen, self.beta, rows=rows
            )
        if rc.compact_every and done % rc.compact_every == 0:
            self.index_state = self._refresh_fns["compact"](self.index_state, self.beta)

    # ------------------------------------------------------------------
    # the retrieval degradation ladder (repro_torch.health.index_health)
    # ------------------------------------------------------------------
    def _maybe_probe_index(self, bus) -> None:
        """Feed the ladder monitor and execute its escalations, at the
        probe cadence. The recall probe and the overflow counter are read
        on the host, which is why probing is periodic."""
        monitor = self._monitor
        if monitor is None or self._degraded or self.index_state is None:
            return
        ih = monitor.cfg
        cadence = ih.probe_every if ih.probe_every else 1
        if self.step % cadence != 0:
            return
        recall = None
        if ih.probe_every:
            from repro_torch.mips.ivf import DEFAULT_N_PROBE

            rows = min(ih.probe_rows, len(self.dataset.contexts))
            contexts = torch.from_numpy(np.asarray(self.dataset.contexts[:rows]))
            with torch.no_grad():
                queries = self.policy.user_embedding(self.params, contexts.to(self.device))
            recall = refresh_ops.sampled_recall(
                self.index_state, self.beta, queries, ih.probe_k,
                n_probe=ih.n_probe or DEFAULT_N_PROBE, dist=self.dist,
            )
        overflow = self.index_state.overflow
        if self.dist is not None:  # the worst shard's
            from repro_torch.dist.collectives import all_reduce

            overflow = all_reduce(overflow, op=torch.distributed.ReduceOp.MAX,
                                  group=self.dist.model_group, name="overflow")
        overflow = int(overflow)
        action = monitor.observe(recall, overflow)
        if recall is not None or action:
            bus.event(
                "index_health",
                {"step": self.step, "recall": recall, "overflow": overflow,
                 "action": action},
                step=self.step,
            )
        if action in ("compact", "rebuild"):
            with span(f"index_{action}", step=self.step):
                self.index_state = self._refresh_fns[action](self.index_state, self.beta)
        elif action == "fallback":
            self._degrade()

    def _degrade(self) -> None:
        """The ladder's last rung: swap the plan's retriever for its
        pre-resolved exact fallback (the index state still rides,
        unused)."""
        if self._degraded or self.plan is None:
            return
        self.plan = self.plan.degrade_to_fallback()
        self._degraded = True

    # ------------------------------------------------------------------
    # snapshot / rollback (the guard's escalation path)
    # ------------------------------------------------------------------
    def _take_snapshot(self) -> None:
        """In-memory last-good state: tensor REFERENCES (no op writes
        them in place) and copies of the generators' states."""
        self._snapshot = {
            "step": self.step,
            "state": self._ckpt_state(),
            "loader": self.loader.state.to_dict(),
        }

    def _rollback(self) -> None:
        """max_consecutive_bad reached: restore the last good snapshot
        and reseed the step seeds (replaying the same seeds would replay
        a data-dependent bad step): the snapshot's generator state, then
        a draw of it mixed with the restart count."""
        self._restarts += 1
        snap = self._snapshot
        if snap is not None:
            st = snap["state"]
            self.params = st["params"]
            self.opt_state = st["opt_state"]
            self._seed_gen.set_state(st["seed_gen"])
            self._refresh_gen.set_state(st["refresh_gen"])
            if "index_state" in st:
                self.index_state = st["index_state"]
            self.step = snap["step"]
            self.loader.state = self.loader.state.from_dict(snap["loader"])
        base = int(torch.randint(0, INT32_MAX, (), generator=self._seed_gen))
        self._seed_gen.manual_seed(base * 1_000_003 + self._restarts)
        self.guard_state = init_guard_state(self.device)

    # ------------------------------------------------------------------
    def _ckpt_state(self) -> dict:
        """Everything a resume needs, as one tree: params, opt state, the
        maintained index (its overflow counter too), the guard state and
        both generators' states, so a restart resumes the exact
        trajectory."""
        state: dict[str, Any] = {
            "params": self.params,
            "opt_state": self.opt_state,
            "seed_gen": self._seed_gen.get_state(),
            "refresh_gen": self._refresh_gen.get_state(),
        }
        if self.index_state is not None:
            state["index_state"] = self.index_state
        if self.guard_state is not None:
            state["guard_state"] = self.guard_state
        return state

    def _adopt_state(self, state: dict) -> None:
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self._seed_gen.set_state(state["seed_gen"])
        self._refresh_gen.set_state(state["refresh_gen"])
        if "index_state" in state:
            self.index_state = state["index_state"]
        if "guard_state" in state:
            self.guard_state = state["guard_state"]

    def _ckpt_dir(self) -> str | None:
        """``checkpoint_dir``, or under dist this rank's directory in it."""
        d = self.cfg.checkpoint_dir
        if d and self.dist is not None:
            return os.path.join(d, f"rank_{torch.distributed.get_rank():05d}")
        return d

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint in ``checkpoint_dir`` (a
        corrupt latest one falls back to the one before). Returns whether
        one was restored."""
        directory = self._ckpt_dir()
        if not directory:
            return False
        if ckpt.latest_checkpoint(directory) is None:
            return False
        with span("checkpoint_restore", step=self.step):
            step, state, extra = ckpt.restore_checkpoint(
                directory, self._ckpt_state(), fallback=True
            )
        self._adopt_state(state)
        self.step = step
        if "loader" in extra:
            self.loader.state = self.loader.state.from_dict(extra["loader"])
        self._restarts = int(extra.get("restarts", 0))
        if extra.get("degraded"):
            self._degrade()
        return True

    def save(self) -> None:
        cfg = self.cfg
        directory = self._ckpt_dir()
        if not directory:
            return
        health = cfg.health
        with span("checkpoint_save", step=self.step):
            ckpt.save_checkpoint(
                directory,
                self.step,
                self._ckpt_state(),
                extra={
                    "loader": self.loader.state.to_dict(),
                    "restarts": self._restarts,
                    "degraded": self._degraded,
                },
                keep=cfg.keep_checkpoints,
                retries=health.save_retries if health is not None else 0,
                backoff=health.save_backoff if health is not None else 0.05,
            )

    # ------------------------------------------------------------------
    def train(self, num_steps: int | None = None, log_every: int = 0) -> dict:
        cfg = self.cfg
        health = cfg.health
        n = num_steps if num_steps is not None else cfg.num_steps
        if health is not None and self._snapshot is None:
            self._take_snapshot()  # the step-0 rollback target
        t_total = time.perf_counter()
        with ObsRun(cfg.obs, predicted_step_s=self._predicted_step_s()) as run:
            bus = run.bus
            if self._monitor is not None:
                self._monitor.bind_bus(bus)
            for _ in range(n):
                if self.fault_plan is not None:
                    self.fault_plan.maybe_kill(self.step)
                with span("load", step=self.step):
                    batch = self.loader.next_batch()
                    seed = self._next_seed()
                    eps = (
                        adaptive_epsilon(self.step, cfg.num_steps).to(self.device)
                        if cfg.adaptive_eps else 0.0
                    )
                    fault = None
                    if self.fault_plan is not None:
                        fault = torch.from_numpy(self.fault_plan.signals(self.step)).to(
                            self.device
                        )
                    contexts = torch.from_numpy(batch["contexts"])
                    positives = torch.from_numpy(batch["positives"])
                    if self.dist is not None:  # this rank's rows of the global batch
                        from repro_torch.dist.fopo import data_rows

                        contexts = data_rows(contexts, self.dist)
                        positives = data_rows(positives, self.dist)
                    with span("h2d"):
                        contexts = contexts.to(self.device)
                        positives = positives.to(self.device)
                t0 = time.perf_counter()
                with span("dispatch", step=self.step):
                    loss, aux, verdict = self.train_step(seed, contexts, positives, eps, fault)
                # device scalars go on the bus as they are; they are read at
                # drain(), after the wait below
                bus.gauge("loss", loss, step=self.step)
                for k in DIAGNOSTIC_KEYS:
                    if k in aux:
                        bus.gauge(k, aux[k], step=self.step)
                if self._refresh_fns is not None:
                    # launched while the step above is in flight
                    with span("index_refresh", step=self.step):
                        self._maybe_refresh_index()
                with span("drain", step=self.step):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                run.observe_step_time(time.perf_counter() - t0, self.step)
                self.step += 1
                # the verdict is read HERE, after the wait above
                v = int(verdict) if verdict is not None else 0
                if v:
                    bus.event("health", verdict_record(self.step, v), step=self.step)
                    if int(self.guard_state.consecutive_bad) >= health.max_consecutive_bad:
                        rolled_to = self._snapshot["step"] if self._snapshot else self.step
                        self._rollback()
                        bus.event(
                            "events",
                            {"step": self.step, "event": "rollback", "to": rolled_to,
                             "restarts": self._restarts},
                            step=self.step,
                        )
                        if log_every:
                            bus.log(format_rollback_line(self.step, rolled_to, self._restarts))
                        bus.drain()
                        continue
                elif health is not None and self.step % health.snapshot_every == 0:
                    self._take_snapshot()
                with span("index_probe", step=self.step):
                    self._maybe_probe_index(bus)
                if cfg.checkpoint_every and self.step % cfg.checkpoint_every == 0:
                    self.save()
                if cfg.eval_every and self.step % cfg.eval_every == 0:
                    with span("eval", step=self.step):
                        bus.event(
                            "reward", {"step": self.step, "value": self.evaluate()},
                            step=self.step,
                        )
                if log_every and self.step % log_every == 0:
                    bus.log(format_train_line(
                        self.step, float(loss),
                        {k: float(aux[k]) for k in DIAGNOSTIC_KEYS if k in aux},
                        decode_verdict(v) if v else (),
                        self._degraded,
                    ))
                bus.drain()  # after the wait: device scalars -> host floats
            history = run.history()
        history["total_time"] = time.perf_counter() - t_total
        return validate_history(history)

    def _predicted_step_s(self) -> float | None:
        """The byte model's step time, the drift monitor's denominator;
        None (the monitor stays off) when the estimator has no resolved
        plan or the obs config does not arm drift."""
        obs = self.cfg.obs
        if obs is None or obs.drift is None or self.plan is None:
            return None
        return predict_step_seconds(self.plan, self.cfg.batch_size, self.beta.shape[1])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, dataset: SessionDataset | None = None, max_rows: int = 4096) -> float:
        """R_test: the fraction of argmax recommendations that hit Y (the
        paper's test metric), the argmax served by exact MIPS."""
        ds = dataset or self.dataset
        n = min(len(ds.contexts), max_rows)
        contexts = torch.from_numpy(np.asarray(ds.contexts[:n])).to(self.device)
        h = self.policy.user_embedding(self.params, contexts)
        if self.dist is None:
            top1 = topk_exact(h, self.beta, 1)
        else:  # the slabs' top-1 merged over the model group
            from repro_torch.mips.sharded import sharded_topk

            top1 = sharded_topk(h, self.beta, 1, self.dist.model_group,
                                num_valid=self.num_items)
        top1 = top1.indices[:, 0].cpu().numpy()
        hits = (top1[:, None] == ds.positives[:n]).any(axis=1)
        return float(hits.mean())
