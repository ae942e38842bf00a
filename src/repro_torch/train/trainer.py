"""The FOPO training driver, Algorithm 1 end to end, on one device.

Wires together: the data loader, the linear policy and the fixed beta
(Assumption 1), the resolved `ExecutionPlan` (retriever, sampler,
surrogate), the optimizer and the run's telemetry. The same driver runs
the REINFORCE baseline (`estimator="reinforce"`) and the dense exact
gradient (`estimator="exact"`), as the reference's does.

Per-step randomness: the reference splits a JAX key per step and folds
it to the sampler's int32 seed. The port draws each step's int32 seed
from a CPU `torch.Generator` seeded from ``cfg.seed + 17``, unless a
callable ``step -> int32 seed`` is injected (``step_seeds=``): the
parity tests inject the reference's seeds. A step reads no device value
on the host; its loss is read after the step, as the reference's is.

Not ported yet, and refused with NotImplementedError naming their
slice: ``health`` and ``fault_plan`` (health), ``obs`` (observability),
``checkpoint_dir`` (health, with snapshots and rollback),
``fopo.index_refresh`` (IVF maintenance) and ``fopo.dist`` (dist).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

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
from repro_torch.health.guard import grad_global_norm
from repro_torch.kernels.fused_sampler.ops import INT32_MAX
from repro_torch.mips.exact import topk_exact
from repro_torch.obs.run import ObsRun
from repro_torch.obs.schema import validate_history
from repro_torch.obs.sinks import format_train_line
from repro_torch.obs.trace import span
from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)

__all__ = ["FOPOTrainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    """The reference's fields and defaults, less the checkpoint cadence
    (`checkpoint_dir` is refused until the health slice)."""

    estimator: str = "fopo"  # fopo | reinforce | exact
    fopo: FOPOConfig = dataclasses.field(default_factory=lambda: FOPOConfig(num_items=0))
    batch_size: int = 32
    learning_rate: float = 1e-4
    num_steps: int = 1000
    grad_clip: float = 0.0
    adaptive_eps: bool = False  # beyond-paper: schedule eps 1.0 -> 0.1
    checkpoint_dir: str | None = None  # refused: the health slice
    eval_every: int = 0
    seed: int = 0
    health: Any = None  # refused: the health slice
    obs: Any = None  # refused: the observability slice


_NOT_PORTED = (
    ("health", "the health slice"),
    ("obs", "the observability slice"),
    ("checkpoint_dir", "the health slice (checkpoints, snapshots and rollback)"),
)


def _refuse_later_slices(cfg: TrainerConfig, fault_plan) -> None:
    for field, slice_name in _NOT_PORTED:
        if getattr(cfg, field) is not None:
            raise NotImplementedError(
                f"TrainerConfig.{field} is not ported to repro_torch yet; it "
                f"comes with {slice_name}"
            )
    if fault_plan is not None:
        raise NotImplementedError(
            "fault_plan is not ported to repro_torch yet; it comes with the "
            "health slice"
        )
    if cfg.fopo.index_refresh is not None:
        raise NotImplementedError(
            "FOPOConfig.index_refresh in training is not ported yet: the "
            "maintained index comes with the IVF maintenance slice"
        )
    if cfg.fopo.dist is not None:
        raise NotImplementedError(
            "FOPOConfig.dist is not ported yet: the multi-device route comes "
            "with the dist slice"
        )


class FOPOTrainer:
    """``device`` defaults to "cuda" and raises without CUDA. ``params``
    and ``opt_state`` start the run from given values (the parity tests
    pass the reference's, carried across by `repro_torch.convert`);
    ``step_seeds`` maps a step number to its int32 seed."""

    def __init__(
        self,
        cfg: TrainerConfig,
        dataset: SessionDataset,
        *,
        retriever_kwargs: dict | None = None,
        fault_plan=None,
        device=None,
        params: dict | None = None,
        opt_state: dict | None = None,
        step_seeds: Callable[[int], int] | None = None,
    ):
        _refuse_later_slices(cfg, fault_plan)
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
        self.policy = SoftmaxPolicy(tower=linear_tower_apply, item_dim=l)
        if params is None:
            params = linear_tower_init(torch.Generator().manual_seed(cfg.seed), l, l)
        self.params = tree_map(lambda t: t.to(self.device, torch.float32), params)
        self.beta = torch.as_tensor(dataset.item_embeddings, dtype=torch.float32).to(
            self.device
        )
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

    def train_step(self, seed: int, contexts, positives, eps) -> tuple[torch.Tensor, dict]:
        """One step: loss and gradient, grad norm into aux["grad_norm"],
        optional clipping, the optimizer update. Launches only: nothing
        here waits for the device."""
        cfg = self.cfg
        params = tree_map(lambda t: t.detach().requires_grad_(True), self.params)
        loss, aux = self._loss(params, seed, contexts, positives, eps)
        leaves = tree_leaves(params)
        grad_leaves = torch.autograd.grad(loss, leaves)
        it = iter(grad_leaves)
        grads = tree_map(lambda _: next(it), params)
        aux = dict(aux, grad_norm=grad_global_norm(grads))
        if cfg.grad_clip > 0:
            grads = clip_by_global_norm(grads, cfg.grad_clip)
        with torch.no_grad():
            new_params, self.opt_state = self.optimizer.update(
                grads, self.opt_state, tree_map(lambda t: t.detach(), params)
            )
        self.params = new_params
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    # ------------------------------------------------------------------
    def train(self, num_steps: int | None = None, log_every: int = 0) -> dict:
        cfg = self.cfg
        n = num_steps if num_steps is not None else cfg.num_steps
        t_total = time.perf_counter()
        with ObsRun(None) as run:
            bus = run.bus
            for _ in range(n):
                batch = self.loader.next_batch()
                seed = self._next_seed()
                eps = (
                    adaptive_epsilon(self.step, cfg.num_steps).to(self.device)
                    if cfg.adaptive_eps else 0.0
                )
                contexts = torch.from_numpy(batch["contexts"]).to(self.device)
                positives = torch.from_numpy(batch["positives"]).to(self.device)
                t0 = time.perf_counter()
                with span("dispatch", step=self.step):
                    loss, aux = self.train_step(seed, contexts, positives, eps)
                # device scalars go on the bus as they are; they are read at
                # drain(), after the wait below
                bus.gauge("loss", loss, step=self.step)
                for k in DIAGNOSTIC_KEYS:
                    if k in aux:
                        bus.gauge(k, aux[k], step=self.step)
                with span("drain", step=self.step):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                run.observe_step_time(time.perf_counter() - t0, self.step)
                self.step += 1
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
                    ))
                bus.drain()  # after the wait: device scalars -> host floats
            history = run.history()
        history["total_time"] = time.perf_counter() - t_total
        return validate_history(history)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, dataset: SessionDataset | None = None, max_rows: int = 4096) -> float:
        """R_test: the fraction of argmax recommendations that hit Y (the
        paper's test metric), the argmax served by exact MIPS."""
        ds = dataset or self.dataset
        n = min(len(ds.contexts), max_rows)
        contexts = torch.from_numpy(np.asarray(ds.contexts[:n])).to(self.device)
        h = self.policy.user_embedding(self.params, contexts)
        top1 = topk_exact(h, self.beta, 1).indices[:, 0].cpu().numpy()
        hits = (top1[:, None] == ds.positives[:n]).any(axis=1)
        return float(hits.mean())
