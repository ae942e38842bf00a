"""Health verdicts and skip-step recovery for the train step, on the device.

The guarded step closes the detect -> decide -> recover loop without a
host read: the verdict (a bitmask of NaN/Inf, grad-spike, ESS-floor and
weight-collapse checks over the loss, the gradient norm and the SNIS
diagnostics) and the recovery (keep the old parameters and optimizer
state on a bad step) are both device tensors. The trainer reads the
verdict after the step's result has been waited for anyway, and rolls
back to its snapshot once `max_consecutive_bad` bad steps pile up.

Bitwise no-op. The reference keys its update on a `lax.cond`, because
XLA could otherwise fuse the optimizer's arithmetic into the select and
contract it differently. Eager PyTorch has no such compiler: each op is
its own kernel launch, reading its inputs' stored values, so what an op
computes does not depend on which ops later read its output. The
guarded step runs exactly the unguarded step's ops on the same inputs
(the gradient norm is computed in both, for ``aux["grad_norm"]``; the
clip and the optimizer update are the same calls), and only then
selects per leaf, ``torch.where(ok, new, old)``, Adam's ``step``
included. `torch.where` copies the chosen operand's bits, so on a step
no check rejects the guarded trainer holds the very bits of the
unguarded one, provided the step itself is repeatable: two unguarded
runs from the same seeds agree bitwise. The verdict only reads the
loss, the norm and the diagnostics, and writes nothing they feed. A
skipped step costs the update it discards and one select per leaf.

On the multi-device grid (``dist=``) the verdict is agreed by a MAX over
every rank before the select (`repro_torch.dist.fopo.dist_verdict_agree`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, NamedTuple

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map

if TYPE_CHECKING:
    from repro_torch.health.index_health import IndexHealthConfig

__all__ = [
    "ESS_COLLAPSE",
    "GRAD_SPIKE",
    "GuardState",
    "HealthConfig",
    "NONFINITE_GRADS",
    "NONFINITE_LOSS",
    "VERDICT_NAMES",
    "WBAR_COLLAPSE",
    "decode_verdict",
    "grad_global_norm",
    "guarded_update",
    "health_verdict",
    "init_guard_state",
    "update_guard_state",
    "verdict_record",
]

# verdict bitmask — one bit per check, OR'd into an int32 scalar
NONFINITE_LOSS = 1 << 0  # loss is NaN/Inf
NONFINITE_GRADS = 1 << 1  # any grad leaf is NaN/Inf (via the global norm)
GRAD_SPIKE = 1 << 2  # grad norm > spike_factor x the EMA baseline
ESS_COLLAPSE = 1 << 3  # batch-mean SNIS ESS under the floor
WBAR_COLLAPSE = 1 << 4  # batch-mean max normalised weight near 1

VERDICT_NAMES = {
    NONFINITE_LOSS: "nonfinite_loss",
    NONFINITE_GRADS: "nonfinite_grads",
    GRAD_SPIKE: "grad_spike",
    ESS_COLLAPSE: "ess_collapse",
    WBAR_COLLAPSE: "wbar_collapse",
}


def decode_verdict(verdict: int) -> list[str]:
    """Host-side: the named checks a verdict bitmask fired (log lines)."""
    return [name for bit, name in VERDICT_NAMES.items() if verdict & bit]


def verdict_record(step: int, verdict: int) -> dict:
    """The history["health"] event payload for a fired verdict."""
    v = int(verdict)
    return {"step": int(step), "verdict": v, "checks": decode_verdict(v)}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the guarded train step (`repro_torch.train.FOPOTrainer`),
    the reference's fields, defaults and validation.

    NaN/Inf detection in the loss and gradients is always on; the other
    checks are opt-in via their thresholds:

    ess_floor            flag a step whose batch-mean SNIS effective
                         sample size falls below this. 0 disables.
    max_wbar_ceiling     flag a step whose batch-mean max normalised
                         SNIS weight exceeds this. 1.0 disables.
    grad_spike_factor    flag a step whose global grad norm exceeds
                         factor x an EMA baseline of past good steps.
                         0 disables; must be > 1 otherwise.
    ema_decay            decay of that grad-norm EMA (good steps only).
    warmup_steps         good steps folded into the EMA before the
                         spike check arms.
    max_consecutive_bad  bad steps in a row before the trainer rolls
                         back to its last good snapshot, reseeded.
    snapshot_every       cadence (in good steps) of the trainer's
                         in-memory snapshot (tensor references, no
                         copies).
    save_retries         transient checkpoint-save failures retried
                         with exponential backoff before raising.
    save_backoff         base backoff (seconds) between save retries.
    index                optional `IndexHealthConfig`: the retrieval
                         degradation ladder. None disables probing.
    """

    ess_floor: float = 0.0
    max_wbar_ceiling: float = 1.0
    grad_spike_factor: float = 0.0
    ema_decay: float = 0.99
    warmup_steps: int = 5
    max_consecutive_bad: int = 3
    snapshot_every: int = 10
    save_retries: int = 2
    save_backoff: float = 0.05
    index: "IndexHealthConfig | None" = None

    def __post_init__(self):
        if self.ess_floor < 0:
            raise ValueError(f"ess_floor must be >= 0, got {self.ess_floor}")
        if not 0.0 < self.max_wbar_ceiling <= 1.0:
            raise ValueError(
                f"max_wbar_ceiling must lie in (0, 1], got {self.max_wbar_ceiling}"
            )
        if self.grad_spike_factor and self.grad_spike_factor <= 1.0:
            raise ValueError(
                "grad_spike_factor must be > 1 (or 0 to disable), got "
                f"{self.grad_spike_factor}"
            )
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must lie in (0, 1), got {self.ema_decay}")
        if self.max_consecutive_bad < 1:
            raise ValueError(
                f"max_consecutive_bad must be >= 1, got {self.max_consecutive_bad}"
            )
        if self.snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {self.snapshot_every}"
            )
        if self.save_retries < 0:
            raise ValueError(f"save_retries must be >= 0, got {self.save_retries}")


class GuardState(NamedTuple):
    """The guard's 0-dim device tensors; they ride the checkpoint."""

    grad_ema: torch.Tensor  # [] f32 EMA of the grad norm over GOOD steps
    good_steps: torch.Tensor  # [] i32 good steps folded into the EMA
    consecutive_bad: torch.Tensor  # [] i32 current bad-step run length
    bad_total: torch.Tensor  # [] i32 bad steps over the trainer lifetime
    last_verdict: torch.Tensor  # [] i32 bitmask of the latest step


def init_guard_state(device=None) -> GuardState:
    def z32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return GuardState(
        grad_ema=torch.zeros((), dtype=torch.float32, device=device),
        good_steps=z32(),
        consecutive_bad=z32(),
        bad_total=z32(),
        last_verdict=z32(),
    )


def grad_global_norm(grads: Any) -> torch.Tensor:
    """Global L2 norm over a nested dict of gradients (fp32 accumulate).
    A NaN / Inf in any leaf surfaces as a non-finite norm."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(torch.int32)


def health_verdict(
    cfg: HealthConfig,
    loss: torch.Tensor,
    gnorm: torch.Tensor,
    aux: dict,
    state: GuardState,
) -> torch.Tensor:
    """The verdict, a [] int32 bitmask on the device.

    Which checks exist follows from cfg and the aux keys; whether they
    fire is data. ``gnorm`` is the global grad norm
    (`grad_global_norm`), computed by the caller. The SNIS checks key on
    the `snis_diagnostics` contract (``ess`` / ``max_wbar``) and are
    absent for estimators that do not report them."""
    bits = _bit(~torch.isfinite(loss), NONFINITE_LOSS)
    bits = bits | _bit(~torch.isfinite(gnorm), NONFINITE_GRADS)
    if cfg.grad_spike_factor > 0:
        armed = state.good_steps >= cfg.warmup_steps
        spike = armed & torch.isfinite(gnorm) & (
            gnorm > cfg.grad_spike_factor * state.grad_ema
        )
        bits = bits | _bit(spike, GRAD_SPIKE)
    if cfg.ess_floor > 0 and "ess" in aux:
        bits = bits | _bit(aux["ess"] < cfg.ess_floor, ESS_COLLAPSE)
    if cfg.max_wbar_ceiling < 1.0 and "max_wbar" in aux:
        bits = bits | _bit(aux["max_wbar"] > cfg.max_wbar_ceiling, WBAR_COLLAPSE)
    return bits


def update_guard_state(
    cfg: HealthConfig,
    state: GuardState,
    verdict: torch.Tensor,
    gnorm: torch.Tensor,
) -> GuardState:
    """Scalar guard bookkeeping: the grad-norm EMA folds in good steps
    only, and the bad-run counters drive the trainer's rollback."""
    ok = verdict == 0
    safe_g = torch.where(torch.isfinite(gnorm), gnorm, 0.0)
    warm = state.good_steps > 0
    ema = torch.where(
        ok,
        torch.where(
            warm,
            cfg.ema_decay * state.grad_ema + (1.0 - cfg.ema_decay) * safe_g,
            safe_g,
        ),
        state.grad_ema,
    ).to(torch.float32)
    ok32 = ok.to(torch.int32)
    return GuardState(
        grad_ema=ema,
        good_steps=state.good_steps + ok32,
        consecutive_bad=torch.where(ok, 0, state.consecutive_bad + 1).to(torch.int32),
        bad_total=state.bad_total + (1 - ok32),
        last_verdict=verdict.to(torch.int32),
    )


def guarded_update(
    cfg: HealthConfig,
    state: GuardState,
    loss: torch.Tensor,
    gnorm: torch.Tensor,
    aux: dict,
    params: Any,
    opt_state: Any,
    update_fn: Any,
    *,
    dist=None,
) -> tuple[Any, Any, GuardState, torch.Tensor]:
    """The verdict and the conditional update, as one call. Returns
    (params, opt_state, guard_state, verdict).

    ``update_fn(params, opt_state) -> (new_params, new_opt_state)`` is
    the optimizer apply (it may close over the gradients). It always
    runs; each leaf of its result is then selected against the old leaf
    on the device (see the module docstring on why that keeps the
    unguarded bits).

    With ``dist`` (a `repro_torch.dist.DistConfig`) the verdict is agreed
    over the grid first (`dist_verdict_agree`, a MAX): a bad step on any
    rank is skipped on every rank, so the replicated theta never parts."""
    verdict = health_verdict(cfg, loss, gnorm, aux, state)
    if dist is not None:
        from repro_torch.dist.fopo import DistConfig, dist_verdict_agree

        if not isinstance(dist, DistConfig):
            raise ValueError(f"dist must be a DistConfig (or None), got {type(dist).__name__}")
        verdict = dist_verdict_agree(verdict, dist)
    ok = verdict == 0
    new_params, new_opt = update_fn(params, opt_state)

    def select(new, old):
        return torch.where(ok, new, old)

    out_params = tree_map(select, new_params, params)
    out_opt = tree_map(select, new_opt, opt_state)
    return out_params, out_opt, update_guard_state(cfg, state, verdict, gnorm), verdict
