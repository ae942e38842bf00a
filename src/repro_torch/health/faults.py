"""Deterministic fault injection for the robustness drills, and the
replica failure the serving engine understands.

A `FaultPlan` scripts faults at exact step numbers: NaN'd gradients,
grad spikes, ESS-collapse overrides, a simulated preemption kill, plus
host-side corruptors for checkpoints and index state. The in-step
injection points take a small f32 signal vector (`FaultPlan.signals`);
a clear plan is the all-clear signal ``[0, 1, -1]`` whose injection math
is the identity bit for bit (``g * 1.0``: multiplication keeps -0.0
sign bits, unlike ``g + 0.0``).

Faults fire ONCE by default: after the guard rolls the trainer back and
replays the same step numbers, a fired fault stays quiet, so recovery
re-converges instead of tripping forever on its own injection. The
reference's module (`repro/health/faults.py`), for one device, with the
serving cluster's scripted replica faults (`ReplicaDeath`,
`ReplicaFaultPlan`).
"""
from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_map

__all__ = [
    "CLEAR_SIGNALS",
    "FaultPlan",
    "KILL_EXIT_CODE",
    "ReplicaDeath",
    "ReplicaFailure",
    "ReplicaFaultPlan",
    "SimulatedPreemption",
    "corrupt_checkpoint",
    "corrupt_index_state",
    "inject_aux",
    "inject_grads",
    "torn_checkpoint_writes",
    "transient_save_failures",
]

KILL_EXIT_CODE = 71  # subprocess kill-and-resume tests key on this

# signal layout: [nan_flag, grad_scale, ess_override]
CLEAR_SIGNALS = np.asarray([0.0, 1.0, -1.0], dtype=np.float32)


class SimulatedPreemption(BaseException):
    """Raised between steps by `FaultPlan.maybe_kill` (soft mode).

    Deliberately a BaseException: a preemption must not be swallowed by
    `except Exception` recovery paths; only the harness catches it.
    """

    def __init__(self, step: int):
        super().__init__(f"simulated preemption at step {step}")
        self.step = step


@dataclasses.dataclass
class FaultPlan:
    """Scripted faults at exact global step numbers (0-based, matching
    `FOPOTrainer.step` at dispatch time).

    nan_grads_at     steps whose gradients are overwritten with NaN
    spike_grads_at   steps whose gradients are scaled by spike_factor
    ess_collapse_at  steps whose reported aux ESS is overridden with
                     ess_value
    kill_at          step BEFORE which the trainer dies: raises
                     SimulatedPreemption, or `os._exit(KILL_EXIT_CODE)`
                     when hard_kill=True
    once             each fault fires a single time, then disarms
    """

    nan_grads_at: tuple[int, ...] = ()
    spike_grads_at: tuple[int, ...] = ()
    spike_factor: float = 1e4
    ess_collapse_at: tuple[int, ...] = ()
    ess_value: float = 1.0
    kill_at: int | None = None
    hard_kill: bool = False
    once: bool = True

    def __post_init__(self):
        self._fired: set[tuple[str, int]] = set()

    def _arm(self, kind: str, step: int, schedule) -> bool:
        if step not in schedule:
            return False
        key = (kind, step)
        if self.once and key in self._fired:
            return False
        self._fired.add(key)
        return True

    def signals(self, step: int) -> np.ndarray:
        """The step's injection operand: f32[3] [nan_flag, grad_scale,
        ess_override]."""
        sig = CLEAR_SIGNALS.copy()
        if self._arm("nan", step, self.nan_grads_at):
            sig[0] = 1.0
        if self._arm("spike", step, self.spike_grads_at):
            sig[1] = self.spike_factor
        if self._arm("ess", step, self.ess_collapse_at):
            sig[2] = self.ess_value
        return sig

    def maybe_kill(self, step: int) -> None:
        """Host-side, called between steps. Dies before `kill_at` runs."""
        if self.kill_at is None or step != self.kill_at:
            return
        if not self._arm("kill", step, (self.kill_at,)):
            return
        if self.hard_kill:
            os._exit(KILL_EXIT_CODE)
        raise SimulatedPreemption(step)


def inject_grads(grads: Any, signals: torch.Tensor) -> Any:
    """Gradient injection on the device. With clear signals this is
    ``g * 1.0`` per leaf: the identity, bit for bit."""
    nan_flag, scale = signals[0], signals[1]

    def leaf(g):
        return torch.where(nan_flag > 0, torch.full_like(g, float("nan")), g * scale)

    return tree_map(leaf, grads)


def inject_aux(aux: dict, signals: torch.Tensor) -> dict:
    """Aux override on the device: ess_override >= 0 replaces aux['ess']."""
    if "ess" not in aux:
        return aux
    override = signals[2]
    out = dict(aux)
    out["ess"] = torch.where(override >= 0, override, aux["ess"])
    return out


class ReplicaFailure(RuntimeError):
    """A serving replica failed a dispatch. The ONLY exception class the
    serving engine converts into an abandoned batch (`DrainResult`
    .abandoned) instead of propagating — anything else is a bug and must
    surface. Raise it (or a subclass) from a route to model a replica
    that cannot answer."""


class ReplicaDeath(ReplicaFailure):
    """Hard replica death: every dispatch fails until a revive."""

    def __init__(self, replica: int, dispatch: int):
        super().__init__(f"replica {replica} dead (dispatch #{dispatch})")
        self.replica = replica
        self.dispatch = dispatch


@dataclasses.dataclass
class ReplicaFaultPlan:
    """Scripted replica-level faults for the serving cluster's chaos
    drills. All schedules count DETERMINISTIC per-replica events — a
    replica's own dispatch number (1-based, incremented per batch it is
    asked to serve, hedged backups included) or its own health-check
    tick — never wall time, so the same plan against the same request
    stream replays the same fault sequence bit for bit.

    die             ((replica, dispatch_no), ...): hard death — that
                    dispatch and every later one raises `ReplicaDeath`
                    until a revive fires (each entry fires once, so a
                    revived replica stays up)
    slow_from       ((replica, dispatch_no, extra_s), ...): latency
                    injection — every dispatch >= dispatch_no adds
                    extra_s VIRTUAL seconds to the batch's service time
                    (what drives timeout/hedge decisions)
    flaky_probe_at  ((replica, check_no), ...): the replica's check_no-th
                    health probe lies "dead" while the replica is fine —
                    the dispatcher's max_failures threshold is what
                    keeps one lie from killing a healthy replica
    revive_at       ((replica, check_no), ...): a dead replica respawns
                    at its check_no-th health check; the dispatcher
                    still demands a passing warm-up probe before routing
                    traffic back
    """

    die: tuple = ()
    slow_from: tuple = ()
    flaky_probe_at: tuple = ()
    revive_at: tuple = ()

    def __post_init__(self):
        self._dead: set[int] = set()
        self._fired: set[int] = set()

    def dispatch_fault(self, replica: int, dispatch_no: int):
        """Consulted once per dispatch: "die", extra virtual seconds
        (float > 0), or None (clean)."""
        if replica not in self._dead:
            for i, (r, d) in enumerate(self.die):
                if r == replica and dispatch_no >= d and i not in self._fired:
                    self._fired.add(i)
                    self._dead.add(replica)
                    break
        if replica in self._dead:
            return "die"
        extra = sum(
            s for r, d, s in self.slow_from if r == replica and dispatch_no >= d
        )
        return extra or None

    def probe_alive(self, replica: int, check_no: int) -> bool:
        """The liveness bit the dispatcher's health check reads (may
        lie). Processing a scheduled revive happens here — the health
        check IS the respawned replica's warm-up probe."""
        if any(r == replica and check_no >= c for r, c in self.revive_at):
            self._dead.discard(replica)
        if replica in self._dead:
            return False
        return not any(
            r == replica and c == check_no for r, c in self.flaky_probe_at
        )


def corrupt_checkpoint(directory: str, step: int, mode: str = "truncate") -> str:
    """Host-side corruption of a written checkpoint's array file.

    mode='truncate' chops the npz mid-file (a torn write that slipped
    past the atomic rename); mode='bitflip' flips bytes inside the
    archive so the manifest checksums catch it. Returns the mangled
    path."""
    from repro_torch.train import checkpoint as ckpt

    path = os.path.join(directory, f"step_{step:010d}", ckpt.ARRAYS)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if mode == "truncate":
        data = data[: max(1, len(data) // 2)]
    elif mode == "bitflip":
        for pos in range(len(data) // 2, min(len(data), len(data) // 2 + 64)):
            data[pos] ^= 0xFF
    else:
        raise ValueError(f"unknown corruption mode: {mode!r}")
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


def corrupt_index_state(state, generator: torch.Generator) -> Any:
    """Scramble a RefreshState's list embeddings with standard normal
    noise drawn from ``generator`` (on the state's device): the centroid
    assignments no longer match the stored vectors, so sampled recall
    collapses while every value stays finite, which the ladder's probe
    must catch and `compact` / `rebuild` must heal."""
    embs = state.list_embs
    noise = torch.randn(
        embs.shape, generator=generator, dtype=embs.dtype, device=embs.device
    )
    return state._replace(list_embs=noise)


@contextmanager
def transient_save_failures(n: int):
    """Make the next `n` checkpoint save attempts raise OSError before
    the atomic rename (exercises save retry-with-backoff)."""
    from repro_torch.train import checkpoint as ckpt

    remaining = [n]

    def fault(tmp_dir: str, attempt: int) -> None:
        if remaining[0] > 0:
            remaining[0] -= 1
            raise OSError(f"injected transient save failure ({remaining[0]} left)")

    ckpt.set_write_fault(fault)
    try:
        yield remaining
    finally:
        ckpt.set_write_fault(None)


@contextmanager
def torn_checkpoint_writes():
    """Make every checkpoint save truncate its array file mid-write and
    then die before the rename (the torn write). The atomic tmp-dir
    protocol must leave no `step_*` dir behind."""
    from repro_torch.train import checkpoint as ckpt

    def fault(tmp_dir: str, attempt: int) -> None:
        path = os.path.join(tmp_dir, ckpt.ARRAYS)
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
            with open(path, "wb") as f:
                f.write(data[: max(1, len(data) // 2)])
        raise OSError("injected torn write")

    ckpt.set_write_fault(fault)
    try:
        yield
    finally:
        ckpt.set_write_fault(None)
