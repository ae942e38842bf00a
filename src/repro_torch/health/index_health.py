"""Retrieval degradation ladder: watch the maintained IVF index, escalate.

The incremental index (`repro_torch.mips.refresh`) degrades in two
observable ways: the fixed-capacity delta lists overflow (appends
dropped, counted in `RefreshState.overflow`) and probe recall decays as
centroids drift from the catalog. `IndexHealthMonitor` watches both (the
overflow counter every observation and a periodic sampled recall probe,
`sampled_recall`: `refresh_query` against `topk_exact` on a held probe
set) and escalates one rung per unhealthy observation:

    compact  ->  rebuild  ->  fallback
    (merge       (warm        (the plan's exact retriever:
     deltas)      Lloyd        correctness floor, no index)
                  + compact)

A healthy probe resets the ladder to the bottom; a cooldown between
escalations gives each rung's fix time to land before the next probe
judges it. The monitor only decides: the trainer or the serving engine
executes the action. Plain Python, the reference's
(`repro/health/index_health.py`), copied."""
from __future__ import annotations

import dataclasses

__all__ = ["IndexHealthConfig", "IndexHealthMonitor", "LADDER"]

LADDER = ("compact", "rebuild", "fallback")


@dataclasses.dataclass(frozen=True)
class IndexHealthConfig:
    """Knobs of the retrieval degradation ladder.

    probe_every      steps between sampled recall probes (0 disables
                     probing; overflow watching still runs)
    probe_rows       held-out query rows per probe
    probe_k          k of the recall@k probe
    recall_floor     probe recall below this is unhealthy
    n_probe          clusters probed per query (None -> the plan's)
    overflow_budget  NEW overflowed appends tolerated between
                     observations before the ladder escalates
                     (0 disables the overflow trigger)
    cooldown         observations swallowed after an escalation so the
                     fix can land before being judged
    rebuild_iters    Lloyd iterations of the `rebuild` rung
    """

    probe_every: int = 0
    probe_rows: int = 128
    probe_k: int = 64
    recall_floor: float = 0.7
    n_probe: int | None = None
    overflow_budget: int = 0
    cooldown: int = 1
    rebuild_iters: int = 4

    def __post_init__(self):
        if self.probe_every < 0:
            raise ValueError(f"probe_every must be >= 0, got {self.probe_every}")
        if self.probe_rows < 1:
            raise ValueError(f"probe_rows must be >= 1, got {self.probe_rows}")
        if self.probe_k < 1:
            raise ValueError(f"probe_k must be >= 1, got {self.probe_k}")
        # 1.01 is deliberately representable: an impossible floor forces
        # every probe unhealthy, walking the full ladder deterministically
        # (the fault-injection suite leans on this)
        if not 0.0 <= self.recall_floor <= 1.01:
            raise ValueError(
                f"recall_floor must lie in [0, 1.01], got {self.recall_floor}"
            )
        if self.overflow_budget < 0:
            raise ValueError(
                f"overflow_budget must be >= 0, got {self.overflow_budget}"
            )
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")
        if self.rebuild_iters < 1:
            raise ValueError(f"rebuild_iters must be >= 1, got {self.rebuild_iters}")


class IndexHealthMonitor:
    """Pure decision logic of the ladder (host-side, cheap, unit-testable
    without an index). Feed it observations; it answers with the next
    rung's action or None."""

    def __init__(self, cfg: IndexHealthConfig, bus=None):
        self.cfg = cfg
        self.level = 0  # rungs already taken since the last healthy probe
        self.last_overflow = 0  # overflow counter at the last observation
        self._cooldown = 0  # observations still swallowed post-escalation
        self.history: list[dict] = []  # every observation, for history["health"]
        self.bus = bus  # optional repro_torch.obs MetricsBus (see bind_bus)

    def bind_bus(self, bus) -> None:
        """Attach a metrics bus (repro_torch.obs.bus.MetricsBus): every observation
        then also lands as probe-recall/overflow gauges and escalations
        as a counter, alongside the trainer's index_health events. The
        monitor stays fully functional without one."""
        self.bus = bus

    @property
    def exhausted(self) -> bool:
        """All rungs taken — the trainer is (or should be) on fallback."""
        return self.level >= len(LADDER)

    def observe(self, recall: float | None, overflow: int) -> str | None:
        """One observation: probe recall (None when this step didn't
        probe) + the current cumulative overflow counter. Returns the
        ladder action to take now, or None."""
        cfg = self.cfg
        grew = overflow - self.last_overflow
        self.last_overflow = overflow
        overflowed = cfg.overflow_budget > 0 and grew > cfg.overflow_budget
        low_recall = recall is not None and recall < cfg.recall_floor
        unhealthy = overflowed or low_recall
        event = {
            "recall": recall,
            "overflow": overflow,
            "overflow_delta": grew,
            "unhealthy": unhealthy,
            "action": None,
        }
        self.history.append(event)
        if self.bus is not None:
            if recall is not None:
                self.bus.gauge("index_probe_recall", recall)
            self.bus.gauge("index_overflow_delta", grew)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if not unhealthy:
            # a clean probe (not a probe-less overflow-only tick) proves
            # the last rung healed the index — reset the ladder
            if recall is not None and self.level and self.level < len(LADDER):
                self.level = 0
            return None
        if self.exhausted:
            return None
        action = LADDER[self.level]
        self.level += 1
        self._cooldown = cfg.cooldown
        event["action"] = action
        if self.bus is not None:
            self.bus.counter("index_ladder_escalations", action=action)
        return action

    def note_compaction(self, overflow_after: int) -> None:
        """The trainer compacted (scheduled or forced) — compaction
        resets the overflow counter, so re-base the delta watch."""
        self.last_overflow = overflow_after
