"""Request queue + micro-batch coalescing policy (the host half of the
serving engine — pure, clock-free, unit-testable without a model).

Requests arrive with timestamps; the engine launches a padded
micro-batch when either trigger fires:

  * the queue holds ``max_batch`` requests (batch-full), or
  * the oldest queued request has waited ``max_wait_s`` (latency cap).

`next_batch` is the whole policy as one pure function over (sorted
arrival times, engine-free time): it returns how many requests launch
and WHEN — which makes the continuous-batching dynamics (batches fill
while the engine is busy; a lull launches a short batch at the wait
cap) an exact computation instead of a property of a wall-clock race.
The engine runs this against a virtual event clock and measures only
the model's service time for real, so offered-QPS latency sweeps are
reproducible on a loaded CI box.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["CoalescePolicy", "Request", "next_batch", "pad_payloads"]


@dataclasses.dataclass(frozen=True)
class CoalescePolicy:
    """The two serving knobs every continuous-batching engine exposes.

    max_batch   padded micro-batch size — also the ONE batch shape the
                route runs (short batches pad up to it)
    max_wait_s  latency cap: the oldest request never waits longer than
                this for co-riders before launching
    """

    max_batch: int = 8
    max_wait_s: float = 0.002

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One enqueued request: opaque route payload + arrival time."""

    rid: int
    payload: Any
    arrival: float


def next_batch(
    arrivals: list[float], free_at: float, policy: CoalescePolicy
) -> tuple[int, float]:
    """Decide the next launch from the queue's sorted arrival times.

    Returns ``(size, launch)``: the first `size` queued requests launch
    at time `launch` (FIFO — the queue is arrival-ordered). The launch
    time is the earliest moment the engine is free AND a trigger has
    fired; every request already arrived by then joins, up to
    ``max_batch`` — this is exactly how batches fill while the engine
    is busy with the previous one.
    """
    if not arrivals:
        raise ValueError("next_batch on an empty queue")
    if any(a > b for a, b in zip(arrivals, arrivals[1:])):
        # every launch-time formula below indexes arrivals[0] as "the
        # oldest" — on an unsorted queue that silently computes a wrong
        # launch. The cluster dispatcher's re-queue path produces
        # out-of-order ready times; queue owners must re-insert in
        # sorted position (bisect), not append.
        raise ValueError(
            "next_batch needs non-decreasing arrivals (FIFO by arrival); "
            "re-queued requests must be re-inserted in sorted position, "
            "not appended"
        )
    t_full = (
        arrivals[policy.max_batch - 1]
        if len(arrivals) >= policy.max_batch
        else math.inf
    )
    t_wait = arrivals[0] + policy.max_wait_s
    launch = max(free_at, arrivals[0], min(t_full, t_wait))
    size = 0
    for t in arrivals:
        if t > launch or size == policy.max_batch:
            break
        size += 1
    return size, launch


def pad_payloads(payloads: list, max_batch: int, pad_payload) -> list:
    """Pad a short batch's payload list up to the fixed trace shape.
    Dead rows run the model (their results are discarded by the route's
    ``finalize``) — the price of ONE compiled batch shape."""
    if len(payloads) > max_batch:
        raise ValueError(f"{len(payloads)} payloads > max_batch={max_batch}")
    return payloads + [pad_payload] * (max_batch - len(payloads))
