"""Multi-replica serving cluster: a dispatcher over N serving replicas.

One `Dispatcher` owns the global FIFO request stream and shards it over
N `Replica`s — each a `ServingEngine` around its own route instance
(its own served-index copy; a sharded catalog would slot in as a
different route, the dispatch layer does not care). Everything runs
on the SAME virtual event clock the single-replica engine introduced:
replica clocks (`free_at`) overlap virtually, so N-way parallelism is
an exact computation on one process — and with a fixed service model
the whole drill (routing, retries, hedges, deaths, timestamps) is
bitwise reproducible, so a chaos drill can be replayed and its event
trace diffed. The reference's module (`repro/serve/cluster.py`), over the
port's coalescer and engine: under a fixed service model its event trace
equals the reference's for the same requests, policy and fault plan.

The dispatch loop, per batch (coalesced by the same `next_batch`
policy, against the earliest-free live replica):

  * **routing** — ``least_loaded`` (min `free_at`, lowest id breaks
    ties) or ``round_robin`` over live replicas; a request retried off
    a failed replica prefers any OTHER live replica.
  * **deadline** — a dispatch whose virtual service exceeds
    ``timeout_s`` is a failed attempt: the batch re-queues onto a
    different replica at ``deadline + backoff``, exponential with
    deterministic jitter (counter-hash of (rid, attempt) — no RNG
    state, replayable). After ``max_retries`` timed-out attempts the
    slow answer is accepted (counted `serve_deadline_misses`) — a late
    answer beats no answer.
  * **hedging** — optional: when the primary has not answered
    ``hedge_after_s`` (or a live ``hedge_quantile`` of observed service
    times) after launch, the SAME batch fires on a second replica;
    first virtual finish wins, the loser is cancelled (its clock is
    rolled back to the winner's finish — cancellation reclaims the
    tail, not the spent prefix).
  * **replica death** — a `ReplicaFailure` answers nothing: the engine
    reports the in-flight batch in `DrainResult.abandoned`, the
    dispatcher re-queues it (no retry budget burned — death produced no
    answer to fall back on), the replica's consecutive-failure count
    rises, and at ``max_failures`` it is marked dead and the stream
    rebalances over survivors. Death re-queues re-insert by ready time
    (bisect) — the coalescer validates monotonicity, it never sorts.
  * **health checks** — every ``health_every`` dispatches each replica
    is probed for a liveness bit (a `ReplicaFaultPlan` can script lies
    — flaky probes — and revivals); failed probes count toward
    ``max_failures``, a passing probe resets the count, and a dead
    replica whose probe passes again is re-admitted (the probe IS the
    warm-up check). The per-replica `IndexHealthMonitor` ladder rides
    inside each engine exactly as in single-replica serving.

Telemetry rides the shared bus: `serve_retries` / `serve_hedges` /
`serve_timeouts` / `serve_replica_deaths` / `serve_rebalances` /
`serve_readmissions` / `serve_deadline_misses` counters,
`serve_cluster_latency` / `serve_cluster_queue_wait` per-request
timings, and every replica engine's records labelled ``replica=i``
(per-replica occupancy and queue-wait series). The report renders a
"## Cluster" section from exactly these keys (`repro_torch.obs.schema`).

Every routing/retry/death decision lands in ``Dispatcher.events`` as a
plain dict with its virtual timestamp — `event_trace()` is the
canonical replay artifact a chaos drill diffs across two runs.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable

from repro_torch.serve.coalescer import CoalescePolicy, Request, next_batch
from repro_torch.serve.engine import ServingEngine

__all__ = [
    "ClusterRecord",
    "ClusterResult",
    "DispatchPolicy",
    "Dispatcher",
    "Replica",
]


def _hash01(a: int, b: int) -> float:
    """Deterministic [0, 1) hash of (rid, attempt) — the backoff jitter
    source. A counter hash (splitmix-style mixing), not an RNG: no
    state, so a replayed drill draws identical jitter."""
    x = (a * 0x9E3779B9 + b * 0x85EBCA6B + 0x6A09E667) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x045D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x045D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    return x / 2.0**32


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    """The cluster dispatcher's knob surface.

    route           "least_loaded" (min free_at, id breaks ties) or
                    "round_robin"
    timeout_s       per-dispatch deadline; a batch whose virtual service
                    runs past it is retried on a different replica
                    (None disables)
    max_retries     timed-out attempts per request before the slow
                    answer is accepted anyway
    backoff_base_s  first retry delay; grows by backoff_mult per attempt
    backoff_mult    exponential backoff factor
    backoff_jitter  fraction of the delay added as deterministic jitter
                    (counter-hash of (rid, attempt))
    hedge_after_s   fire a backup dispatch on a second replica when the
                    primary is still busy this long after launch (None
                    disables unless hedge_quantile is set)
    hedge_quantile  derive the hedge delay live as this percentile of
                    observed batch service times (e.g. 99.0), once
                    hedge_min_obs batches completed — the "p99-derived
                    delay" knob
    hedge_min_obs   observations required before a quantile hedge arms
    max_failures    consecutive failures (failed dispatches, timeouts,
                    failed health probes) before a replica is marked
                    dead and the stream rebalances over survivors
    health_every    dispatches between periodic health-check rounds
                    (0 disables; dispatch-failure detection still runs)
    """

    route: str = "least_loaded"
    timeout_s: float | None = None
    max_retries: int = 2
    backoff_base_s: float = 0.001
    backoff_mult: float = 2.0
    backoff_jitter: float = 0.5
    hedge_after_s: float | None = None
    hedge_quantile: float | None = None
    hedge_min_obs: int = 8
    max_failures: int = 2
    health_every: int = 4

    def __post_init__(self):
        if self.route not in ("least_loaded", "round_robin"):
            raise ValueError(
                f"route must be least_loaded|round_robin, got {self.route!r}"
            )
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff_base_s >= 0 and backoff_mult >= 1 required")
        if not 0.0 <= self.backoff_jitter <= 1.0:
            raise ValueError(
                f"backoff_jitter must lie in [0, 1], got {self.backoff_jitter}"
            )
        if self.hedge_after_s is not None and self.hedge_after_s <= 0:
            raise ValueError(f"hedge_after_s must be > 0, got {self.hedge_after_s}")
        if self.hedge_quantile is not None and not 50 <= self.hedge_quantile <= 100:
            raise ValueError(
                f"hedge_quantile must lie in [50, 100], got {self.hedge_quantile}"
            )
        if self.max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, got {self.max_failures}")
        if self.health_every < 0:
            raise ValueError(f"health_every must be >= 0, got {self.health_every}")


@dataclasses.dataclass(frozen=True)
class ClusterRecord:
    """One answered request, cluster view: original arrival, winning
    replica, attempt count, whether a hedge fired / the deadline was
    ultimately missed."""

    rid: int
    arrival: float
    launch: float  # winning dispatch's launch
    finish: float
    replica: int
    attempts: int
    hedged: bool = False
    deadline_missed: bool = False
    result: Any = None

    @property
    def queue_wait(self) -> float:
        return self.launch - self.arrival

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


class ClusterResult(list):
    """Answered `ClusterRecord`s plus — explicitly — the requests no
    surviving replica could answer (total outage only)."""

    def __init__(self, records=(), unanswered=()):
        super().__init__(records)
        self.unanswered: list[Request] = list(unanswered)


@dataclasses.dataclass
class _Pending:
    """A queued cluster request: original arrival for latency truth,
    t_ready for coalescing (moves forward on retry), attempt count and
    the replica the last failure excludes."""

    rid: int
    payload: Any
    arrival: float
    t_ready: float
    attempts: int = 0
    exclude: int | None = None


class _FaultedRoute:
    """Route proxy wiring a `ReplicaFaultPlan` into one replica: counts
    the replica's dispatches (one `prepare` per batch), raises
    `ReplicaDeath` on a scripted death, and stashes injected slow-down
    for the engine's service model to consume. Everything else delegates
    to the wrapped route (ladder hooks included)."""

    def __init__(self, route, plan, replica_id: int):
        self._route = route
        self._plan = plan
        self._rid = replica_id
        self.dispatches = 0
        self._extra = 0.0

    def __getattr__(self, name):
        return getattr(self._route, name)

    def prepare(self, payloads):
        from repro_torch.health.faults import ReplicaDeath

        self.dispatches += 1
        fault = self._plan.dispatch_fault(self._rid, self.dispatches)
        if fault == "die":
            raise ReplicaDeath(self._rid, self.dispatches)
        self._extra = float(fault or 0.0)
        return self._route.prepare(payloads)

    def take_extra(self) -> float:
        extra, self._extra = self._extra, 0.0
        return extra


class Replica:
    """One serving replica: a `ServingEngine` over its own route copy,
    plus the dispatcher-side liveness state (alive bit, consecutive
    failures, health-check tick)."""

    def __init__(
        self,
        rid: int,
        route,
        coalesce: CoalescePolicy,
        *,
        bus=None,
        health=None,
        plan=None,
        service_model: Callable[[float, int], float] | None = None,
    ):
        self.id = rid
        self.alive = True
        self.failures = 0  # consecutive; a success or passing probe resets
        self.checks = 0  # health-check tick (the fault plan's probe clock)
        route = _FaultedRoute(route, plan, rid) if plan is not None else route
        self._faulted = route if plan is not None else None

        def model(measured: float, batch_no: int) -> float:
            base = (
                measured if service_model is None
                else service_model(measured, batch_no)
            )
            extra = self._faulted.take_extra() if self._faulted is not None else 0.0
            return base + extra

        self.engine = ServingEngine(
            route, coalesce, bus=bus, health=health,
            service_model=model, labels={"replica": rid},
        )

    @property
    def free_at(self) -> float:
        return self.engine.free_at


class Dispatcher:
    """The cluster: one global FIFO stream sharded over N replicas with
    health checks, deadlines, bounded retry and optional hedging. Same
    submit/warmup/drain surface as `ServingEngine` — a drop-in scale-out
    of the single-replica serving loop."""

    def __init__(
        self,
        routes: list,
        coalesce: CoalescePolicy | None = None,
        policy: DispatchPolicy | None = None,
        *,
        bus=None,
        health=None,  # IndexHealthConfig | None — per-replica ladder
        fault_plan=None,  # ReplicaFaultPlan | None — the chaos script
        service_model: Callable[[float, int], float] | None = None,
    ):
        from repro_torch.obs.bus import MetricsBus

        if not routes:
            raise ValueError("Dispatcher needs at least one replica route")
        self.coalesce = coalesce or CoalescePolicy()
        self.policy = policy or DispatchPolicy()
        self.bus = bus if bus is not None else MetricsBus()
        self.replicas = [
            Replica(
                i, route, self.coalesce, bus=self.bus, health=health,
                plan=fault_plan, service_model=service_model,
            )
            for i, route in enumerate(routes)
        ]
        self._queue: list[_Pending] = []
        self.records: list[ClusterRecord] = []
        self.unanswered: list[Request] = []
        self.events: list[dict] = []
        self.dispatches = 0  # global dispatch counter (health cadence)
        self._rr = -1  # round-robin cursor: last picked replica id
        self._rid = 0
        self._service_obs: list[float] = []  # for the quantile hedge

    # -- intake ---------------------------------------------------------
    def submit(self, payload, arrival: float) -> int:
        """Enqueue one request at virtual time ``arrival`` (non-
        decreasing across submits, like the single-replica engine)."""
        if self._queue and arrival < self._queue[-1].t_ready:
            raise ValueError(
                f"arrival {arrival} < last queued {self._queue[-1].t_ready} "
                "(submit in arrival order)"
            )
        rid = self._rid
        self._rid += 1
        self._queue.append(
            _Pending(rid=rid, payload=payload, arrival=arrival, t_ready=arrival)
        )
        return rid

    def warmup(self) -> None:
        """Build and run every replica's paths before traffic."""
        for replica in self.replicas:
            replica.engine.warmup()

    # -- the loop -------------------------------------------------------
    def drain(self) -> ClusterResult:
        """Serve everything queued (retries included); returns the new
        records. Deterministic: every decision is a function of the
        queue, the policy, the fault plan and the (virtual) service
        times — never of host scheduling."""
        start = len(self.records)
        ustart = len(self.unanswered)
        while self._queue:
            live = self._live()
            if not live:
                # total outage: report the stranded stream explicitly
                self._event("outage", t=None, queued=len(self._queue))
                self.unanswered.extend(
                    Request(rid=p.rid, payload=p.payload, arrival=p.arrival)
                    for p in self._queue
                )
                self._queue = []
                break
            free_at = min(r.free_at for r in live)
            size, launch = next_batch(
                [p.t_ready for p in self._queue], free_at, self.coalesce
            )
            batch, self._queue = self._queue[:size], self._queue[size:]
            self._dispatch(batch, launch, live)
            self._health_round()
        self.bus.drain()
        return ClusterResult(
            self.records[start:], unanswered=self.unanswered[ustart:]
        )

    # -- dispatch internals ---------------------------------------------
    def _live(self) -> list[Replica]:
        return [r for r in self.replicas if r.alive]

    def _pick(self, live: list[Replica], excluded: set[int]) -> Replica:
        pool = [r for r in live if r.id not in excluded] or live
        if self.policy.route == "round_robin":
            # rotate over replica IDS, not pool indices: the pool shrinks
            # and grows with deaths/exclusions, and a modulo cursor over a
            # churning pool can hand the same replica consecutive batches.
            # The cursor remembers the last picked id; the next pick is the
            # smallest eligible id strictly greater, wrapping around.
            ids = sorted(r.id for r in pool)
            self._rr = next((i for i in ids if i > self._rr), ids[0])
            return next(r for r in pool if r.id == self._rr)
        return min(pool, key=lambda r: (r.free_at, r.id))

    def _backoff(self, pending: _Pending) -> float:
        p = self.policy
        delay = p.backoff_base_s * p.backoff_mult ** max(0, pending.attempts - 1)
        return delay * (1.0 + p.backoff_jitter * _hash01(pending.rid, pending.attempts))

    def _requeue(self, pending: _Pending) -> None:
        """Sorted re-insert by ready time — the coalescer validates
        monotonicity instead of sorting, so the queue owner keeps it."""
        bisect.insort(self._queue, pending, key=lambda q: q.t_ready)

    def _hedge_delay(self) -> float | None:
        p = self.policy
        if p.hedge_after_s is not None:
            return p.hedge_after_s
        if p.hedge_quantile is not None and len(self._service_obs) >= p.hedge_min_obs:
            from repro_torch.obs.report import percentile

            return percentile(self._service_obs, p.hedge_quantile)
        return None

    def _event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, **fields})

    def _serve_on(self, replica: Replica, reqs: list[Request], not_before: float):
        """One engine dispatch + service-time bookkeeping."""
        res = replica.engine.serve_batch(reqs, not_before)
        if res.failure is None and res:
            self._service_obs.append(res[0].finish - res[0].launch)
        return res

    def _dispatch(self, batch: list[_Pending], launch: float, live: list[Replica]) -> None:
        self.dispatches += 1
        excluded = {p.exclude for p in batch if p.exclude is not None}
        replica = self._pick(live, excluded)
        reqs = [
            Request(rid=p.rid, payload=p.payload, arrival=p.t_ready)
            for p in batch
        ]
        rids = [p.rid for p in batch]
        attempt = max(p.attempts for p in batch) + 1
        self._event(
            "dispatch", t=round(max(launch, replica.free_at), 9),
            replica=replica.id, rids=rids, attempt=attempt,
        )
        res = self._serve_on(replica, reqs, launch)
        if res.failure is not None:
            self._on_failed_dispatch(replica, batch, launch)
            return
        replica.failures = 0
        actual_launch, finish = res[0].launch, res[0].finish
        winner, hedged = replica, False

        # hedging: the primary is still busy hedge_delay after launch —
        # fire the same batch on a second replica, first finish wins
        delay = self._hedge_delay()
        if (
            delay is not None
            and finish - actual_launch > delay
            and len(live) > 1
        ):
            backup = self._pick(
                [r for r in live if r.id != replica.id], excluded
            )
            hedge_t = actual_launch + delay
            self.bus.counter("serve_hedges", len(batch))
            self._event(
                "hedge", t=round(hedge_t, 9), replica=backup.id,
                primary=replica.id, rids=rids,
            )
            bres = self._serve_on(backup, reqs, hedge_t)
            if bres.failure is not None:
                self._note_failure(backup, hedge_t)  # primary answer stands
            else:
                hedged = True
                bfinish = bres[0].finish
                if bfinish < finish:
                    # backup wins: cancel the primary's tail, and swap the
                    # record source — downstream (_record, the timeout zip)
                    # must see the WINNING dispatch's launch/finish/result,
                    # not the cancelled primary's
                    replica.engine.free_at = min(replica.engine.free_at, bfinish)
                    winner, finish, res = backup, bfinish, bres
                    actual_launch = bres[0].launch
                else:
                    backup.engine.free_at = min(backup.engine.free_at, finish)
                self._event(
                    "hedge_win", t=round(finish, 9), replica=winner.id,
                    rids=rids,
                )

        # deadline: a slow answer is a failed attempt while retries
        # remain; the final attempt accepts it (late beats never)
        timeout = self.policy.timeout_s
        if timeout is not None and finish - actual_launch > timeout:
            deadline = actual_launch + timeout
            self._note_failure(winner, deadline)
            self.bus.counter("serve_timeouts", len(batch))
            kept = []
            for p, rec in zip(batch, res):
                if p.attempts < self.policy.max_retries:
                    p.attempts += 1
                    p.exclude = winner.id
                    p.t_ready = deadline + self._backoff(p)
                    self.bus.counter("serve_retries")
                    self._event(
                        "retry", t=round(p.t_ready, 9), rid=p.rid,
                        attempt=p.attempts, excluded=winner.id,
                    )
                    self._requeue(p)
                else:
                    kept.append((p, rec, True))
                    self.bus.counter("serve_deadline_misses")
            self._record(kept, winner, hedged)
            return
        self._record([(p, rec, False) for p, rec in zip(batch, res)], winner, hedged)

    def _record(self, kept, winner: Replica, hedged: bool) -> None:
        for p, rec, missed in kept:
            crec = ClusterRecord(
                rid=p.rid, arrival=p.arrival, launch=rec.launch,
                finish=rec.finish, replica=winner.id,
                attempts=p.attempts + 1, hedged=hedged,
                deadline_missed=missed, result=rec.result,
            )
            self.records.append(crec)
            self.bus.timing("serve_cluster_latency", crec.latency, step=p.rid)
            self.bus.timing(
                "serve_cluster_queue_wait", crec.queue_wait, step=p.rid
            )

    def _on_failed_dispatch(self, replica: Replica, batch: list[_Pending], launch: float) -> None:
        """A dead replica answered nothing: re-queue the whole in-flight
        batch onto a different replica. No retry budget is burned —
        unlike a timeout there is no slow answer to fall back on, and
        the 100%-answered guarantee rests on exactly this."""
        self._note_failure(replica, launch)
        self.bus.counter("serve_retries", len(batch))
        for p in batch:
            p.exclude = replica.id
            p.t_ready = launch + self._backoff(p)
            self._requeue(p)
        self._event(
            "requeue", t=round(launch, 9), replica=replica.id,
            rids=[p.rid for p in batch],
        )

    def _note_failure(self, replica: Replica, t: float) -> None:
        replica.failures += 1
        if replica.alive and replica.failures >= self.policy.max_failures:
            self._mark_dead(replica, t)

    def _mark_dead(self, replica: Replica, t: float) -> None:
        replica.alive = False
        self.bus.counter("serve_replica_deaths")
        self._event("death", t=round(t, 9), replica=replica.id)
        survivors = [r.id for r in self._live()]
        self.bus.counter("serve_rebalances")
        self._event("rebalance", t=round(t, 9), survivors=survivors)

    # -- health checks ---------------------------------------------------
    def _health_round(self) -> None:
        """Every ``health_every`` dispatches, probe every replica's
        liveness bit (the fault plan can lie, and processes revivals
        here). Probe failures count toward ``max_failures``; a dead
        replica whose probe passes again is re-admitted — the passing
        probe IS its warm-up check."""
        every = self.policy.health_every
        if every == 0 or self.dispatches % every != 0:
            return
        t = round(max((r.free_at for r in self.replicas), default=0.0), 9)
        for replica in self.replicas:
            replica.checks += 1
            plan = replica._faulted._plan if replica._faulted is not None else None
            alive_bit = (
                plan.probe_alive(replica.id, replica.checks)
                if plan is not None else True
            )
            if replica.alive:
                if alive_bit:
                    replica.failures = 0
                else:
                    replica.failures += 1
                    self._event(
                        "probe_fail", t=t, replica=replica.id,
                        check=replica.checks, failures=replica.failures,
                    )
                    if replica.failures >= self.policy.max_failures:
                        self._mark_dead(replica, t)
            elif alive_bit:
                replica.alive = True
                replica.failures = 0
                self.bus.counter("serve_readmissions")
                self._event(
                    "readmit", t=t, replica=replica.id, check=replica.checks
                )

    # -- summaries -------------------------------------------------------
    def event_trace(self) -> list[dict]:
        """The canonical replay artifact: every routing/retry/death
        decision with its virtual timestamp. Under a fixed service
        model two identical drills produce identical traces — the
        chaos drill's determinism gate diffs exactly this."""
        return list(self.events)

    def occupancy(self) -> float:
        batches = sum(r.engine.batches for r in self.replicas)
        served = sum(len(r.engine.records) for r in self.replicas)
        return served / batches if batches else 0.0

    def latencies(self) -> list[float]:
        return [r.latency for r in self.records]

    def per_replica(self) -> list[dict]:
        """Per-replica load summary (also useful for tests asserting the
        sharding actually spread)."""
        return [
            {
                "replica": r.id,
                "alive": r.alive,
                "batches": r.engine.batches,
                "requests": len(r.engine.records),
                "occupancy": r.engine.occupancy(),
                "free_at": r.free_at,
            }
            for r in self.replicas
        ]
