"""The continuous-batching serving engine.

`ServingEngine` owns the request queue, the coalescing policy and the
telemetry; the route owns the model. The loop runs a hybrid clock:
arrivals, launches and finishes advance on a VIRTUAL event clock driven
by the coalescer (`next_batch`), while each batch's service time is the
REAL measured wall time of the route's run, ended by a
`torch.cuda.synchronize` of the route's device (the route never
synchronises inside `run`, which would hide queue time). Offered-QPS
sweeps are then exact and reproducible, and every latency still holds
the true model cost.

An optional ``service_model`` replaces the measured wall time with a
modelled virtual service time, ``(measured_s, batch_no) -> virtual_s``:
with a fixed cost the whole timeline is bitwise reproducible.

`serve_batch` serves exactly one list of requests now; `drain`'s queue
loop is built on it. A `ReplicaFailure` raised by the route answers
nothing: the batch comes back in `DrainResult.abandoned` with the
failure attached.

Telemetry (repro_torch.obs bus, drained once per batch):

    serve_queue_wait     timing, per request (launch - arrival)
    serve_latency        timing, per request (finish - arrival)
    serve_batch_service  timing, per batch (virtual service time)
    serve_batch_size     gauge, per batch (real rows in the pad)
    serve_occupancy      gauge, per batch (real rows / max_batch)
    serve_requests       counter
    serve_abandoned      counter, requests a failed dispatch returned
    index_health         events, when the degradation ladder is armed

An engine owned by a cluster replica carries ``labels={"replica": i}``
on every record, so per-replica occupancy and queue-wait series come
out of the one shared bus.

The ladder rides as in the trainer: an `IndexHealthConfig` (``health=``)
arms an `IndexHealthMonitor`; every ``probe_every`` batches the route's
sampled-recall probe and overflow counter feed `observe()`, and the
monitor's verdicts run through the route's ladder hooks (compact ->
rebuild -> the pre-warmed exact fallback). Requests keep answering
through every rung. Probing reads on the host, after a batch's service
time was taken, so its cost is engine busy time, not a request's
service time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.health.faults import ReplicaFailure
from repro_torch.obs.bus import MetricsBus
from repro_torch.obs.trace import span
from repro_torch.serve.coalescer import CoalescePolicy, Request, next_batch, pad_payloads

__all__ = ["DrainResult", "RequestRecord", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One answered request, with its full timing decomposition."""

    rid: int
    arrival: float
    launch: float
    finish: float
    batch_size: int
    result: Any

    @property
    def queue_wait(self) -> float:
        return self.launch - self.arrival

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


class DrainResult(list):
    """The records a drain/serve call answered (a plain list of
    `RequestRecord`s), plus what it could NOT answer:

    abandoned   `Request`s a failed dispatch returned unanswered (the
                failed batch, plus everything still queued when `drain`
                stopped).
    failure     the `ReplicaFailure` that stopped serving, or None.
    """

    def __init__(self, records=(), abandoned=(), failure=None):
        super().__init__(records)
        self.abandoned: list[Request] = list(abandoned)
        self.failure = failure


def _synchronize(device) -> None:
    """Wait for the route's device work; a CPU route has none in flight."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Queue + coalesce + execute + observe, against one route."""

    def __init__(
        self,
        route,
        policy: CoalescePolicy | None = None,
        *,
        bus: MetricsBus | None = None,
        health=None,  # IndexHealthConfig | None: arms the ladder
        service_model: Callable[[float, int], float] | None = None,
        labels: dict | None = None,
    ):
        self.route = route
        self.policy = policy or CoalescePolicy()
        self.bus = bus if bus is not None else MetricsBus()
        self.service_model = service_model
        self.labels = dict(labels or {})
        self.monitor = None
        if health is not None:
            from repro_torch.health.index_health import IndexHealthMonitor

            self.monitor = IndexHealthMonitor(health, self.bus)
        self.queue: list[Request] = []
        self.records: list[RequestRecord] = []
        self.free_at = 0.0
        self.batches = 0
        self._rid = 0

    # -- intake ---------------------------------------------------------
    def submit(self, payload, arrival: float) -> int:
        """Enqueue one request at virtual time ``arrival`` (must be
        non-decreasing across submits — the queue is FIFO)."""
        if self.queue and arrival < self.queue[-1].arrival:
            raise ValueError(
                f"arrival {arrival} < last queued {self.queue[-1].arrival} "
                "(submit in arrival order)"
            )
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid=rid, payload=payload, arrival=arrival))
        return rid

    def warmup(self) -> None:
        """Build and run the route's paths (primary AND fallback) before
        traffic, so no request's latency pays a kernel build."""
        if hasattr(self.route, "warmup"):
            self.route.warmup(self.policy.max_batch)

    # -- the loop -------------------------------------------------------
    def drain(self) -> DrainResult:
        """Serve everything queued; returns the new records (appended to
        ``self.records`` too). Callable repeatedly: the virtual clock
        (`free_at`) persists across drains. If the route fails a dispatch
        (`ReplicaFailure`), serving stops and every unanswered request is
        reported in ``DrainResult.abandoned``."""
        out = DrainResult()
        while self.queue:
            res = self._launch_one()
            out.extend(res)
            out.abandoned.extend(res.abandoned)
            if res.failure is not None:
                out.failure = res.failure
                out.abandoned.extend(self.queue)
                self.queue = []
        return out

    def _launch_one(self) -> DrainResult:
        size, launch = next_batch(
            [r.arrival for r in self.queue], self.free_at, self.policy
        )
        batch, self.queue = self.queue[:size], self.queue[size:]
        return self.serve_batch(batch, launch)

    def serve_batch(self, batch: list[Request], not_before: float = 0.0) -> DrainResult:
        """Serve exactly ``batch`` at virtual time ``max(free_at,
        not_before, latest arrival)``. On `ReplicaFailure` nothing is
        answered: the batch comes back in ``.abandoned`` and the virtual
        clock does not advance."""
        if not batch:
            return DrainResult()
        size = len(batch)
        launch = max(self.free_at, not_before, max(r.arrival for r in batch))
        try:
            payloads = pad_payloads(
                [r.payload for r in batch], self.policy.max_batch,
                self.route.pad_payload,
            )
            with span("serve_batch", batch=self.batches, n=size):
                with span("serve_prepare", batch=self.batches):
                    prepared = self.route.prepare(payloads)
                t0 = time.perf_counter()
                with span("serve_run", batch=self.batches):
                    out = self.route.run(prepared)
                    _synchronize(self.route.device)
                measured = time.perf_counter() - t0
        except ReplicaFailure as exc:
            self.bus.counter("serve_abandoned", size, **self.labels)
            self.bus.drain()
            return DrainResult([], abandoned=batch, failure=exc)
        service = (
            measured
            if self.service_model is None
            else float(self.service_model(measured, self.batches))
        )
        finish = launch + service
        self.free_at = finish
        results = self.route.finalize(out, size)
        recs = []
        for req, result in zip(batch, results):
            rec = RequestRecord(
                rid=req.rid, arrival=req.arrival, launch=launch,
                finish=finish, batch_size=size, result=result,
            )
            recs.append(rec)
            self.records.append(rec)
            self.bus.timing(
                "serve_queue_wait", rec.queue_wait, step=req.rid, **self.labels
            )
            self.bus.timing("serve_latency", rec.latency, step=req.rid, **self.labels)
        self.bus.timing(
            "serve_batch_service", service, step=self.batches, **self.labels
        )
        self.bus.gauge(
            "serve_batch_size", float(size), step=self.batches, **self.labels
        )
        self.bus.gauge(
            "serve_occupancy", size / self.policy.max_batch,
            step=self.batches, **self.labels,
        )
        self.bus.counter("serve_requests", size, **self.labels)
        self.batches += 1
        self._maybe_probe()
        self.bus.drain()
        return DrainResult(recs)

    # -- the degradation ladder ----------------------------------------
    def _maybe_probe(self) -> None:
        """The trainer's cadence / verdict / execute split: the monitor
        decides, the route's hooks act."""
        monitor = self.monitor
        if monitor is None or getattr(self.route, "degraded", False):
            return
        ih = monitor.cfg
        cadence = ih.probe_every if ih.probe_every else 1
        if self.batches % cadence != 0:
            return
        recall = self.route.probe() if ih.probe_every else None
        overflow = self.route.overflow()
        action = monitor.observe(recall, overflow)
        if recall is not None or action:
            self.bus.event(
                "index_health",
                {"step": self.batches, "recall": recall, "overflow": overflow,
                 "action": action},
                step=self.batches,
            )
        if action in ("compact", "rebuild"):
            with span(f"index_{action}", batch=self.batches):
                self.route.heal(action)
        elif action == "fallback":
            self.route.degrade()

    # -- summaries ------------------------------------------------------
    def occupancy(self) -> float:
        """Mean real rows per launched batch (> 1 means batching won)."""
        if not self.records:
            return 0.0
        return len(self.records) / self.batches

    def latencies(self) -> list[float]:
        return [r.latency for r in self.records]
