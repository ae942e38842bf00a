"""The port's cluster dispatcher (`repro_torch.serve.cluster`) on the CPU:
the mirror of `tests/test_cluster.py` (routing, retry / timeout /
hedging, replica death and re-admission, trace determinism, the engine's
abandoned batches and the coalescer's properties), and parity with the
reference's `repro.serve.cluster`.

Most tests run a FakeRoute (host lists, no model, a fixed virtual
service time), the reference test's, with the port's route contract's
``device`` ("cpu": nothing to synchronise). Parity: both dispatchers
take the same requests, policy and `ReplicaFaultPlan` (each package's
own instance: a plan keeps state) under the same service model, and
their `event_trace()`s and records are equal as lists, bit for bit. The
real-route drill serves SASRec SMOKE_CONFIG through three replicas of
each package, the reference's weights and index carried across to the
port: the same events, ids equal as sets, scores within rtol 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.health import faults as jfaults  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import ivf_index_from_numpy, recsys_params_from_numpy  # noqa: E402
from repro_torch.health.faults import (  # noqa: E402
    ReplicaDeath,
    ReplicaFailure,
    ReplicaFaultPlan,
)
from repro_torch.models import recsys  # noqa: E402
from repro_torch.obs.schema import SERVE_CLUSTER_COUNTER_KEYS  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CoalescePolicy,
    Dispatcher,
    DispatchPolicy,
    RecsysMIPSRoute,
    Request,
    ServingEngine,
    next_batch,
)
from repro_torch.serve import planner as planner_mod  # noqa: E402


class FakeRoute:
    """Identity route: payloads in, payloads out, zero model cost."""

    device = "cpu"
    pad_payload = 0

    def prepare(self, payloads):
        return payloads

    def run(self, prepared):
        return prepared

    def finalize(self, out, size):
        return out[:size]


SERVICE = 0.010  # fixed virtual seconds per batch


def build(n=3, plan=None, policy=None, max_batch=4):
    return Dispatcher(
        [FakeRoute() for _ in range(n)],
        CoalescePolicy(max_batch=max_batch, max_wait_s=0.002),
        policy or DispatchPolicy(),
        fault_plan=plan,
        service_model=lambda measured, batch_no: SERVICE,
    )


def offer(disp, n, spacing=0.001):
    for i in range(n):
        disp.submit(i, i * spacing)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_clean_run_answers_all_and_spreads_load():
    disp = build()
    offer(disp, 24)
    res = disp.drain()
    assert len(res) == 24 and not res.unanswered
    assert sorted(r.rid for r in res) == list(range(24))
    loads = [r["requests"] for r in disp.per_replica()]
    assert all(n > 0 for n in loads), f"least-loaded left a replica idle: {loads}"
    # cluster latency: finish - ORIGINAL arrival >= one service
    assert all(r.latency >= SERVICE - 1e-9 for r in res)


def test_round_robin_cycles_replicas():
    disp = build(policy=DispatchPolicy(route="round_robin"))
    offer(disp, 24)
    disp.drain()
    replicas = [e["replica"] for e in disp.events if e["kind"] == "dispatch"]
    assert replicas[:3] == [0, 1, 2] and set(replicas) == {0, 1, 2}


def test_submit_rejects_decreasing_arrivals():
    disp = build()
    disp.submit(0, 1.0)
    with pytest.raises(ValueError, match="arrival order"):
        disp.submit(1, 0.5)


def test_policy_validation():
    with pytest.raises(ValueError, match="route"):
        DispatchPolicy(route="random")
    with pytest.raises(ValueError, match="timeout_s"):
        DispatchPolicy(timeout_s=0.0)
    with pytest.raises(ValueError, match="hedge_quantile"):
        DispatchPolicy(hedge_quantile=10.0)
    with pytest.raises(ValueError, match="max_failures"):
        DispatchPolicy(max_failures=0)


# ---------------------------------------------------------------------------
# replica death
# ---------------------------------------------------------------------------

def test_replica_death_requeues_and_answers_everything():
    plan = ReplicaFaultPlan(die=((1, 2),))
    disp = build(plan=plan)
    offer(disp, 24)
    res = disp.drain()
    assert len(res) == 24 and not res.unanswered
    assert disp.bus.total("serve_replica_deaths") == 1
    assert disp.bus.total("serve_rebalances") == 1
    assert not disp.replicas[1].alive
    kinds = [e["kind"] for e in disp.events]
    assert "requeue" in kinds and "death" in kinds and "rebalance" in kinds
    # the dead replica's in-flight requests were answered elsewhere
    dead_rids = next(e["rids"] for e in disp.events if e["kind"] == "requeue")
    winners = {r.rid: r.replica for r in res}
    assert all(winners[rid] != 1 for rid in dead_rids)


def test_death_does_not_burn_retry_budget():
    # max_retries=0: a timeout would be accepted at once, but a death
    # must still be re-dispatched (no answer exists to accept)
    plan = ReplicaFaultPlan(die=((0, 1),))
    disp = build(plan=plan, policy=DispatchPolicy(max_retries=0, max_failures=1))
    offer(disp, 8)
    res = disp.drain()
    assert len(res) == 8 and not res.unanswered
    assert all(r.replica != 0 for r in res)


def test_total_outage_reports_unanswered():
    plan = ReplicaFaultPlan(die=((0, 1), (1, 1), (2, 1)))
    disp = build(plan=plan, policy=DispatchPolicy(max_failures=1, health_every=0))
    offer(disp, 8)
    res = disp.drain()
    assert len(res) == 0
    assert len(res.unanswered) == 8
    assert all(isinstance(r, Request) for r in res.unanswered)
    assert any(e["kind"] == "outage" for e in disp.events)


def test_trace_is_bitwise_deterministic():
    def one_run():
        disp = build(plan=ReplicaFaultPlan(die=((1, 2),)))
        offer(disp, 24)
        disp.drain()
        return disp.event_trace(), [
            (r.rid, r.replica, r.launch, r.finish) for r in disp.records
        ]

    t1, r1 = one_run()
    t2, r2 = one_run()
    assert t1 == t2
    assert r1 == r2


# ---------------------------------------------------------------------------
# timeout / retry / hedging
# ---------------------------------------------------------------------------

def test_timeout_retries_on_other_replica_with_backoff():
    plan = ReplicaFaultPlan(slow_from=((0, 1, 5 * SERVICE),))
    disp = build(plan=plan, policy=DispatchPolicy(timeout_s=2 * SERVICE, max_retries=2))
    offer(disp, 8)
    res = disp.drain()
    assert len(res) == 8 and not res.unanswered
    assert disp.bus.total("serve_timeouts") > 0
    assert disp.bus.total("serve_retries") > 0
    retried = [e for e in disp.events if e["kind"] == "retry"]
    assert retried and all(e["excluded"] == 0 for e in retried)
    # the retried requests won on a different replica
    retried_rids = {e["rid"] for e in retried}
    winners = {r.rid: r.replica for r in res}
    assert all(winners[rid] != 0 for rid in retried_rids)


def test_exhausted_retries_accept_slow_answer():
    # every replica slow: retries burn out, the slow answer is accepted
    # and flagged as a deadline miss
    plan = ReplicaFaultPlan(slow_from=tuple((r, 1, 5 * SERVICE) for r in range(3)))
    disp = build(plan=plan, policy=DispatchPolicy(timeout_s=2 * SERVICE, max_retries=1))
    offer(disp, 8)
    res = disp.drain()
    assert len(res) == 8 and not res.unanswered
    assert disp.bus.total("serve_deadline_misses") == 8
    assert all(r.deadline_missed for r in res)


def test_hedge_fires_and_first_answer_wins():
    plan = ReplicaFaultPlan(slow_from=((0, 1, 5 * SERVICE),))
    disp = build(
        plan=plan,
        policy=DispatchPolicy(route="round_robin", hedge_after_s=2 * SERVICE),
    )
    offer(disp, 12)
    res = disp.drain()
    assert len(res) == 12 and not res.unanswered
    assert disp.bus.total("serve_hedges") > 0
    wins = [e for e in disp.events if e["kind"] == "hedge_win"]
    assert wins
    # every hedged batch that launched on the slow replica was won by the
    # backup (its virtual service is 6x the healthy one)
    hedged_off_0 = [e for e in disp.events if e["kind"] == "hedge" and e["primary"] == 0]
    assert hedged_off_0
    win_by_rids = {tuple(e["rids"]): e["replica"] for e in wins}
    assert all(win_by_rids[tuple(e["rids"])] != 0 for e in hedged_off_0)


def test_hedge_win_record_carries_winning_dispatch():
    # when the backup wins, the ClusterRecord carries the winning
    # dispatch's launch / finish, not the cancelled primary's
    plan = ReplicaFaultPlan(slow_from=((0, 1, 5 * SERVICE),))
    disp = build(
        plan=plan,
        policy=DispatchPolicy(route="round_robin", hedge_after_s=2 * SERVICE),
    )
    offer(disp, 12)
    res = disp.drain()
    wins = [e for e in disp.events if e["kind"] == "hedge_win"]
    assert wins
    by_rid = {r.rid: r for r in res}
    for e in wins:
        for rid in e["rids"]:
            rec = by_rid[rid]
            assert rec.replica == e["replica"]
            assert rec.finish == pytest.approx(e["t"])
    # a batch hedged off the slow replica finished at the backup's
    # healthy service span, not the primary's 6x one
    hedged_off_0 = [e for e in disp.events if e["kind"] == "hedge" and e["primary"] == 0]
    assert hedged_off_0
    for e in hedged_off_0:
        for rid in e["rids"]:
            rec = by_rid[rid]
            assert rec.finish - rec.launch == pytest.approx(SERVICE)


def test_unanswered_not_rereported_across_drains():
    # drain() returns only this cycle's stranded requests; the
    # cumulative list stays on the dispatcher
    plan = ReplicaFaultPlan(die=((0, 1), (1, 1), (2, 1)))
    disp = build(plan=plan, policy=DispatchPolicy(max_failures=1, health_every=0))
    offer(disp, 8)
    res1 = disp.drain()
    assert len(res1.unanswered) == 8
    for i in range(3):
        disp.submit(100 + i, 1.0 + i * 0.001)
    res2 = disp.drain()
    assert [r.payload for r in res2.unanswered] == [100, 101, 102]
    assert len(disp.unanswered) == 11


def test_round_robin_rotates_fairly_after_death():
    # the cursor walks replica ids, so a shrunk pool still alternates
    plan = ReplicaFaultPlan(die=((1, 2),))
    disp = build(plan=plan, policy=DispatchPolicy(route="round_robin", max_failures=1))
    offer(disp, 40)
    res = disp.drain()
    assert len(res) == 40 and not res.unanswered
    death_i = next(i for i, e in enumerate(disp.events) if e["kind"] == "death")
    after = [e["replica"] for e in disp.events[death_i:] if e["kind"] == "dispatch"]
    assert len(after) >= 4 and set(after) == {0, 2}
    assert all(a != b for a, b in zip(after, after[1:])), after


def test_hedge_quantile_arms_after_min_obs():
    disp = build(policy=DispatchPolicy(hedge_quantile=99.0, hedge_min_obs=4))
    assert disp._hedge_delay() is None  # not armed yet
    offer(disp, 24)
    disp.drain()
    assert disp._hedge_delay() == pytest.approx(SERVICE)


# ---------------------------------------------------------------------------
# health checks: flaky probes, death by probe, re-admission
# ---------------------------------------------------------------------------

def test_one_flaky_probe_does_not_kill_a_healthy_replica():
    plan = ReplicaFaultPlan(flaky_probe_at=((1, 1),))
    disp = build(plan=plan, policy=DispatchPolicy(max_failures=2, health_every=2))
    offer(disp, 24)
    res = disp.drain()
    assert len(res) == 24
    assert all(r.alive for r in disp.replicas)
    assert disp.bus.total("serve_replica_deaths") == 0
    assert any(e["kind"] == "probe_fail" for e in disp.events)


def test_probe_death_then_readmission():
    # max_failures=1: the check-1 lie kills replica 1; its check-2 probe
    # passes, so it is re-admitted and serves again
    plan = ReplicaFaultPlan(flaky_probe_at=((1, 1),))
    disp = build(plan=plan, policy=DispatchPolicy(max_failures=1, health_every=1))
    offer(disp, 40)
    res = disp.drain()
    assert len(res) == 40
    assert disp.bus.total("serve_replica_deaths") == 1
    assert disp.bus.total("serve_readmissions") == 1
    assert disp.replicas[1].alive
    kinds = [e["kind"] for e in disp.events]
    assert kinds.index("death") < kinds.index("readmit")


def test_dead_replica_revives_after_warmup_probe():
    plan = ReplicaFaultPlan(die=((1, 1),), revive_at=((1, 6),))
    disp = build(plan=plan, policy=DispatchPolicy(max_failures=1, health_every=1))
    offer(disp, 60)
    res = disp.drain()
    assert len(res) == 60 and not res.unanswered
    assert disp.bus.total("serve_replica_deaths") == 1
    assert disp.bus.total("serve_readmissions") == 1
    assert disp.replicas[1].alive
    # it took traffic again after the readmit
    readmit_idx = next(i for i, e in enumerate(disp.events) if e["kind"] == "readmit")
    later = [
        e for e in disp.events[readmit_idx:]
        if e["kind"] == "dispatch" and e["replica"] == 1
    ]
    assert later, "re-admitted replica never took traffic again"


# ---------------------------------------------------------------------------
# the engine: serve_batch's failure path and explicit abandoned requests
# ---------------------------------------------------------------------------

class DyingRoute(FakeRoute):
    def __init__(self, die_on_call=1):
        self.calls = 0
        self.die_on_call = die_on_call

    def prepare(self, payloads):
        self.calls += 1
        if self.calls >= self.die_on_call:
            raise ReplicaDeath(0, self.calls)
        return payloads


def test_serve_batch_reports_abandoned_and_clock_holds():
    eng = ServingEngine(DyingRoute(), CoalescePolicy(max_batch=4), labels={"replica": 5})
    batch = [Request(rid=i, payload=i, arrival=0.0) for i in range(3)]
    res = eng.serve_batch(batch)
    assert len(res) == 0
    assert [r.rid for r in res.abandoned] == [0, 1, 2]
    assert isinstance(res.failure, ReplicaFailure)
    assert eng.free_at == 0.0  # the replica never did the work
    assert eng.bus.total("serve_abandoned") == 3


def test_drain_reports_queued_requests_on_failure():
    # dies on the SECOND batch: the first answers, the failed batch and
    # the still-queued rest come back in .abandoned
    eng = ServingEngine(
        DyingRoute(die_on_call=2),
        CoalescePolicy(max_batch=2, max_wait_s=0.0),
        service_model=lambda m, b: SERVICE,
    )
    for i in range(6):
        eng.submit(i, 0.0)
    res = eng.drain()
    assert [r.rid for r in res] == [0, 1]
    assert [r.rid for r in res.abandoned] == [2, 3, 4, 5]
    assert res.failure is not None
    assert not eng.queue


def test_non_replica_failure_propagates():
    class BuggyRoute(FakeRoute):
        def prepare(self, payloads):
            raise RuntimeError("an actual bug")

    eng = ServingEngine(BuggyRoute(), CoalescePolicy(max_batch=2))
    with pytest.raises(RuntimeError, match="an actual bug"):
        eng.serve_batch([Request(rid=0, payload=0, arrival=0.0)])


def test_engine_labels_ride_every_record():
    """A replica's engine puts ``**labels`` on every record it drains, as
    the reference's does; an unlabelled engine puts none."""
    from repro_torch.obs import MetricsBus, RingSink

    ring = RingSink()
    eng = ServingEngine(FakeRoute(), CoalescePolicy(max_batch=2, max_wait_s=0.0),
                        bus=MetricsBus([ring]), labels={"replica": 2},
                        service_model=lambda m, b: SERVICE)
    for i in range(3):
        eng.submit(i, 0.0)
    eng.drain()
    dying = ServingEngine(DyingRoute(), CoalescePolicy(max_batch=2),
                          bus=eng.bus, labels={"replica": 3})
    dying.serve_batch([Request(rid=9, payload=9, arrival=0.0)])
    names = {r["name"] for r in ring.records}
    assert names == {"serve_queue_wait", "serve_latency", "serve_batch_service",
                     "serve_batch_size", "serve_occupancy", "serve_requests",
                     "serve_abandoned"}
    assert all(r["labels"] == {"replica": 3 if r["name"] == "serve_abandoned" else 2}
               for r in ring.records)
    bare = ServingEngine(FakeRoute(), CoalescePolicy(max_batch=2), bus=MetricsBus([ring]))
    bare.submit(0, 0.0)
    n = len(ring.records)
    bare.drain()
    assert all("labels" not in r for r in list(ring.records)[n:])


# ---------------------------------------------------------------------------
# the coalescer: non-monotonic arrivals and its properties
# ---------------------------------------------------------------------------

def test_next_batch_rejects_unsorted_arrivals():
    pol = CoalescePolicy(max_batch=4, max_wait_s=0.002)
    with pytest.raises(ValueError, match="non-decreasing"):
        next_batch([0.0, 0.5, 0.3], free_at=0.0, policy=pol)
    # equal timestamps are fine (simultaneous arrivals)
    size, _ = next_batch([0.1, 0.1, 0.1], free_at=0.0, policy=pol)
    assert size == 3


# the property tests are guarded per test, as the reference's: the rest of
# this file runs without hypothesis
try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:
    hypothesis = None

if hypothesis is not None:
    arrivals_st = st.lists(
        st.floats(0.0, 10.0, allow_nan=False, allow_infinity=False),
        min_size=1, max_size=40,
    ).map(sorted)
    policy_st = st.builds(
        CoalescePolicy,
        max_batch=st.integers(1, 16),
        max_wait_s=st.floats(0.0, 0.05, allow_nan=False),
    )

    @hypothesis.given(
        arrivals=arrivals_st,
        free_at=st.floats(0.0, 20.0, allow_nan=False),
        policy=policy_st,
    )
    @hypothesis.settings(deadline=None, max_examples=200)
    def test_coalescer_invariants(arrivals, free_at, policy):
        size, launch = next_batch(arrivals, free_at, policy)
        # a non-empty queue always launches something, within max_batch
        assert 1 <= size <= policy.max_batch
        # never launch before the engine is free or the oldest arrival
        assert launch >= max(free_at, arrivals[0])
        # everything included had arrived by launch
        assert all(a <= launch for a in arrivals[:size])
        # once the engine is free, the oldest waits at most max_wait_s
        assert launch <= max(free_at, arrivals[0] + policy.max_wait_s) + 1e-9

    @hypothesis.given(
        arrivals=arrivals_st,
        free_at=st.floats(0.0, 20.0, allow_nan=False),
        policy=policy_st,
    )
    @hypothesis.settings(deadline=None, max_examples=100)
    def test_coalescer_full_batch_never_delayed(arrivals, free_at, policy):
        # with max_batch requests already waiting at free-time, launch is
        # immediate: a full batch never waits out max_wait_s
        size, launch = next_batch(arrivals, free_at, policy)
        waiting = sum(1 for a in arrivals if a <= max(free_at, arrivals[0]))
        if waiting >= policy.max_batch:
            assert size == policy.max_batch
            assert launch == max(free_at, arrivals[0])
else:
    @pytest.mark.skip(reason="property tests need hypothesis (requirements-dev.txt)")
    def test_coalescer_invariants():
        pass


# ---------------------------------------------------------------------------
# parity with the reference's dispatcher
# ---------------------------------------------------------------------------

def _service(kind):
    if kind == "fixed":
        return lambda measured, batch_no: SERVICE
    # a per-batch cost that varies with the engine's batch number
    return lambda measured, batch_no: SERVICE * (1 + (batch_no % 3)) / 2


PARITY_CASES = {
    "least_loaded": (dict(), dict(), 24),
    "round_robin": (dict(route="round_robin"), dict(), 24),
    "death": (dict(), dict(die=((1, 2),)), 24),
    "death_max_failures_1": (dict(max_failures=1), dict(die=((0, 1),)), 16),
    "timeouts": (dict(timeout_s=2 * SERVICE, max_retries=2),
                 dict(slow_from=((0, 1, 5 * SERVICE),)), 16),
    "retries_exhausted": (dict(timeout_s=2 * SERVICE, max_retries=1),
                          dict(slow_from=tuple((r, 1, 5 * SERVICE) for r in range(3))), 12),
    "hedge_fixed": (dict(route="round_robin", hedge_after_s=2 * SERVICE),
                    dict(slow_from=((0, 1, 5 * SERVICE),)), 16),
    "hedge_quantile": (dict(hedge_quantile=90.0, hedge_min_obs=4),
                       dict(slow_from=((2, 3, 3 * SERVICE),)), 40),
    "flaky_probes": (dict(max_failures=2, health_every=2),
                     dict(flaky_probe_at=((1, 1), (1, 2), (2, 3))), 32),
    "probe_death_readmit": (dict(max_failures=1, health_every=1),
                            dict(flaky_probe_at=((1, 1),)), 40),
    "revive": (dict(max_failures=1, health_every=1),
               dict(die=((1, 1),), revive_at=((1, 6),)), 60),
    "outage": (dict(max_failures=1, health_every=0), dict(die=((0, 1), (1, 1), (2, 1))), 8),
    "chaos_mix": (dict(route="round_robin", timeout_s=3 * SERVICE, hedge_after_s=1.5 * SERVICE,
                       max_failures=1, health_every=3),
                  dict(die=((2, 3),), slow_from=((0, 4, 4 * SERVICE),),
                       flaky_probe_at=((1, 2),), revive_at=((2, 5),)), 48),
}


def _record_tuple(r):
    return (r.rid, r.arrival, r.launch, r.finish, r.replica, r.attempts, r.hedged,
            r.deadline_missed, r.result)


@pytest.mark.parametrize("service", ["fixed", "by_batch"])
@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_event_trace_equals_the_reference(case, service):
    policy_kw, plan_kw, n = PARITY_CASES[case]
    runs = []
    for mod, faults in ((jserve, jfaults), (None, None)):
        dispatcher_cls = mod.Dispatcher if mod else Dispatcher
        policy_cls = mod.DispatchPolicy if mod else DispatchPolicy
        coalesce_cls = mod.CoalescePolicy if mod else CoalescePolicy
        plan_cls = faults.ReplicaFaultPlan if faults else ReplicaFaultPlan
        disp = dispatcher_cls(
            [FakeRoute() for _ in range(3)],
            coalesce_cls(max_batch=4, max_wait_s=0.002),
            policy_cls(**policy_kw),
            fault_plan=plan_cls(**plan_kw),
            service_model=_service(service),
        )
        # two drains: the second continues the same virtual timeline
        for i in range(n):
            disp.submit(i, i * 0.001)
        first = disp.drain()
        for i in range(n, n + 6):
            disp.submit(i, 1.0 + i * 0.0005)
        second = disp.drain()
        runs.append(dict(
            trace=disp.event_trace(),
            records=[_record_tuple(r) for r in disp.records],
            unanswered=[(r.rid, r.payload, r.arrival) for r in disp.unanswered],
            drains=(len(first), len(first.unanswered), len(second), len(second.unanswered)),
            totals={k: disp.bus.total(k) for k in SERVE_CLUSTER_COUNTER_KEYS},
            per_replica=disp.per_replica(),
            occupancy=disp.occupancy(),
            hedge_delay=disp._hedge_delay(),
        ))
    ref, port = runs
    assert port["trace"] == ref["trace"]
    assert port == ref
    assert port["trace"], "the drill made no decision"


# ---------------------------------------------------------------------------
# the real thing: 3 sasrec replicas, scripted kill
# ---------------------------------------------------------------------------

def test_real_route_cluster_kill_drill():
    cfg = get_arch("sasrec").SMOKE_CONFIG
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    routes = [RecsysMIPSRoute(cfg, params, k=5, device="cpu") for _ in range(3)]
    disp = Dispatcher(
        routes,
        CoalescePolicy(max_batch=4, max_wait_s=0.002),
        DispatchPolicy(max_failures=1),
        fault_plan=ReplicaFaultPlan(die=((1, 2),)),
        service_model=lambda measured, batch_no: 0.005,
    )
    disp.warmup()
    for i in range(20):
        disp.submit(rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32),
                    i * 0.001)
    res = disp.drain()
    assert len(res) == 20 and not res.unanswered
    assert disp.bus.total("serve_replica_deaths") == 1
    # answers are real top-k payloads from the surviving replicas
    ids, scores = res[0].result
    assert len(ids) == 5
    assert all(r.replica != 1 or r.finish < 0.1 for r in res)


def test_real_route_kill_drill_matches_the_reference(monkeypatch):
    """SASRec SMOKE_CONFIG, 3 replicas, replica 1 dies at its 2nd
    dispatch: the port's dispatcher over its routes (the reference's
    weights and index carried across) and the reference's give the same
    event trace and records; answers: ids equal as sets, scores within
    rtol 1e-5 / atol 1e-6. The reference's three replicas share one
    route object (one compile; a query leaves a route unchanged)."""
    jcfg, cfg = jax_get_arch("sasrec").SMOKE_CONFIG, get_arch("sasrec").SMOKE_CONFIG
    jparams = jax_recsys.init_params(jcfg, jax.random.PRNGKey(0))
    jroute = jserve.RecsysMIPSRoute(jcfg, jparams, k=5)
    state = jroute.planner.index_state
    index = ivf_index_from_numpy(
        np.asarray(state.centroids), np.asarray(state.lists),
        np.asarray(state.list_embs), jcfg.item_vocab,
    )
    monkeypatch.setattr(planner_mod, "build_ivf", lambda *a, **kw: index)
    params = recsys_params_from_numpy(jax.tree.map(np.asarray, jparams))
    routes = [RecsysMIPSRoute(cfg, params, k=5, device="cpu") for _ in range(3)]
    rng = np.random.default_rng(4)
    payloads = [rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32)
                for _ in range(20)]
    fixed = lambda measured, batch_no: 0.005  # noqa: E731
    out = []
    for disp in (
        jserve.Dispatcher([jroute] * 3, jserve.CoalescePolicy(max_batch=4, max_wait_s=0.002),
                          jserve.DispatchPolicy(max_failures=1),
                          fault_plan=jfaults.ReplicaFaultPlan(die=((1, 2),)),
                          service_model=fixed),
        Dispatcher(routes, CoalescePolicy(max_batch=4, max_wait_s=0.002),
                   DispatchPolicy(max_failures=1),
                   fault_plan=ReplicaFaultPlan(die=((1, 2),)), service_model=fixed),
    ):
        disp.warmup()
        for i, p in enumerate(payloads):
            disp.submit(p, i * 0.001)
        res = disp.drain()
        assert len(res) == 20 and not res.unanswered
        assert disp.bus.total("serve_replica_deaths") == 1
        out.append((disp.event_trace(), res))
    (jtrace, jres), (trace, res) = out
    assert trace == jtrace
    for r, jr in zip(res, jres):
        assert _record_tuple(r)[:-1] == _record_tuple(jr)[:-1]
        (ids, scores), (jids, jscores) = r.result, jr.result
        np.testing.assert_array_equal(np.sort(ids), np.sort(np.asarray(jids)))
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-5, atol=1e-6)
