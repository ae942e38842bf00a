"""The port's ExecutionPlan, coalescer and engine failure path, on the
CPU.

The plan resolves the reference's ivf_pallas + index_refresh route and
its exact fallback, and the training knobs (the retrievers, the fused
sampler and the fused surrogate); the multi-device knobs resolve
(`tests/test_torch_sharded.py` drives them on a world of one), and
invalid values raise ValueError as in the reference. The coalescer is a copy of the
reference's and is pinned to it on random arrival streams.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import CoalescePolicy as JaxCoalescePolicy  # noqa: E402
from repro.serve import next_batch as jax_next_batch  # noqa: E402
from repro_torch.core import ExecutionPlan, FOPOConfig, SoftmaxPolicy  # noqa: E402
from repro_torch.health.faults import ReplicaFailure  # noqa: E402
from repro_torch.mips import ivf  # noqa: E402
from repro_torch.mips.refresh import RefreshConfig  # noqa: E402
from repro_torch.obs.trace import Tracer, tracing  # noqa: E402
from repro_torch.serve import CoalescePolicy, ServingEngine, next_batch  # noqa: E402


def _index(p=64, l=8, c=4):
    rng = np.random.default_rng(0)
    items = torch.from_numpy(rng.standard_normal((p, l)).astype(np.float32))
    return items, ivf.build_ivf(items, num_clusters=c, device="cpu")


def _cfg(**kw):
    base = dict(
        num_items=64, num_samples=1, top_k=5, retriever="ivf_pallas",
        index_refresh=RefreshConfig(every=0, compact_every=0, delta_cap=4),
    )
    base.update(kw)
    return FOPOConfig(**base)


def test_resolve_serving_route_and_fallback():
    items, index = _index()
    plan = ExecutionPlan.resolve(_cfg(), retriever_kwargs={"index": index, "n_probe": 4})
    assert plan.initial_index_state.delta_cap == 4
    h = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 8)).astype(np.float32))
    policy = SoftmaxPolicy(tower=lambda p, x: x, item_dim=8)
    tracer = Tracer()
    with tracing(tracer):
        got = plan.execute_query(policy, None, h, items)
    assert [e["name"] for e in tracer.events] == ["user_embedding", "retrieval"]
    exact = torch.topk(h @ items.T, 5).indices
    # n_probe == C: the IVF route sees the whole catalog
    np.testing.assert_array_equal(
        np.sort(got.indices.numpy(), -1), np.sort(exact.int().numpy(), -1)
    )
    fb = plan.degrade_to_fallback()
    assert fb.degraded and not plan.degraded and fb.degrade_to_fallback() is fb
    np.testing.assert_array_equal(
        fb.execute_query(policy, None, h, items).indices.numpy(), exact.int().numpy()
    )


def test_top_k_is_clamped_to_the_catalog():
    _, index = _index()
    plan = ExecutionPlan.resolve(_cfg(top_k=500), retriever_kwargs={"index": index})
    assert plan.cfg.top_k == 64


@pytest.mark.parametrize(
    "kw,retriever,fused_sampler,fused",
    [
        (dict(retriever="exact", index_refresh=None), "exact", False, False),
        (dict(retriever="pallas", index_refresh=None), "pallas", False, False),
        (dict(index_refresh=None), "ivf_pallas", False, False),
        (dict(fused=True), "ivf_pallas", False, True),
        (dict(fused_sampler=True), "ivf_pallas", True, False),
    ],
)
def test_training_knobs_resolve(kw, retriever, fused_sampler, fused):
    """Each knob set resolves: the plan says which retriever, sampler and
    surrogate run, and its retriever answers a query; a kernel knob
    writes fused_interpret back, as the reference does."""
    items, index = _index()
    plan = ExecutionPlan.resolve(_cfg(**kw), retriever_kwargs={"index": index, "n_probe": 4})
    assert (plan.cfg.retriever, plan.fused_sampler, plan.fused) == (retriever, fused_sampler, fused)
    assert (plan.refresh is not None) == ("index_refresh" not in kw)
    assert plan.cfg.fused_interpret == (False if fused or fused_sampler else None)
    h = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 8)).astype(np.float32))
    got = plan.retrieve(h, items)
    exact = torch.topk(h @ items.T, 5).indices
    np.testing.assert_array_equal(
        np.sort(got.indices.numpy(), -1), np.sort(exact.int().numpy(), -1)
    )


@pytest.mark.parametrize(
    "kw,match",
    [
        # the dist slice has landed: a dist= that is no DistConfig, and the
        # sharded retriever without its process group, are config errors
        pytest.param(dict(dist=object()), "DistConfig", id="kw0-dist slice"),
        pytest.param(dict(retriever="sharded", index_refresh=None), '"group"',
                     id="kw1-dist slice"),
    ],
)
def test_later_slices_raise_not_implemented(kw, match):
    _, index = _index()
    with pytest.raises(ValueError, match=match):
        ExecutionPlan.resolve(_cfg(**kw), retriever_kwargs={"index": index})


@pytest.mark.parametrize(
    "kw,kwargs,match",
    [
        (dict(num_items=0), None, "num_items"),
        (dict(num_samples=0), None, "num_samples"),
        (dict(top_k=0), None, "top_k"),
        (dict(epsilon=1.5), None, "epsilon"),
        (dict(retriever="ivff"), None, "unknown retriever"),
        ({}, {}, "prebuilt index"),
        ({}, {"index": "not an index"}, "IVFIndex"),
        (dict(index_refresh="x"), None, "RefreshConfig"),
        (dict(index_refresh=RefreshConfig(every=-1)), None, "every"),
        (dict(index_refresh=RefreshConfig(every=1, minibatch=0)), None, "minibatch"),
        (dict(index_refresh=RefreshConfig(delta_cap=0)), None, "delta_cap"),
        (dict(index_refresh=RefreshConfig(count_decay=0.0)), None, "count_decay"),
        (dict(retriever="ivf", index_refresh=None), {}, "prebuilt index"),
        (dict(retriever="exact"), None, "requires retriever='ivf_pallas'"),
    ],
)
def test_invalid_knobs_raise_value_error(kw, kwargs, match):
    _, index = _index()
    with pytest.raises(ValueError, match=match):
        ExecutionPlan.resolve(
            _cfg(**kw), retriever_kwargs={"index": index} if kwargs is None else kwargs
        )


@pytest.mark.parametrize("seed", range(6))
def test_next_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    mb, wait = int(rng.integers(1, 6)), float(rng.choice([0.0, 0.001, 0.01]))
    arrivals = np.cumsum(rng.exponential(0.002, 20)).tolist()
    free_at = 0.0
    pol, jpol = CoalescePolicy(mb, wait), JaxCoalescePolicy(mb, wait)
    while arrivals:
        got = next_batch(arrivals, free_at, pol)
        assert got == jax_next_batch(arrivals, free_at, jpol)
        arrivals = arrivals[got[0]:]
        free_at = got[1] + float(rng.exponential(0.003))


class _FailingRoute:
    device = "cpu"
    pad_payload = np.zeros(2)

    def prepare(self, payloads):
        return payloads

    def run(self, batch):
        raise ReplicaFailure("replica down")


def test_replica_failure_abandons_every_queued_request():
    eng = ServingEngine(_FailingRoute(), CoalescePolicy(max_batch=2))
    for i in range(5):
        eng.submit(np.zeros(2), float(i))
    res = eng.drain()
    assert len(res) == 0 and isinstance(res.failure, ReplicaFailure)
    assert sorted(r.rid for r in res.abandoned) == list(range(5))
    # the failed batch is the first request alone (the next one arrives
    # after the wait cap); the rest are abandoned unserved
    assert eng.free_at == 0.0 and eng.bus.total("serve_abandoned") == 1
