"""The serving slice as a whole: the port's `ServingEngine` over its
`RecsysMIPSRoute` against the JAX reference's, at SMOKE_CONFIG, on the
CPU.

Both routes get the same SASRec weights (carried across by
`repro_torch.convert`) and the same IVF index: the port's planner is
handed the reference's index through a monkeypatched `build_ivf`,
because the two packages seed k-means from different RNGs. Both engines
take the same payloads with a fixed `service_model`, so their virtual
timelines must agree bitwise; retrieved ids agree as sorted sets and
scores within 1e-5 (fp32 sums taken in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro.serve import CoalescePolicy as JaxCoalescePolicy  # noqa: E402
from repro.serve import RecsysMIPSRoute as JaxRoute  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import ivf_index_from_numpy, sasrec_params_from_numpy  # noqa: E402
from repro_torch.kernels.ivf_topk import kernel as ivf_kernel  # noqa: E402
from repro_torch.kernels.ivf_topk import ref as ivf_ref  # noqa: E402
from repro_torch.mips.exact import topk_exact  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.serve import CoalescePolicy, RecsysMIPSRoute, ServingEngine  # noqa: E402
from repro_torch.serve import planner as planner_mod  # noqa: E402

CFG = get_arch("sasrec").SMOKE_CONFIG
JCFG = jax_get_arch("sasrec").SMOKE_CONFIG


def _hists(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [
        rng.integers(-1, CFG.item_vocab, (CFG.seq_len,)).astype(np.int32)
        for _ in range(n)
    ]


def _run_all(engine, payloads, arrivals):
    for p, a in zip(payloads, arrivals):
        engine.submit(p, a)
    return engine.drain()


def _port_route(k: int, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return RecsysMIPSRoute(CFG, recsys.init_params(CFG, gen, "cpu"), k=k, device="cpu")


@pytest.mark.parametrize("max_batch,k", [(4, 8), (3, 10)])
def test_engine_matches_reference_engine(monkeypatch, max_batch, k):
    jparams = jax_recsys.init_params(JCFG, jax.random.PRNGKey(0))
    jroute = JaxRoute(JCFG, jparams, k=k)
    state = jroute.planner.index_state
    index = ivf_index_from_numpy(
        np.asarray(state.centroids), np.asarray(state.lists),
        np.asarray(state.list_embs), JCFG.item_vocab,
    )
    monkeypatch.setattr(planner_mod, "build_ivf", lambda *a, **kw: index)
    route = RecsysMIPSRoute(
        CFG, sasrec_params_from_numpy(jax.tree.map(np.asarray, jparams)), k=k,
        device="cpu",
    )
    payloads = _hists(11)
    arrivals = [0.0007 * i for i in range(11)]
    fixed = lambda measured, batch_no: 0.001  # noqa: E731
    jeng = JaxEngine(
        jroute, JaxCoalescePolicy(max_batch=max_batch, max_wait_s=0.0015),
        service_model=fixed,
    )
    eng = ServingEngine(
        route, CoalescePolicy(max_batch=max_batch, max_wait_s=0.0015),
        service_model=fixed,
    )
    jeng.warmup()
    eng.warmup()
    jrecs = _run_all(jeng, payloads, arrivals)
    recs = _run_all(eng, payloads, arrivals)
    assert len(recs) == len(jrecs) == 11
    assert eng.batches == jeng.batches
    for r, jr in zip(recs, jrecs):
        assert (r.rid, r.arrival, r.launch, r.finish, r.batch_size) == (
            jr.rid, jr.arrival, jr.launch, jr.finish, jr.batch_size
        )
        ids, scores = r.result
        jids, jscores = jr.result
        np.testing.assert_array_equal(np.sort(ids), np.sort(np.asarray(jids)))
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-5, atol=1e-5)


def test_batched_matches_sequential():
    payloads = _hists(10)
    results = {}
    for mb in (1, 4):
        eng = ServingEngine(
            _port_route(k=8), CoalescePolicy(max_batch=mb, max_wait_s=0.001)
        )
        eng.warmup()
        recs = _run_all(eng, payloads, [0.0] * len(payloads))
        assert [r.rid for r in recs] == list(range(10))  # FIFO answers
        results[mb] = [r.result[0] for r in recs]
    for seq_ids, bat_ids in zip(results[1], results[4]):
        np.testing.assert_array_equal(np.sort(seq_ids), np.sort(bat_ids))


def test_engine_records_and_occupancy():
    eng = ServingEngine(_port_route(k=4), CoalescePolicy(max_batch=4, max_wait_s=0.5))
    eng.warmup()
    recs = _run_all(eng, _hists(8), [0.0] * 8)
    assert len(recs) == 8 and eng.batches == 2
    assert eng.occupancy() == pytest.approx(4.0)
    for r in recs:
        assert r.finish >= r.launch >= r.arrival
        assert r.latency >= r.queue_wait >= 0.0
    # the second batch launches only after the first frees the engine
    assert recs[4].launch >= recs[0].finish
    assert eng.bus.total("serve_requests") == 8


def test_degrade_swaps_to_exact_fallback():
    route = _port_route(k=6)
    eng = ServingEngine(route, CoalescePolicy(max_batch=4, max_wait_s=0.001))
    eng.warmup()
    payloads = _hists(4, seed=5)
    plain_before = ivf_ref.ivf_probe_topk_ref.calls
    before = _run_all(eng, payloads, [0.0] * 4)
    assert ivf_ref.ivf_probe_topk_ref.calls == plain_before + 2  # main + delta
    assert not route.degraded
    route.degrade()
    route.degrade()  # idempotent
    assert route.degraded
    plain_before = ivf_ref.ivf_probe_topk_ref.calls
    after = _run_all(eng, payloads, [eng.free_at] * 4)
    assert ivf_ref.ivf_probe_topk_ref.calls == plain_before  # IVF path not run
    planner = route.planner
    with torch.inference_mode():
        h = recsys.sasrec_user_vector(
            CFG, planner.params, torch.from_numpy(np.stack(payloads))
        )
        exact = topk_exact(h, planner.beta, 6)
    for i, rec in enumerate(after):
        np.testing.assert_array_equal(rec.result[0], exact.indices[i].numpy())
    assert len(before) == len(after) == 4


def test_serve_on_cpu_never_launches_the_kernel():
    before = ivf_kernel.ivf_probe_topk_cuda.launches
    eng = ServingEngine(_port_route(k=4), CoalescePolicy(max_batch=2))
    eng.warmup()
    _run_all(eng, _hists(3), [0.0] * 3)
    assert ivf_kernel.ivf_probe_topk_cuda.launches == before
