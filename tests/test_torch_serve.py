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
from repro_torch.convert import ivf_index_from_numpy, recsys_params_from_numpy  # noqa: E402
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
        CFG, recsys_params_from_numpy(jax.tree.map(np.asarray, jparams)), k=k,
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


# ---------------------------------------------------------------------------
# the LM generation route (Gemma-2 SMOKE_CONFIG)
# ---------------------------------------------------------------------------


def _lm_routes(monkeypatch, flash: bool, max_batch: int, prompt_len: int, gen_len: int):
    """The reference's and the port's LMGenerateRoute over the same
    weights and the same IVF index (the reference's, carried across)."""
    import dataclasses

    from repro.models import lm as jax_lm
    from repro.serve import LMGenerateRoute as JaxLMRoute
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.serve import LMGenerateRoute

    jcfg = dataclasses.replace(jax_get_arch("gemma2-2b").SMOKE_CONFIG, use_flash_kernel=flash)
    cfg = dataclasses.replace(get_arch("gemma2-2b").SMOKE_CONFIG, use_flash_kernel=flash)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    jroute = JaxLMRoute(jcfg, jparams, prompt_len=prompt_len, gen_len=gen_len,
                        max_batch=max_batch, top_k=4)
    state = jroute.planner.index_state
    index = ivf_index_from_numpy(
        np.asarray(state.centroids), np.asarray(state.lists),
        np.asarray(state.list_embs), jcfg.vocab_size,
    )
    monkeypatch.setattr(planner_mod, "build_ivf", lambda *a, **kw: index)
    route = LMGenerateRoute(
        cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jparams)), prompt_len=prompt_len,
        gen_len=gen_len, max_batch=max_batch, top_k=4, device="cpu",
    )
    return cfg, jroute, route


@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "kernel"])
def test_lm_route_generates_the_reference_tokens(monkeypatch, flash):
    """Both engines serve the same 3 prompts (max_batch 2, fixed service
    time): the same virtual timeline and the same generated tokens."""
    cfg, jroute, route = _lm_routes(monkeypatch, flash, max_batch=2, prompt_len=6, gen_len=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (6,)).astype(np.int32) for _ in range(3)]
    fixed = lambda measured, batch_no: 0.001  # noqa: E731
    jeng = JaxEngine(jroute, JaxCoalescePolicy(max_batch=2, max_wait_s=0.01),
                     service_model=fixed)
    eng = ServingEngine(route, CoalescePolicy(max_batch=2, max_wait_s=0.01),
                        service_model=fixed)
    jeng.warmup()
    eng.warmup()
    jrecs = _run_all(jeng, prompts, [0.0] * 3)
    recs = _run_all(eng, prompts, [0.0] * 3)
    assert len(recs) == len(jrecs) == 3
    for r, jr in zip(recs, jrecs):
        assert (r.rid, r.launch, r.finish, r.batch_size) == (
            jr.rid, jr.launch, jr.finish, jr.batch_size
        )
        assert len(r.result) == 4 and all(0 <= t < cfg.vocab_size for t in r.result)
        assert r.result == list(jr.result)


def test_lm_route_on_cpu_runs_the_plain_versions():
    """The kernel switch on, CPU tensors: every prefill runs the flash
    plain version once per layer, every token one IVF pass (main +
    delta), and no kernel launches."""
    import dataclasses

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import lm
    from repro_torch.serve import LMGenerateRoute

    cfg = dataclasses.replace(get_arch("gemma2-2b").SMOKE_CONFIG, use_flash_kernel=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    route = LMGenerateRoute(cfg, params, prompt_len=5, gen_len=3, max_batch=2, device="cpu")
    eng = ServingEngine(route, CoalescePolicy(max_batch=2))
    eng.warmup()
    before = (flash_ref.flash_attention_ref.calls, ivf_ref.ivf_probe_topk_ref.calls,
              flash_kernel.flash_attention_fwd_cuda.launches,
              ivf_kernel.ivf_probe_topk_cuda.launches)
    rng = np.random.default_rng(1)
    recs = _run_all(eng, [rng.integers(0, 512, (5,)).astype(np.int32) for _ in range(4)],
                    [0.0] * 4)
    assert len(recs) == 4 and eng.batches == 2
    after = (flash_ref.flash_attention_ref.calls, ivf_ref.ivf_probe_topk_ref.calls,
             flash_kernel.flash_attention_fwd_cuda.launches,
             ivf_kernel.ivf_probe_topk_cuda.launches)
    assert after[0] - before[0] == 2 * cfg.num_layers
    assert after[1] - before[1] == 2 * 2 * 3
    assert after[2:] == before[2:]


def test_serve_cli_gemma_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli

    serve_cli.main(["--arch", "gemma2-2b", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "6", "--gen-len", "3", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "gemma2-2b on cpu: 3 requests in 2 batches" in out


# ---------------------------------------------------------------------------
# DIEN through the MIPS route, DIN and Wide&Deep through the dense-candidate
# route (SMOKE_CONFIGs)
# ---------------------------------------------------------------------------


def _recsys_payloads(cfg, n: int, seed: int) -> list:
    """The serving CLI's payloads for ``cfg.kind``."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "wide_deep":
        return [(rng.integers(0, 10**6, (cfg.n_sparse,)).astype(np.int32),
                 rng.normal(size=(cfg.n_dense,)).astype(np.float32)) for _ in range(n)]
    return [rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32)
            for _ in range(n)]


def _recsys_routes(monkeypatch, arch: str, k: int):
    """The reference's and the port's route for ``arch`` over the same
    weights (and, for DIEN, the reference's IVF index carried across)."""
    from repro.serve import DenseCandidateRoute as JaxDenseRoute
    from repro_torch.serve import DenseCandidateRoute

    jcfg, cfg = jax_get_arch(arch).SMOKE_CONFIG, get_arch(arch).SMOKE_CONFIG
    jparams = jax_recsys.init_params(jcfg, jax.random.PRNGKey(0))
    params = recsys_params_from_numpy(jax.tree.map(np.asarray, jparams))
    if arch == "dien":
        jroute = JaxRoute(jcfg, jparams, k=k)
        state = jroute.planner.index_state
        index = ivf_index_from_numpy(
            np.asarray(state.centroids), np.asarray(state.lists),
            np.asarray(state.list_embs), jcfg.item_vocab,
        )
        monkeypatch.setattr(planner_mod, "build_ivf", lambda *a, **kw: index)
        return cfg, jroute, RecsysMIPSRoute(cfg, params, k=k, device="cpu")
    cands = np.arange(500, dtype=np.int32)
    return (cfg, JaxDenseRoute(jcfg, jparams, candidates=cands, k=k),
            DenseCandidateRoute(cfg, params, candidates=cands, k=k, device="cpu"))


@pytest.mark.parametrize("arch", ["dien", "din", "wide-deep"])
def test_recsys_routes_match_reference_engine(monkeypatch, arch):
    """Both engines serve the same 7 payloads (max_batch 3, fixed service
    time): the same virtual timeline, ids equal as sets and scores within
    rtol 1e-5 / atol 1e-6 (fp32 sums taken in another order)."""
    cfg, jroute, route = _recsys_routes(monkeypatch, arch, k=8)
    payloads = _recsys_payloads(cfg, 7, seed=3)
    fixed = lambda measured, batch_no: 0.001  # noqa: E731
    jeng = JaxEngine(jroute, JaxCoalescePolicy(max_batch=3, max_wait_s=0.002),
                     service_model=fixed)
    eng = ServingEngine(route, CoalescePolicy(max_batch=3, max_wait_s=0.002),
                        service_model=fixed)
    jeng.warmup()
    eng.warmup()
    arrivals = [0.0005 * i for i in range(7)]
    jrecs = _run_all(jeng, payloads, arrivals)
    recs = _run_all(eng, payloads, arrivals)
    assert len(recs) == len(jrecs) == 7 and eng.batches == jeng.batches
    for r, jr in zip(recs, jrecs):
        assert (r.rid, r.launch, r.finish, r.batch_size) == (
            jr.rid, jr.launch, jr.finish, jr.batch_size
        )
        (ids, scores), (jids, jscores) = r.result, jr.result
        assert ids.shape == scores.shape == (8,)
        np.testing.assert_array_equal(np.sort(ids), np.sort(np.asarray(jids)))
        np.testing.assert_allclose(np.sort(scores), np.sort(np.asarray(jscores)),
                                   rtol=1e-5, atol=1e-6)


def test_dense_route_refuses_mips_archs_and_mips_route_refuses_dense_ones():
    from repro_torch.serve import DenseCandidateRoute

    for arch, route_cls in (("dien", DenseCandidateRoute), ("din", RecsysMIPSRoute)):
        cfg = get_arch(arch).SMOKE_CONFIG
        params = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="Route"):
            if route_cls is DenseCandidateRoute:
                route_cls(cfg, params, candidates=np.arange(5), device="cpu")
            else:
                route_cls(cfg, params, device="cpu")


@pytest.mark.parametrize("arch", ["din", "dien", "wide-deep"])
def test_serve_cli_recsys_on_cpu(capsys, arch):
    from repro_torch.launch import serve as serve_cli

    serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "5", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert f"{arch} on cpu: 5 requests in 3 batches" in out


def test_route_and_planner_knobs_mirror_the_reference(monkeypatch):
    """`RecsysMIPSRoute` and `QueryPlanner` take the reference's knobs
    (the same names and defaults; the port adds ``device``), and pass
    them through: ``num_clusters=64`` builds 64 lists, ``delta_cap=16``
    gives each 16 delta slots and ``rebuild_iters=2`` runs the ladder's
    rebuild rung with 2 Lloyd iterations (the reference's build, delta
    buffers and rung take the same knobs)."""
    import inspect

    from repro.serve import QueryPlanner as JaxPlanner
    from repro_torch.mips import refresh as refresh_ops
    from repro_torch.serve import QueryPlanner

    for port_cls, ref_cls in ((RecsysMIPSRoute, JaxRoute), (QueryPlanner, JaxPlanner)):
        got = {k: v.default for k, v in inspect.signature(port_cls).parameters.items()
               if k != "device"}
        want = {k: v.default for k, v in inspect.signature(ref_cls).parameters.items()}
        assert got == want, port_cls.__name__
    params = recsys.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    route = RecsysMIPSRoute(CFG, params, k=4, num_clusters=64, rebuild_iters=2, device="cpu")
    state = route.planner.index_state
    assert state.lists.shape[0] == 64 and state.delta_cap == 8
    seen = []
    real_rebuild = refresh_ops.rebuild
    monkeypatch.setattr(refresh_ops, "rebuild",
                        lambda st, beta, iters: seen.append(iters) or real_rebuild(st, beta,
                                                                                   iters=iters))
    route.heal("rebuild")
    assert seen == [2] and route.planner.index_state.lists.shape[0] == 64
    planner = QueryPlanner(route.planner.policy, route.planner.params,
                           route.planner.beta, top_k=4, num_clusters=16, delta_cap=16,
                           device="cpu")
    assert planner.index_state.delta_cap == 16 and planner.index_state.lists.shape[0] == 16
