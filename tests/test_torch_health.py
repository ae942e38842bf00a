"""The port's health layer (`repro_torch.health`) against the reference's
(`repro.health`), on the CPU: config validation, the verdict bitmask and
the guard's bookkeeping on the same scalars, the guard's bitwise no-op,
skip, spike, ESS collapse and rollback drills on the port's trainer, the
ladder monitor, the ladder on the trainer's maintained index, and the
fault drill on the port's serving engine.

Tolerances: verdicts and guard counters exact; the grad-norm EMA rtol
1e-6; the no-op and skip guarantees bitwise (`torch.equal`).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import health as jh  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro.serve import CoalescePolicy as JaxCoalescePolicy  # noqa: E402
from repro.serve import RecsysMIPSRoute as JaxRoute  # noqa: E402
from repro.serve import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import health as th  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import recsys_params_from_numpy  # noqa: E402
from repro_torch.core import FOPOConfig  # noqa: E402
from repro_torch.data import SyntheticConfig, generate_sessions  # noqa: E402
from repro_torch.mips.exact import topk_exact  # noqa: E402
from repro_torch.mips.ivf import build_ivf  # noqa: E402
from repro_torch.mips.refresh import RefreshConfig, sampled_recall  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.serve import CoalescePolicy, RecsysMIPSRoute, ServingEngine  # noqa: E402
from repro_torch.train import FOPOTrainer, TrainerConfig  # noqa: E402


@pytest.fixture(scope="module")
def ds():
    full = generate_sessions(SyntheticConfig(
        num_items=300, num_users=200, embed_dim=16, session_len=8, seed=0
    ))
    return full.split(0.85, seed=0)[0]


def make_trainer(ds, health=None, fault=None, *, steps=6, seed=0, ckpt_dir=None,
                 ckpt_every=0, retriever="exact", grad_clip=0.0, fused=False, **fopo_kw):
    fopo = FOPOConfig(num_items=300, num_samples=32, top_k=16, epsilon=0.8,
                      retriever=retriever, fused=fused, **fopo_kw)
    tc = TrainerConfig(estimator="fopo", fopo=fopo, batch_size=8, learning_rate=3e-3,
                       num_steps=steps, grad_clip=grad_clip, checkpoint_dir=ckpt_dir,
                       checkpoint_every=ckpt_every, seed=seed, health=health)
    return FOPOTrainer(tc, ds, fault_plan=fault, device="cpu")


def make_refresh_trainer(ds, health=None, fault=None, *, steps=6, ckpt_dir=None,
                         ckpt_every=0, every=2, compact_every=0, cap=128):
    index = build_ivf(torch.from_numpy(ds.item_embeddings), num_clusters=8, cap=cap,
                      kmeans_iters=3, cap_tile=32, seed=1, device="cpu")
    fopo = FOPOConfig(num_items=300, num_samples=32, top_k=16, epsilon=0.8,
                      retriever="ivf_pallas", index_refresh=RefreshConfig(
                          every=every, minibatch=64, compact_every=compact_every,
                          delta_cap=16))
    tc = TrainerConfig(estimator="fopo", fopo=fopo, batch_size=8, learning_rate=3e-3,
                       num_steps=steps, checkpoint_dir=ckpt_dir,
                       checkpoint_every=ckpt_every, seed=0, health=health)
    return FOPOTrainer(tc, ds, retriever_kwargs={"index": index, "n_probe": 4, "cap_tile": 32},
                       fault_plan=fault, device="cpu")


def assert_tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- config validation, the verdict and the guard state -----------------------------

HEALTH_BAD = [
    {"ess_floor": -1.0}, {"max_wbar_ceiling": 0.0}, {"max_wbar_ceiling": 1.5},
    {"grad_spike_factor": 0.5}, {"ema_decay": 1.0}, {"max_consecutive_bad": 0},
    {"snapshot_every": 0}, {"save_retries": -1},
]
INDEX_BAD = [
    {"probe_every": -1}, {"probe_rows": 0}, {"probe_k": 0}, {"recall_floor": 1.5},
    {"recall_floor": -0.1}, {"overflow_budget": -1}, {"cooldown": -1},
    {"rebuild_iters": 0},
]


@pytest.mark.parametrize("kw", HEALTH_BAD)
def test_health_config_validation(kw):
    with pytest.raises(ValueError):
        th.HealthConfig(**kw)
    with pytest.raises(ValueError):
        jh.HealthConfig(**kw)


@pytest.mark.parametrize("kw", INDEX_BAD)
def test_index_health_config_validation(kw):
    with pytest.raises(ValueError):
        th.IndexHealthConfig(**kw)
    with pytest.raises(ValueError):
        jh.IndexHealthConfig(**kw)


def test_configs_keep_the_reference_defaults():
    for port, ref in ((th.HealthConfig(), jh.HealthConfig()),
                      (th.IndexHealthConfig(), jh.IndexHealthConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert th.LADDER == jh.LADDER and th.KILL_EXIT_CODE == jh.KILL_EXIT_CODE
    np.testing.assert_array_equal(th.CLEAR_SIGNALS, jh.CLEAR_SIGNALS)


def test_decode_verdict():
    assert th.VERDICT_NAMES == jh.VERDICT_NAMES
    assert th.decode_verdict(0) == []
    assert th.decode_verdict(th.NONFINITE_LOSS) == ["nonfinite_loss"]
    assert set(th.decode_verdict(th.NONFINITE_GRADS | th.ESS_COLLAPSE)) == {
        "nonfinite_grads", "ess_collapse"}
    for v in range(32):
        assert th.decode_verdict(v) == jh.decode_verdict(v)
        assert th.verdict_record(3, v) == jh.guard.verdict_record(3, v)


# one case per bit: (cfg kwargs, loss, gnorm, aux, guard (ema, good steps), bit)
VERDICT_CASES = {
    "nonfinite_loss": ({}, np.nan, 1.0, {}, (0.0, 0), th.NONFINITE_LOSS),
    "nonfinite_grads": ({}, 1.0, np.inf, {}, (0.0, 0), th.NONFINITE_GRADS),
    "grad_spike": ({"grad_spike_factor": 10.0, "warmup_steps": 3}, 1.0, 100.0, {},
                   (1.0, 3), th.GRAD_SPIKE),
    "ess_collapse": ({"ess_floor": 2.0}, 1.0, 1.0, {"ess": 1.0, "max_wbar": 0.2},
                     (0.0, 0), th.ESS_COLLAPSE),
    "wbar_collapse": ({"max_wbar_ceiling": 0.9}, 1.0, 1.0, {"ess": 10.0, "max_wbar": 0.99},
                      (0.0, 0), th.WBAR_COLLAPSE),
}


@pytest.mark.parametrize("name", sorted(VERDICT_CASES))
def test_verdict_matches_reference_bit_by_bit(name):
    kw, loss, gnorm, aux, (ema, good), bit = VERDICT_CASES[name]
    cfg_t, cfg_j = th.HealthConfig(**kw), jh.HealthConfig(**kw)
    st_t = th.init_guard_state()._replace(grad_ema=torch.tensor(ema, dtype=torch.float32),
                                          good_steps=torch.tensor(good, dtype=torch.int32))
    st_j = jh.init_guard_state()._replace(grad_ema=jnp.float32(ema), good_steps=jnp.int32(good))

    def both(loss, gnorm, aux, st_t=st_t, st_j=st_j):
        vt = th.health_verdict(cfg_t, torch.tensor(loss, dtype=torch.float32),
                               torch.tensor(gnorm, dtype=torch.float32),
                               {k: torch.tensor(v, dtype=torch.float32) for k, v in aux.items()},
                               st_t)
        vj = jh.health_verdict(cfg_j, jnp.float32(loss), jnp.float32(gnorm),
                               {k: jnp.float32(v) for k, v in aux.items()}, st_j)
        assert vt.dtype == torch.int32 and vt.dim() == 0
        assert int(vt) == int(vj)
        return int(vt)

    assert both(loss, gnorm, aux) == bit
    assert both(1.0, 1.0, {}) == 0  # healthy
    if name == "grad_spike":  # quiet during warmup
        cold_t = st_t._replace(good_steps=torch.tensor(2, dtype=torch.int32))
        cold_j = st_j._replace(good_steps=jnp.int32(2))
        assert both(loss, gnorm, aux, cold_t, cold_j) == 0


def test_update_guard_state_matches_reference():
    cfg_t, cfg_j = th.HealthConfig(ema_decay=0.5), jh.HealthConfig(ema_decay=0.5)
    st_t, st_j = th.init_guard_state(), jh.init_guard_state()
    for verdict, gnorm in [(0, 4.0), (0, 8.0), (th.NONFINITE_GRADS, np.nan), (0, 6.0),
                           (th.GRAD_SPIKE, 1e5), (th.ESS_COLLAPSE, 3.0), (0, 2.0)]:
        st_t = th.update_guard_state(cfg_t, st_t, torch.tensor(verdict, dtype=torch.int32),
                                     torch.tensor(gnorm, dtype=torch.float32))
        st_j = jh.update_guard_state(cfg_j, st_j, jnp.int32(verdict), jnp.float32(gnorm))
        for f in ("good_steps", "consecutive_bad", "bad_total", "last_verdict"):
            assert int(getattr(st_t, f)) == int(getattr(st_j, f)), f
            assert getattr(st_t, f).dtype == torch.int32
        assert float(st_t.grad_ema) == pytest.approx(float(st_j.grad_ema), rel=1e-6)
    assert int(st_t.bad_total) == 3 and int(st_t.consecutive_bad) == 0


def test_guarded_update_refuses_dist_until_the_dist_slice():
    # the dist slice has landed: dist= must be a DistConfig (the agreement
    # itself runs on a gloo world in tests/test_torch_dist.py)
    with pytest.raises(ValueError, match="DistConfig"):
        th.guarded_update(th.HealthConfig(), th.init_guard_state(), torch.tensor(1.0),
                          torch.tensor(1.0), {}, {}, {}, lambda p, o: (p, o), dist=object())


# -- the no-op guarantee: guarded == unguarded, bitwise --------------------------------

def test_guarded_trainer_bitwise_noop(ds):
    h = th.HealthConfig(ess_floor=1.5, grad_spike_factor=100.0, max_wbar_ceiling=0.999)
    a, b = make_trainer(ds), make_trainer(ds, health=h)
    ha, hb = a.train(), b.train()
    assert ha["loss"] == hb["loss"] and hb["health"] == []
    assert_tree_equal(a.params, b.params)
    assert_tree_equal(a.opt_state, b.opt_state)


def test_guarded_trainer_bitwise_noop_with_clip_and_fused(ds):
    h = th.HealthConfig(ess_floor=1.5, grad_spike_factor=100.0)
    kw = dict(steps=3, grad_clip=5.0, fused=True, fused_sampler=True, sample_tile=8)
    a, b = make_trainer(ds, **kw), make_trainer(ds, health=h, **kw)
    a.train()
    b.train()
    assert_tree_equal(a.params, b.params)
    assert_tree_equal(a.opt_state, b.opt_state)


def test_armed_clear_fault_plan_is_bitwise_noop(ds):
    h = th.HealthConfig()
    a = make_trainer(ds, health=h, steps=4)
    b = make_trainer(ds, health=h, steps=4, fault=th.FaultPlan(nan_grads_at=(99,)))
    a.train(4)
    b.train(4)
    assert_tree_equal(a.params, b.params)
    assert_tree_equal(a.opt_state, b.opt_state)


# -- inject -> detect -> skip, spike, ESS, rollback -------------------------------------

def test_nan_grads_detected_and_step_skipped(ds):
    t = make_trainer(ds, health=th.HealthConfig(), steps=6,
                     fault=th.FaultPlan(nan_grads_at=(2,)))
    t.train(2)
    frozen = (dict(t.params), dict(t.opt_state))
    h = t.train(1)  # the faulted step
    assert len(h["health"]) == 1 and h["health"][0]["verdict"] & th.NONFINITE_GRADS
    assert "nonfinite_grads" in h["health"][0]["checks"]
    assert_tree_equal(frozen[0], t.params)  # the skip: bitwise unchanged
    assert_tree_equal(frozen[1], t.opt_state)  # Adam's step too
    t.train(3)
    assert int(t.guard_state.bad_total) == 1 and int(t.guard_state.consecutive_bad) == 0
    assert torch.isfinite(t.params["w"]).all()


def test_grad_spike_detected(ds):
    h = th.HealthConfig(grad_spike_factor=50.0, warmup_steps=2, max_consecutive_bad=10)
    t = make_trainer(ds, health=h, steps=6,
                     fault=th.FaultPlan(spike_grads_at=(4,), spike_factor=1e4))
    hist = t.train()
    assert len([e for e in hist["health"] if e["verdict"] & th.GRAD_SPIKE]) == 1
    assert torch.isfinite(t.params["w"]).all()


def test_ess_collapse_detected(ds):
    h = th.HealthConfig(ess_floor=1.5, max_consecutive_bad=10)
    t = make_trainer(ds, health=h, steps=5,
                     fault=th.FaultPlan(ess_collapse_at=(3,), ess_value=1.0))
    hist = t.train()
    assert len([e for e in hist["health"] if e["verdict"] & th.ESS_COLLAPSE]) == 1
    assert int(t.guard_state.bad_total) == 1


def test_rollback_after_consecutive_bad_steps(ds, capsys):
    h = th.HealthConfig(max_consecutive_bad=2, snapshot_every=1)
    t = make_trainer(ds, health=h, steps=10, fault=th.FaultPlan(nan_grads_at=(3, 4, 5)))
    hist = t.train(log_every=1)
    rollbacks = [e for e in hist["events"] if e["event"] == "rollback"]
    assert rollbacks == [{"step": 3, "event": "rollback", "to": 3, "restarts": 1}]
    assert t._restarts == 1 and int(t.guard_state.consecutive_bad) == 0
    assert torch.isfinite(t.params["w"]).all() and np.isfinite(hist["loss"][-1])
    out = capsys.readouterr().out
    assert "step 3: ROLLBACK to 3 (restart #1)" in out and "health=nonfinite_grads" in out


def test_rollback_resets_guard_and_reseeds(ds):
    h = th.HealthConfig(max_consecutive_bad=1, snapshot_every=1)
    t = make_trainer(ds, health=h, steps=6, fault=th.FaultPlan(nan_grads_at=(2,)))
    clean = make_trainer(ds, health=h, steps=6)
    hist, ref = t.train(), clean.train()
    assert [e["event"] for e in hist["events"]] == ["rollback"]
    assert int(t.guard_state.bad_total) == 0  # reset with the rollback
    # the replay of step 2 draws from the reseeded generator: after it the
    # two trainers' generators (and so their seeds) part
    assert not torch.equal(t._seed_gen.get_state(), clean._seed_gen.get_state())
    assert hist["loss"][:3] == ref["loss"][:3] and hist["loss"][3] != ref["loss"][2]


# -- the ladder monitor (plain Python, the reference's) ---------------------------------

def _monitors(**kw):
    return th.IndexHealthMonitor(th.IndexHealthConfig(**kw)), \
        jh.IndexHealthMonitor(jh.IndexHealthConfig(**kw))


@pytest.mark.parametrize("kw,observations", [
    (dict(probe_every=1, recall_floor=0.9, cooldown=0), [(0.5, 0)] * 4),
    (dict(probe_every=1, recall_floor=0.9, cooldown=0), [(0.5, 0), (0.95, 0), (0.5, 0)]),
    (dict(probe_every=1, recall_floor=0.9, cooldown=2), [(0.5, 0)] * 4),
    (dict(overflow_budget=10), [(None, 5), (None, 40), "compacted", (None, 5)]),
], ids=["escalates", "healthy_resets", "cooldown", "overflow_delta"])
def test_monitor_matches_reference(kw, observations):
    tm, jm = _monitors(**kw)
    for obs in observations:
        if obs == "compacted":
            tm.note_compaction(0)
            jm.note_compaction(0)
            continue
        assert tm.observe(*obs) == jm.observe(*obs)
        assert (tm.level, tm.exhausted, tm.last_overflow) == (jm.level, jm.exhausted,
                                                               jm.last_overflow)
    assert tm.history == jm.history


def test_monitor_escalates_one_rung_per_unhealthy_probe():
    m, _ = _monitors(probe_every=1, recall_floor=0.9, cooldown=0)
    assert [m.observe(0.5, 0) for _ in range(4)] == ["compact", "rebuild", "fallback", None]
    assert m.exhausted


# -- the ladder on the trainer's maintained index ---------------------------------------

def test_corrupt_index_recall_collapses_and_compact_heals(ds):
    """The reference test of this name, whose build (`cap=128` over 300
    items with one cluster of 225) drops items from its lists: healthy
    recall there is 0.875 with every cluster probed. Here the lists hold
    every item (cap from the largest cluster), so healthy recall with
    every cluster probed is ~1."""
    ih = th.IndexHealthConfig(probe_every=1, probe_rows=32, probe_k=16, recall_floor=0.7,
                              cooldown=0, n_probe=8)
    t = make_refresh_trainer(ds, health=th.HealthConfig(index=ih), steps=4, every=0, cap=None)
    lists = t.index_state.lists.numpy()
    assert sorted(lists[lists >= 0].tolist()) == list(range(300))  # every item listed
    with torch.no_grad():
        queries = t.policy.user_embedding(t.params, torch.from_numpy(ds.contexts[:32]))
    healthy = sampled_recall(t.index_state, t.beta, queries, 16, n_probe=8)
    assert healthy > 0.9
    t.index_state = th.corrupt_index_state(t.index_state, torch.Generator().manual_seed(9))
    assert sampled_recall(t.index_state, t.beta, queries, 16, n_probe=8) < 0.5
    probes = t.train(2)["index_health"]
    assert probes[0]["action"] == "compact" and probes[0]["recall"] < 0.7
    assert probes[1]["action"] is None and probes[1]["recall"] > 0.7
    assert t._monitor.level == 0  # the healthy probe reset the ladder


def test_full_ladder_walk_to_exact_fallback(ds):
    ih = th.IndexHealthConfig(probe_every=1, probe_rows=32, probe_k=16, recall_floor=1.01,
                              cooldown=0)
    t = make_refresh_trainer(ds, health=th.HealthConfig(index=ih), steps=6)
    assert not t.plan.degraded
    hist = t.train()
    assert [e["action"] for e in hist["index_health"] if e["action"]] == list(th.LADDER)
    assert t._degraded and t.plan.degraded and t._monitor.exhausted
    assert np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 6


# -- the fault drill on the serving engine ----------------------------------------------

def test_fault_drill_walks_ladder_to_fallback(monkeypatch):
    """`tests/test_serve.py`'s drill on the port's engine and, beside it,
    on the reference's with the same weights and index: the same ladder
    walk; every request answered; after the fallback the answers are
    exact top-K."""
    cfg, jcfg = get_arch("sasrec").SMOKE_CONFIG, jax_get_arch("sasrec").SMOKE_CONFIG
    jparams = jax_recsys.init_params(jcfg, jax.random.PRNGKey(0))
    params = recsys_params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(7)
    probe = rng.integers(-1, cfg.item_vocab, (8, cfg.seq_len)).astype(np.int32)
    hists = [rng.integers(-1, cfg.item_vocab, (cfg.seq_len,)).astype(np.int32)
             for _ in range(16)]
    ih = dict(probe_every=1, probe_k=8, recall_floor=1.01, cooldown=0)
    eng = ServingEngine(
        RecsysMIPSRoute(cfg, params, k=4, probe_hists=probe, device="cpu"),
        CoalescePolicy(max_batch=4, max_wait_s=0.5), health=th.IndexHealthConfig(**ih))
    jeng = JaxEngine(JaxRoute(jcfg, jparams, k=4, probe_hists=probe),
                     JaxCoalescePolicy(max_batch=4, max_wait_s=0.5),
                     health=jh.IndexHealthConfig(**ih))
    for e in (eng, jeng):
        e.warmup()
        for h in hists[:4]:
            e.submit(h, 0.0)
        assert len(e.drain()) == 4
    planner = eng.route.planner
    planner.index_state = th.corrupt_index_state(planner.index_state,
                                                 torch.Generator().manual_seed(1))
    jplanner = jeng.route.planner
    jplanner.index_state = jh.corrupt_index_state(jplanner.index_state, jax.random.PRNGKey(1))
    post = {}
    for name, e in (("port", eng), ("ref", jeng)):
        for h in hists[4:]:
            e.submit(h, e.free_at)
        post[name] = e.drain()
    actions = [h["action"] for h in eng.monitor.history if h["action"]]
    assert actions == ["compact", "rebuild", "fallback"]
    assert actions == [h["action"] for h in jeng.monitor.history if h["action"]]
    assert eng.route.degraded and len(post["port"]) == 12 and len(eng.records) == 16
    # the batches after the fallback are exact search over the items
    with torch.inference_mode():
        h = recsys.sasrec_user_vector(cfg, planner.params, torch.from_numpy(np.stack(hists[12:])))
        exact = topk_exact(h, planner.beta, 4)
    for i, rec in enumerate(post["port"][-4:]):
        np.testing.assert_array_equal(rec.result[0], exact.indices[i].numpy())
