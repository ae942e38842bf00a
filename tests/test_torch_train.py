"""The port's training path against the JAX reference's, on the CPU:
optimizers, data and loader, the plan's step body, `FOPOTrainer` and
the CLI.

The trainer parity runs the kernel configuration
(`fused=True, fused_sampler=True, retriever="pallas"`, TS 8) at P 300,
L 16, B 4, S 40, K 16: the reference through its Pallas kernels in
interpret mode, the port through their plain versions. The port starts
from the reference's theta and Adam state (`repro_torch.convert`) and
draws each step from the reference's sampler seed (its per-step key
split, folded by `key_to_seed`). Tolerances: loss and diagnostics rtol
1e-5 / atol 1e-6 (fp32 sums in another order); theta atol 1e-6 (Adam
normalises each gradient entry, so an fp32 difference in the gradient
moves the update by far less than the 3e-3 step itself). Data and
loader are bit for bit.

The optimizers run on fp32 and on bf16 trees. Each leaf's dtype after
every step equals the reference's (JAX promotes a bf16 leaf met by an
fp32 0-dim scale to fp32). fp32 values: parameters rtol 1e-6 / atol
1e-7, moments rtol 1e-6 with no absolute term (both sides form them in
the same order). bf16 values: the reference rounds its
Python-float constants (b1, momentum) to bf16 first, torch keeps them in
fp32, so a bf16 moment may land one or two bf16 ulps apart: moments rtol
2^-6 / atol 2^-6 times the leaf's max |value|; parameters within 2^-5 lr
per step times the size of the update direction (1 for Adam, max |mu|
for momentum SGD), which one such ulp moves.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402
import weakref  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core import FOPOConfig as JFOPOConfig  # noqa: E402
from repro.core.plan import ExecutionPlan as JPlan  # noqa: E402
from repro.core.policy import SoftmaxPolicy as JPolicy  # noqa: E402
from repro.core.policy import linear_tower_apply as j_linear  # noqa: E402
from repro.core.rewards import make_session_reward as j_session_reward  # noqa: E402
from repro.data import BatchLoader as JBatchLoader  # noqa: E402
from repro.data import SyntheticConfig as JSyntheticConfig  # noqa: E402
from repro.data import clustered_catalog as j_clustered  # noqa: E402
from repro.data import generate_sessions as j_generate  # noqa: E402
from repro.kernels.fused_sampler import key_to_seed  # noqa: E402
from repro.obs.schema import empty_history as j_empty_history  # noqa: E402
from repro.train import FOPOTrainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.core import ExecutionPlan, FOPOConfig, SoftmaxPolicy  # noqa: E402
from repro_torch.core.policy import linear_tower_apply  # noqa: E402
from repro_torch.core.rewards import make_session_reward  # noqa: E402
from repro_torch.data import (  # noqa: E402
    BatchLoader,
    SyntheticConfig,
    clustered_catalog,
    generate_sessions,
)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.obs.run import ObsConfig  # noqa: E402
from repro_torch.obs.schema import empty_history  # noqa: E402
from repro_torch.obs.trace import Tracer, tracing  # noqa: E402
from repro_torch.train import FOPOTrainer, TrainerConfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
KERNEL_KNOBS = dict(fused=True, fused_sampler=True, retriever="pallas", sample_tile=8)


@pytest.fixture(scope="module")
def dataset():
    cfg = SyntheticConfig(num_items=300, num_users=120, embed_dim=16, session_len=8, seed=0)
    return generate_sessions(cfg).split(0.85, seed=0)[0]


def _reference_seeds(seed: int, n: int) -> list[int]:
    """The sampler seeds the reference trainer draws: its training key
    PRNGKey(seed + 17) split once per step, each sub-key folded."""
    key, out = jax.random.PRNGKey(seed + 17), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(int(key_to_seed(sub)))
    return out


# -- optimizers -----------------------------------------------------------------

DTYPES = {"fp32": np.float32, "bf16": ml_dtypes.bfloat16}


def _dtype_names(tree) -> list[str]:
    return [str(x.dtype).replace("torch.", "") for x in optim.optimizers.tree_leaves(tree)]


def _close_leaves(tp, jp, dtype: str, lr: float, steps: int, direction: float = 1.0,
                  moment: bool = False):
    """The file's optimizer tolerances (see the module docstring)."""
    for t, j in zip(optim.optimizers.tree_leaves(tp), jax.tree.leaves(jp)):
        got, want = t.float().numpy(), np.asarray(j, np.float32)
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0 if moment else 1e-7)
        elif moment:
            np.testing.assert_allclose(got, want, rtol=2.0**-6,
                                       atol=2.0**-6 * float(np.abs(want).max()))
        else:
            assert np.abs(got - want).max() <= 2.0**-5 * lr * steps * direction


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_adam_matches_reference_step_for_step(clip, dtype):
    rng = np.random.default_rng(0)
    # keys in sorted order: the port's tree_leaves keeps insertion order,
    # jax.tree.leaves sorts
    params = {"layers": [{"b": rng.standard_normal(5).astype(DTYPES[dtype])}],
              "w": rng.standard_normal((6, 5)).astype(DTYPES[dtype])}
    jopt, topt = joptim.adam(3e-3), optim.adam(3e-3)
    jp = jax.tree.map(jnp.asarray, params)
    tp = optim.optimizers.tree_map(convert._leaf, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        # gradients in the parameters' current dtype, as autograd gives them
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype), jp)
        jg = jax.tree.map(jnp.asarray, g)
        tg = optim.optimizers.tree_map(lambda a: convert._leaf(np.asarray(a)), g)
        if clip:
            jg, tg = joptim.clip_by_global_norm(jg, clip), optim.clip_by_global_norm(tg, clip)
            assert _dtype_names(tg) == [str(a.dtype) for a in jax.tree.leaves(jg)]
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
        for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            assert _dtype_names(tree_t) == [str(a.dtype) for a in jax.tree.leaves(tree_j)]
        _close_leaves(tp, jp, dtype, 3e-3, step + 1)
        _close_leaves(ts["v"], js["v"], dtype, 3e-3, step + 1, moment=True)
        _close_leaves(ts["m"], js["m"], dtype, 3e-3, step + 1, moment=True)
    assert int(ts["step"]) == int(js["step"]) == 5
    # a bf16 tree: parameters fp32 from the first update on
    assert _dtype_names(tp) == ["float32", "float32"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sgd_adamw_and_schedules_match_reference(dtype):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 3)).astype(DTYPES[dtype])
    sched = (optim.cosine_schedule(0.1, 10, warmup=2), joptim.cosine_schedule(0.1, 10, warmup=2))
    for topt, jopt, lr, momentum in [
        (optim.sgd(0.1, momentum=0.9), joptim.sgd(0.1, momentum=0.9), 0.1, True),
        (optim.sgd(sched[0]), joptim.sgd(sched[1]), 0.1, False),
        (optim.adamw(1e-2, weight_decay=0.1), joptim.adamw(1e-2, weight_decay=0.1), 1e-2, False),
    ]:
        tp, jp = {"w": convert._leaf(w)}, {"w": jnp.asarray(w)}
        ts, js = topt.init(tp), jopt.init(jp)
        for step in range(4):
            g = rng.standard_normal(w.shape).astype(jp["w"].dtype)
            tp, ts = topt.update({"w": convert._leaf(g)}, ts, tp)
            jp, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
            assert _dtype_names(tp) == [str(jp["w"].dtype)]
            direction = float(np.abs(np.asarray(js["mu"]["w"], np.float32)).max()) if momentum \
                else 1.0
            _close_leaves(tp, jp, dtype, lr, step + 1, direction=direction)
            if momentum:
                assert _dtype_names(ts["mu"]) == [str(js["mu"]["w"].dtype)]
                _close_leaves(ts["mu"], js["mu"], dtype, lr, step + 1, moment=True)


def test_adam_frees_each_gradient_leaf_once_its_moments_are_formed(monkeypatch):
    """Handed the only reference to the gradients (as the LM train step
    hands them), the update drops each leaf before it works on the next:
    the peak of a full-width step holds no whole gradient tree beside the
    new parameters and moments. Values as a caller that keeps them gets."""
    rng = np.random.default_rng(3)
    params = {"b": torch.randn(3), "a": {"x": torch.randn(2, 2), "y": torch.randn(4)}}

    def grads():
        return optim.optimizers.tree_map(
            lambda p: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)), params)

    opt = optim.adam(1e-3)
    kept = grads()
    want_p, want_s = opt.update(kept, opt.init(params), params)
    g = optim.optimizers.tree_map(torch.clone, kept)
    refs = [weakref.ref(x) for x in optim.optimizers.tree_leaves(g)]
    freed = []
    f32 = optim.optimizers._f32

    def spy(x):
        if len(freed) < 2 * len(refs):
            freed.append(sum(r() is None for r in refs))
        return f32(x)

    monkeypatch.setattr(optim.optimizers, "_f32", spy)
    box = [g]
    del g
    got_p, got_s = opt.update(box.pop(), opt.init(params), params)
    assert freed[0::2] == [1, 2, 3]  # leaf i gone when its moments meet _f32
    for a, b in zip(optim.optimizers.tree_leaves((got_p, got_s)),
                    optim.optimizers.tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_adam_state_from_numpy_carries_moments_bit_for_bit(dtype):
    """An LM-shaped Adam state (nested dicts) after one reference update:
    bf16 moments come across as torch.bfloat16, fp32 as float32."""
    rng = np.random.default_rng(2)
    tree = {"embed": rng.standard_normal((8, 4)).astype(DTYPES[dtype]),
            "layers": {"wq": rng.standard_normal((2, 4, 4)).astype(DTYPES[dtype])}}
    jopt = joptim.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    _, js = jopt.update(jax.tree.map(lambda a: jnp.ones_like(a) * 0.3, jp), js, jp)
    ts = convert.adam_state_from_numpy(jax.tree.map(np.asarray, js))
    assert int(ts["step"]) == 1 and ts["step"].dtype == torch.int32
    for mom in ("m", "v"):
        want = jax.tree.leaves(js[mom])
        got = optim.optimizers.tree_leaves(ts[mom])
        assert _dtype_names(ts[mom]) == [str(a.dtype) for a in want]
        assert _dtype_names(ts[mom]) == ["bfloat16" if dtype == "bf16" else "float32"] * 2
        for t, j in zip(got, want):
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


# -- data -------------------------------------------------------------------------

def test_data_and_loader_are_the_reference_bit_for_bit():
    kw = dict(num_items=400, num_users=90, embed_dim=8, session_len=6, seed=3)
    tds, jds = generate_sessions(SyntheticConfig(**kw)), j_generate(JSyntheticConfig(**kw))
    for name in ("contexts", "positives", "item_embeddings"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name))
    (ttr, tte), (jtr, jte) = tds.split(0.8, seed=1), jds.split(0.8, seed=1)
    np.testing.assert_array_equal(ttr.contexts, jtr.contexts)
    np.testing.assert_array_equal(tte.positives, jte.positives)
    for a, b in zip(clustered_catalog(500, 6, 7, 9, seed=2), j_clustered(500, 6, 7, 9, seed=2)):
        np.testing.assert_array_equal(a, b)
    arrays = {"x": ttr.contexts, "y": ttr.positives}
    tl, jl = BatchLoader(arrays, 16, seed=4), JBatchLoader(arrays, 16, seed=4)
    for _ in range(2 * tl.batches_per_epoch + 1):  # across epoch boundaries
        tb, jb = tl.next_batch(), jl.next_batch()
        np.testing.assert_array_equal(tb["x"], jb["x"])
        np.testing.assert_array_equal(tb["y"], jb["y"])
    assert tl.state.to_dict() == jl.state.to_dict()


# -- the plan's step body -------------------------------------------------------------

def test_plan_execute_matches_reference(dataset):
    """One `execute` of the kernel configuration: the same loss,
    diagnostics and gradient, with the phases traced as spans."""
    p, l = dataset.item_embeddings.shape
    x, pos = dataset.contexts[:4], dataset.positives[:4]
    w = (np.random.default_rng(5).standard_normal((l, l)) / 4).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jplan = JPlan.resolve(JFOPOConfig(num_items=p, num_samples=40, top_k=16, **KERNEL_KNOBS))
    jpolicy = JPolicy(tower=j_linear, item_dim=l)
    (jl, jaux), jg = jax.value_and_grad(lambda prm: jplan.execute(
        jpolicy, prm, key, jnp.asarray(x), jnp.asarray(dataset.item_embeddings),
        j_session_reward(jnp.asarray(pos))), has_aux=True)({"w": jnp.asarray(w)})
    plan = ExecutionPlan.resolve(FOPOConfig(num_items=p, num_samples=40, top_k=16, **KERNEL_KNOBS))
    tw = torch.from_numpy(w).requires_grad_(True)
    tracer = Tracer()
    with tracing(tracer):
        loss, aux = plan.execute(
            SoftmaxPolicy(tower=linear_tower_apply, item_dim=l), {"w": tw},
            int(key_to_seed(key)), torch.from_numpy(x),
            torch.from_numpy(dataset.item_embeddings), make_session_reward(torch.from_numpy(pos)),
        )
    loss.backward()
    assert [e["name"] for e in tracer.events] == [
        "user_embedding", "retrieval", "sample", "reward", "surrogate"]
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg["w"]), **TOL)
    for k in ("ess", "rbar", "max_wbar"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **TOL)


# -- the trainer ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectories(dataset):
    """(reference, port) records after step 1 and after step 3 of the
    kernel configuration."""
    p = dataset.item_embeddings.shape[0]
    kw = dict(batch_size=4, learning_rate=3e-3, num_steps=3, seed=0)
    jtr = JTrainer(JTrainerConfig(
        estimator="fopo",
        fopo=JFOPOConfig(num_items=p, num_samples=40, top_k=16, epsilon=0.8, **KERNEL_KNOBS),
        checkpoint_every=0, **kw), dataset)
    seeds = _reference_seeds(0, 3)
    ttr = FOPOTrainer(
        TrainerConfig(estimator="fopo", fopo=FOPOConfig(
            num_items=p, num_samples=40, top_k=16, epsilon=0.8, **KERNEL_KNOBS), **kw),
        dataset, device="cpu",
        params=convert.linear_tower_params_from_numpy(jax.tree.map(np.asarray, jtr.params)),
        opt_state=convert.adam_state_from_numpy(jax.tree.map(np.asarray, jtr.opt_state)),
        step_seeds=lambda step: seeds[step],
    )
    out = []
    for steps in (1, 2):
        jh, th = jtr.train(steps), ttr.train(steps)
        out.append((jh, np.asarray(jtr.params["w"]), th, ttr.params["w"].numpy()))
    return out


@pytest.mark.parametrize("after", [1, 3])
def test_trainer_matches_reference(trajectories, after):
    jh, jw, th, tw = trajectories[0 if after == 1 else 1]
    assert set(th) == set(jh)  # the same history schema
    for k in ("loss", "ess", "rbar", "max_wbar"):
        np.testing.assert_allclose(th[k], jh[k], **TOL)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    w0 = trajectories[0][1] if after == 3 else None
    if w0 is not None:
        assert np.abs(tw - w0).max() > 1e-4  # theta moved over the last two steps


def test_adaptive_eps_and_grad_clip_match_reference(dataset):
    """The kernel configuration with the adaptive eps schedule and global
    gradient clipping: 6 steps, the reference's step seeds injected, the
    same history and theta."""
    p = dataset.item_embeddings.shape[0]
    kw = dict(batch_size=4, learning_rate=3e-3, num_steps=6, seed=2, adaptive_eps=True,
              grad_clip=0.1)
    jtr = JTrainer(JTrainerConfig(
        estimator="fopo", fopo=JFOPOConfig(num_items=p, num_samples=40, top_k=16, **KERNEL_KNOBS),
        checkpoint_every=0, **kw), dataset)
    seeds = _reference_seeds(2, 6)
    ttr = FOPOTrainer(
        TrainerConfig(estimator="fopo", fopo=FOPOConfig(
            num_items=p, num_samples=40, top_k=16, **KERNEL_KNOBS), **kw),
        dataset, device="cpu",
        params=convert.linear_tower_params_from_numpy(jax.tree.map(np.asarray, jtr.params)),
        opt_state=convert.adam_state_from_numpy(jax.tree.map(np.asarray, jtr.opt_state)),
        step_seeds=lambda step: seeds[step],
    )
    w0 = ttr.params["w"].clone()
    jh, th = jtr.train(6), ttr.train(6)
    for k in ("loss", "ess", "rbar", "max_wbar"):
        np.testing.assert_allclose(th[k], jh[k], **TOL)
    np.testing.assert_allclose(ttr.params["w"].numpy(), np.asarray(jtr.params["w"]), rtol=0,
                               atol=1e-6)
    assert not torch.equal(ttr.params["w"], w0)


def test_exact_estimator_matches_reference(dataset):
    """The dense exact gradient has no randomness: two steps, equal."""
    kw = dict(batch_size=4, learning_rate=3e-3, num_steps=2, seed=1)
    jtr = JTrainer(JTrainerConfig(estimator="exact", checkpoint_every=0, **kw), dataset)
    ttr = FOPOTrainer(
        TrainerConfig(estimator="exact", **kw), dataset, device="cpu",
        params=convert.linear_tower_params_from_numpy(jax.tree.map(np.asarray, jtr.params)),
    )
    jh, th = jtr.train(2), ttr.train(2)
    np.testing.assert_allclose(th["loss"], jh["loss"], **TOL)
    np.testing.assert_allclose(ttr.params["w"].numpy(), np.asarray(jtr.params["w"]), rtol=0, atol=1e-6)
    assert ttr.evaluate() == pytest.approx(jtr.evaluate())


@pytest.mark.parametrize("knobs", [
    dict(estimator="reinforce"),
    dict(estimator="fopo", fopo=dict(retriever="streaming")),
    dict(estimator="fopo", adaptive_eps=True, grad_clip=0.1,
         fopo=dict(retriever="exact", fused=True, fused_sampler=True, sample_tile=16)),
])
def test_other_estimators_and_knobs_train(dataset, knobs):
    """The generator-driven paths (REINFORCE, the mixture sampler, the
    adaptive eps schedule) draw other numbers than the reference's
    jax.random: they are held to run, stay finite and move theta."""
    knobs = dict(knobs)
    fopo = FOPOConfig(num_items=300, num_samples=24, top_k=12, **knobs.pop("fopo", {}))
    tr = FOPOTrainer(TrainerConfig(fopo=fopo, batch_size=4, learning_rate=3e-3, num_steps=3,
                                   **knobs), dataset, device="cpu")
    w0 = tr.params["w"].clone()
    hist = tr.train(3, log_every=1)
    assert np.all(np.isfinite(hist["loss"])) and len(hist["step_time"]) == 3
    assert not torch.equal(tr.params["w"], w0)


def test_history_has_the_reference_schema():
    assert set(empty_history()) == set(j_empty_history())


@pytest.mark.parametrize("field,value,match", [
    # the dist slice has landed: a dist= that is no DistConfig is a config
    # error, as the reference's `test_garbage_dist_config_rejected`
    pytest.param("fopo.dist", object(), "DistConfig", id="fopo.dist-value1-dist slice"),
])
def test_later_slices_raise_not_implemented(dataset, field, value, match):
    cfg = TrainerConfig(fopo=FOPOConfig(num_items=300, retriever="exact", fused_sampler=True))
    if field.startswith("fopo."):
        cfg = dataclasses.replace(cfg, fopo=dataclasses.replace(cfg.fopo, **{field[5:]: value}))
    else:
        cfg = dataclasses.replace(cfg, **{field: value})
    with pytest.raises(ValueError, match=match):
        FOPOTrainer(cfg, dataset, device="cpu")


@pytest.mark.parametrize("field", ["health", "checkpoint_dir", "fopo.index_refresh",
                                   "fault_plan", "obs"])
def test_health_and_maintenance_fields_are_taken(dataset, tmp_path, field):
    """The fields the health, IVF maintenance and observability slices
    ported: each is taken, and a 2-step run goes through it."""
    from repro_torch.health import FaultPlan, HealthConfig
    from repro_torch.mips.ivf import build_ivf
    from repro_torch.mips.refresh import RefreshConfig

    fopo = FOPOConfig(num_items=300, num_samples=16, top_k=8, retriever="exact")
    cfg, kwargs = TrainerConfig(fopo=fopo, batch_size=4, learning_rate=3e-3), {}
    if field == "fault_plan":
        kwargs["fault_plan"] = FaultPlan(nan_grads_at=(1,))
    elif field == "fopo.index_refresh":
        cfg = dataclasses.replace(cfg, fopo=dataclasses.replace(
            fopo, retriever="ivf_pallas", index_refresh=RefreshConfig(minibatch=32)))
        kwargs["retriever_kwargs"] = {"index": build_ivf(
            torch.from_numpy(dataset.item_embeddings), num_clusters=4, device="cpu")}
    elif field == "health":
        cfg = dataclasses.replace(cfg, health=HealthConfig())
    elif field == "obs":
        cfg = dataclasses.replace(cfg, obs=ObsConfig(run_dir=str(tmp_path / "run")))
    else:
        cfg = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    tr = FOPOTrainer(cfg, dataset, device="cpu", **kwargs)
    hist = tr.train(2)
    assert len(hist["loss"]) == 2 and tr.step == 2
    if field == "checkpoint_dir":
        assert sorted(os.listdir(tmp_path)) == ["step_0000000002"]
    if field == "obs":
        assert sorted(os.listdir(tmp_path / "run")) == ["metrics.jsonl", "trace.json"]


# -- the CLI -------------------------------------------------------------------------

def test_cli_trains_on_the_cpu(capsys):
    train_cli.main(["--arch", "fopo-paper", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "R_test before" in out and "step 2: loss=" in out and "R_test after" in out


def test_cli_trains_the_lm_on_the_cpu(capsys):
    """``--arch gemma2-2b`` runs the reference's `_train_lm` recipe and
    prints its step lines."""
    train_cli.main(["--arch", "gemma2-2b", "--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2
    for i, ln in enumerate(steps):
        m = re.fullmatch(rf"step {i}: loss=(\d+\.\d{{4}}) \(\d+ ms\)", ln)
        assert m, ln
        assert 5.0 < float(m.group(1)) < 8.0  # ~log(512) for random weights


def test_cli_refuses_cuda_without_cuda_and_other_arches(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "fopo-paper", "--steps", "1"])
    with pytest.raises(SystemExit, match="models slice"):
        train_cli.main(["--arch", "graphcast", "--steps", "1", "--device", "cpu"])
