"""The port's recsys training on the FOPO objective
(`repro_torch.models.recsys.make_train_step(objective="fopo")`) against
the JAX reference at SMOKE_CONFIG, on the CPU (the weights, batches and
helpers of `test_torch_recsys_train.py`).

* SASRec and DIEN: the step's loss and every gradient leaf (both
  steps handed an optimizer whose update returns the gradients) on the
  reference's own draws: the reference's `MixtureProposal` over its
  streaming top-K from the same key its step uses, handed to the port as
  ``sample=``. The port's own top-K equals the reference's (scores rtol
  1e-5 / atol 1e-6, ids as sorted sets). Loss rtol 1e-5 / atol 1e-7,
  gradients rtol 1e-4 / atol 1e-6 times the leaf's largest |gradient|
  (sums over the batch and the samples, of both signs, in another
  order).
* ``retriever_mode="sharded"`` on an in-process gloo world of one: the
  retriever gives the streaming top-K, and a step from a seed equals the
  streaming step from that seed.
* The port's mirror of the reference's
  `test_sasrec_fopo_objective_improves_reward` (hit rate +0.2 in 60
  steps), and the train CLI for the four recsys arches.
"""
import dataclasses
import functools
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core.proposals import MixtureProposal as JaxMixture  # noqa: E402
from repro.mips.streaming import topk_streaming as jax_topk_streaming  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.proposals import ProposalSample  # noqa: E402
from repro_torch.dist import make_debug_dist  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.mips.streaming import topk_streaming  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from test_torch_common import assert_topk_equal  # noqa: E402
from test_torch_recsys_train import (  # noqa: E402
    LR, _batches, _j, _leaves, _port_params, _setup, _t,
)


# -- FOPO --------------------------------------------------------------------------

def _grads_optimizer(module):
    """An optimizer whose update returns the gradients as the parameters."""
    return module.Optimizer(init=lambda p: {}, update=lambda g, s, p: (g, s))


def _jax_tower(arch: str):
    return jax_recsys.sasrec_user_vector if arch == "sasrec" else jax_recsys.dien_user_vector


@functools.cache
def _jax_fopo(arch: str):
    """(batch, the reference's top-K, draws, loss and gradient leaves) of
    one step at key 3."""
    _, jcfg, params = _setup(arch)
    batch = _batches(jcfg, 1, "fopo")[0]
    key = jax.random.PRNGKey(3)
    step = jax.jit(jax_recsys.make_train_step(jcfg, _grads_optimizer(joptim), objective="fopo"))
    grads, _, loss = step(params, {}, _j(batch), key)
    h = _jax_tower(arch)(jcfg, params, jnp.asarray(batch["hist"]))
    topk = jax_topk_streaming(h, params["items"], jcfg.fopo_top_k, block_items=8192)
    sample = JaxMixture(jcfg.item_vocab, jcfg.fopo_epsilon).sample(
        key, topk.indices, topk.scores, jcfg.fopo_num_samples)
    return (batch, topk, ProposalSample(*(torch.from_numpy(np.array(t)) for t in sample)),
            float(loss), _leaves(grads))


@pytest.mark.parametrize("arch", ["sasrec", "dien"])
def test_fopo_loss_and_gradients_match_reference_on_its_draws(arch):
    cfg = _setup(arch)[0]
    batch, jtopk, sample, jloss, jgrads = _jax_fopo(arch)
    params = _port_params(arch)
    tower = recsys.sasrec_user_vector if arch == "sasrec" else recsys.dien_user_vector
    with torch.no_grad():
        h = tower(cfg, params, torch.from_numpy(batch["hist"]))
        top = recsys.fopo_plan(cfg).retrieve(h, params["items"])
    assert_topk_equal(top, jtopk)
    step = recsys.make_train_step(cfg, _grads_optimizer(optim), objective="fopo")
    grads, _, loss = step(params, {}, _t(batch), 3, sample=sample)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=1e-7)
    got = _leaves(grads)
    assert len(got) == len(jgrads)
    for j, (a, b) in enumerate(zip(got, jgrads)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=f"leaf {j}")
    # the DIEN tower leaves AUGRU and the ranking MLP out: zero gradients
    if arch == "dien":
        assert all(float(g.abs().max()) == 0 for g in tree_leaves(grads["augru"]))


def test_fopo_refuses_other_kinds():
    with pytest.raises(ValueError, match="fopo objective unsupported for din"):
        recsys.make_train_step(_setup("din")[0], optim.adam(LR), objective="fopo")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The port's `DistConfig` on an in-process gloo world of one."""
    store = tmp_path_factory.mktemp("world1") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    yield make_debug_dist(1, 1)
    tdist.destroy_process_group()


def test_sharded_retriever_mode_on_a_world_of_one(world1):
    """The sharded top-K over the one slab is the streaming top-K, and the
    step from a seed is the streaming step's from that seed."""
    cfg = _setup("sasrec")[0]
    batch = _t(_batches(cfg, 1, "fopo")[0])
    params = _port_params("sasrec")
    plan = recsys.fopo_plan(cfg, "sharded", dist=world1)
    with torch.no_grad():
        h = recsys.sasrec_user_vector(cfg, params, batch["hist"])
        got = plan.retrieve(h, params["items"])
    want = topk_streaming(h, params["items"], cfg.fopo_top_k, block_items=8192)
    assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)
    out = {}
    for mode in ("streaming", "sharded"):
        step = recsys.make_train_step(cfg, _grads_optimizer(optim), "fopo", mode, dist=world1)
        out[mode] = step(params, {}, batch, 5)
    assert torch.equal(out["sharded"][2], out["streaming"][2])
    for a, b in zip(tree_leaves(out["sharded"][0]), tree_leaves(out["streaming"][0])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs dist="):
        recsys.fopo_plan(cfg, "sharded")


def test_sasrec_fopo_objective_improves_reward():
    """The port's mirror of the reference's flagship test: FOPO training of
    SASRec's catalog policy head lifts the hit rate by 0.2 in 60 steps."""
    cfg = dataclasses.replace(get_arch("sasrec").SMOKE_CONFIG, item_vocab=500)
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    b, t = 32, cfg.seq_len
    # synthetic sequential structure: next item = (last item + 1) % V
    hist = rng.integers(0, cfg.item_vocab - 1, (b, t)).astype(np.int32)
    positives = ((hist[:, -1:] + 1) % cfg.item_vocab).astype(np.int32)
    batch = {"hist": torch.from_numpy(hist), "positives": torch.from_numpy(positives)}
    opt = optim.adam(5e-3)
    step = recsys.make_train_step(cfg, opt, objective="fopo")

    def hit_rate(p):
        with torch.no_grad():
            u = recsys.sasrec_user_vector(cfg, p, batch["hist"])
            top1 = torch.argmax(u @ p["items"].T, dim=-1).numpy()
        return float((top1[:, None] == positives).any(1).mean())

    before = hit_rate(params)
    st = opt.init(params)
    p = params
    for i in range(60):
        p, st, _ = step(p, st, batch, i)
    after = hit_rate(p)
    assert after > before + 0.2, (before, after)


@pytest.mark.parametrize("arch,objective", [("sasrec", "fopo"), ("din", "bce"), ("dien", "bce"),
                                            ("wide-deep", "bce")])
def test_train_cli_runs_the_recsys_arches_on_the_cpu(capsys, arch, objective):
    """The reference's `_train_recsys` recipe: sasrec on FOPO, the others
    on BCE, one ``step i: loss=... [objective]`` line a step."""
    train_cli.main(["--arch", arch, "--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch={arch} family=recsys (smoke scale on cpu)"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2
    for i, ln in enumerate(steps):
        m = re.fullmatch(rf"step {i}: loss=(-?\d+\.\d{{5}}) \[{objective}\]", ln)
        assert m, ln
        assert np.isfinite(float(m.group(1)))
