"""The port's sharded index and its maintenance, the sharded checkpoint
files, the dist padding helpers and the plan's dist errors, against the
reference on the CPU; then a `torch.distributed` world of one (gloo,
in-process) against the reference's dist code on a 1 x 1 mesh.

The stacked `*_sharded` ops run on the reference's own built state
(`build_refresh_sharded`, carried across by `repro_torch.convert`) over
a ragged catalog (P 203 in 2 shards: 102 + 101 valid rows), with the
reference's refresh rows injected. Tolerances as
`tests/test_torch_refresh.py`: ids, lists, slots, counts of drops exact;
gathered embeddings exact; centroids and counts rtol 1e-5 / atol 1e-6;
recall rel 1e-12 (a mean taken in another order). The world of one: loss and diagnostics rtol 1e-6 / atol
1e-6, theta gradients rtol 1e-5 / atol 1e-6 (the reference's dist
tests).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from repro.core import FOPOConfig as JFOPOConfig  # noqa: E402
from repro.core.plan import ExecutionPlan as JPlan  # noqa: E402
from repro.core.policy import SoftmaxPolicy as JPolicy  # noqa: E402
from repro.core.policy import linear_tower_apply as j_linear  # noqa: E402
from repro.core.rewards import make_session_reward as j_reward  # noqa: E402
from repro.dist import collectives as jc  # noqa: E402
from repro.dist.fopo import make_debug_dist as j_make_debug_dist  # noqa: E402
from repro.kernels.fused_sampler import key_to_seed  # noqa: E402
from repro.mips import refresh as jr  # noqa: E402
from repro.mips.ivf import build_ivf_sharded as j_build_ivf_sharded  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ExecutionPlan, FOPOConfig, SoftmaxPolicy  # noqa: E402
from repro_torch.core.policy import linear_tower_apply  # noqa: E402
from repro_torch.core.rewards import make_session_reward  # noqa: E402
from repro_torch.dist import collectives as tc  # noqa: E402
from repro_torch.dist.fopo import make_debug_dist  # noqa: E402
from repro_torch.mips import refresh as tr  # noqa: E402
from repro_torch.mips.ivf import IVFIndex, build_ivf, build_ivf_sharded  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
P, L, N, C, CAP, DCAP, MB = 203, 8, 2, 4, 64, 8, 16
ROWS = -(-P // N)
EXACT_FIELDS = ("lists", "list_embs", "delta_lists", "delta_embs", "delta_sizes",
                "slot_of", "overflow")


def port_state(jstate) -> tr.RefreshState:
    return convert.refresh_state_from_numpy(
        **{f: np.asarray(getattr(jstate, f)) for f in tr.RefreshState._fields})


def assert_state_equal(port, ref):
    for f in tr.RefreshState._fields:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        if f in EXACT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, err_msg=f, **TOL)


@pytest.fixture(scope="module")
def built():
    """(items [P, L], the reference's stacked state over them, its index)."""
    items = np.random.default_rng(0).standard_normal((P, L)).astype(np.float32)
    jindex = jax.jit(j_build_ivf_sharded, static_argnums=(2, 3, 4, 5))(
        jax.random.PRNGKey(1), jnp.asarray(items), N, C, CAP, 4)
    return items, jr.init_refresh_sharded(jindex, DCAP), jindex


def _ref_rows(key) -> np.ndarray:
    """[n, MB]: the rows the reference's `refresh_step_sharded` draws."""
    valids = [min(max(P - d * ROWS, 0), ROWS) for d in range(N)]
    return np.stack([np.asarray(jax.random.randint(k, (MB,), 0, max(nv, 1)))
                     for k, nv in zip(jax.random.split(key, N), valids)])


# -- the padding helpers ----------------------------------------------------------------

@pytest.mark.parametrize("p,s,mult", [(203, 37, 2), (64, 24, 2), (301, 5, 3), (10, 4, 1)])
def test_pad_rows_and_pad_samples_match_reference(p, s, mult):
    rng = np.random.default_rng(p)
    table = rng.standard_normal((p, 3)).astype(np.float32)
    acts = rng.integers(0, p, (2, s)).astype(np.int32)
    lq = rng.standard_normal((2, s)).astype(np.float32)
    rw = rng.random((2, s)).astype(np.float32)
    np.testing.assert_array_equal(tc.pad_rows(torch.from_numpy(table), mult).numpy(),
                                  np.asarray(jc.pad_rows(jnp.asarray(table), mult)))
    got = tc.pad_samples(*map(torch.from_numpy, (acts, lq, rw)), mult)
    want = jc.pad_samples(*map(jnp.asarray, (acts, lq, rw)), mult)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tc.padded_len(p, mult) == jc.padded_len(p, mult)


def test_rebase_ids_maps_foreign_ids_dead():
    ids = torch.tensor([[-1, 0, 99, 100, 150, 199, 200]])
    local, owned = tc.rebase_ids(ids, 100, 1)
    assert local.tolist() == [[-1, -1, -1, 0, 50, 99, -1]]
    assert owned.tolist() == [[False, False, False, True, True, True, False]]


# -- the sharded index ----------------------------------------------------------------

@pytest.mark.parametrize("cap_tile", [None, 24])
def test_build_ivf_sharded_layout(cap_tile):
    """Global ids in each shard's slab, the ragged tail masked out, one
    padded cap for every shard (a cap-tile multiple when one is given),
    every item listed once with its own embedding."""
    items = torch.from_numpy(np.random.default_rng(1).standard_normal((P, L)).astype(np.float32))
    ix = build_ivf_sharded(items, N, C, cap_tile=cap_tile, device="cpu")
    assert ix.n_shards == N and ix.num_items == P
    assert ix.lists.shape[:2] == (N, C) and ix.list_embs.shape == (*ix.lists.shape, L)
    if cap_tile:
        assert ix.lists.shape[2] % 24 == 0
    seen = []
    for d in range(N):
        sh = ix.shard(d)
        assert isinstance(sh, IVFIndex)
        live = sh.lists[sh.lists >= 0]
        assert bool(((live >= d * ROWS) & (live < min(P, (d + 1) * ROWS))).all())
        np.testing.assert_array_equal(sh.list_embs[sh.lists >= 0].numpy(),
                                      items[live.long()].numpy())
        assert bool((sh.list_embs[sh.lists < 0] == 0).all())
        seen += live.tolist()
        # shard d's index is the one-device build of its (zero-padded) slab
        slab = items[d * ROWS:(d + 1) * ROWS]
        slab = torch.cat([slab, slab.new_zeros((ROWS - len(slab), L))])
        one = build_ivf(slab, C, cap_tile=cap_tile, seed=d, device="cpu")
        np.testing.assert_array_equal(sh.centroids.numpy(), one.centroids.numpy())
    assert sorted(seen) == list(range(P))


def test_sharded_index_converts_from_reference(built):
    _, _, jindex = built
    ix = convert.sharded_ivf_index_from_numpy(
        np.asarray(jindex.centroids), np.asarray(jindex.lists), np.asarray(jindex.list_embs),
        jindex.num_items)
    assert ix.n_shards == jindex.n_shards
    for d in range(N):
        np.testing.assert_array_equal(ix.shard(d).lists.numpy(), np.asarray(jindex.shard(d).lists))
    assert int(ix.lists.max()) < P  # the ragged tail's pad rows are not listed


# -- the stacked maintenance ops --------------------------------------------------------

def test_init_refresh_sharded_matches_reference(built):
    _, jstate, jindex = built
    port = tr.init_refresh_sharded(
        convert.sharded_ivf_index_from_numpy(*(np.asarray(t) for t in jindex[:3]), P), DCAP)
    assert_state_equal(port, jstate)
    ix = tr.sharded_as_index(port, P)
    np.testing.assert_array_equal(ix.lists.numpy(), np.asarray(jindex.lists))


def test_refresh_step_sharded_matches_reference_on_its_rows(built):
    items, jstate, _ = built
    key = jax.random.PRNGKey(5)
    want = jax.jit(jr.refresh_step_sharded, static_argnames=("minibatch",))(
        jstate, key, jnp.asarray(items), minibatch=MB)
    got = tr.refresh_step_sharded(port_state(jstate), None, torch.from_numpy(items),
                                  minibatch=MB, rows=torch.from_numpy(_ref_rows(key)))
    assert_state_equal(got, want)


def _churn():
    rng = np.random.default_rng(9)
    ids = np.concatenate([rng.choice(P, 12, replace=False), [-1, -1]]).astype(np.int32)
    return ids, rng.standard_normal((14, L)).astype(np.float32)


def test_delta_append_sharded_matches_reference(built):
    _, jstate, _ = built
    ids, embs = _churn()
    want = jax.jit(jr.delta_append_sharded, static_argnums=3)(
        jstate, jnp.asarray(ids), jnp.asarray(embs), P)
    got = tr.delta_append_sharded(port_state(jstate), torch.from_numpy(ids),
                                  torch.from_numpy(embs), P)
    assert_state_equal(got, want)
    assert int(got.delta_sizes.sum()) > 0


@pytest.mark.parametrize("op", ["compact", "rebuild"])
def test_compact_and_rebuild_sharded_match_reference(built, op):
    items, jstate, _ = built
    ids, embs = _churn()
    jstate = jr.delta_append_sharded(jstate, jnp.asarray(ids), jnp.asarray(embs), P)
    moved = items.copy()
    moved[ids[ids >= 0]] = embs[ids >= 0]
    if op == "compact":
        want = jax.jit(jr.compact_sharded)(jstate, jnp.asarray(moved))
        got = tr.compact_sharded(port_state(jstate), torch.from_numpy(moved))
    else:
        want = jax.jit(jr.rebuild_sharded, static_argnames=("iters",))(
            jstate, jnp.asarray(moved), iters=2)
        got = tr.rebuild_sharded(port_state(jstate), torch.from_numpy(moved), iters=2)
    assert_state_equal(got, want)
    # the ragged tail's pad rows never reach a list
    assert int(got.lists.max()) < P and int(got.delta_sizes.sum()) == 0


def test_sampled_recall_over_a_stacked_state(built):
    items, jstate, _ = built
    ids, embs = _churn()
    jstate = jr.delta_append_sharded(jstate, jnp.asarray(ids), jnp.asarray(embs), P)
    q = np.random.default_rng(4).standard_normal((16, L)).astype(np.float32)
    want = jr.sampled_recall(jstate, jnp.asarray(items), jnp.asarray(q), 10, n_probe=2)
    got = tr.sampled_recall(port_state(jstate), torch.from_numpy(items), torch.from_numpy(q),
                            10, n_probe=2)
    assert got == pytest.approx(want, rel=1e-12)  # the mean taken in another order
    assert 0.0 < got <= 1.0


def test_build_refresh_sharded_is_init_of_build_ivf_sharded():
    items = torch.from_numpy(np.random.default_rng(2).standard_normal((P, L)).astype(np.float32))
    got = tr.build_refresh_sharded(items, N, C, CAP, delta_cap=DCAP, kmeans_iters=3,
                                   device="cpu")
    want = tr.init_refresh_sharded(
        build_ivf_sharded(items, N, C, CAP, 3, device="cpu"), DCAP)
    for f in tr.RefreshState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.slot_of.shape == (N, ROWS) and got.overflow.shape == (N,)


# -- sharded checkpoint files -----------------------------------------------------------

@pytest.mark.parametrize("rows,n", [(10, 4), (203, 3), (3, 5)])
def test_shard_bounds_match_reference(rows, n):
    assert tckpt.shard_bounds(rows, n) == jckpt.shard_bounds(rows, n)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_sharded_restores_across_packages_elastically(tmp_path, writer):
    """Saved in 4 shards by one package, read by the other: the whole
    array, and each shard of a 3-way split (elastic 4 -> 3)."""
    table = np.random.default_rng(3).standard_normal((203, 5)).astype(np.float32)
    if writer == "port":
        tckpt.save_sharded(str(tmp_path), "beta", torch.from_numpy(table), 4)
        read = jckpt.restore_sharded
    else:
        jckpt.save_sharded(str(tmp_path), "beta", jnp.asarray(table), 4)
        read = tckpt.restore_sharded
    manifest = json.loads((tmp_path / "beta_sharded" / "shards.json").read_text())
    assert manifest["bounds"] == [list(b) for b in tckpt.shard_bounds(203, 4)]
    np.testing.assert_array_equal(np.asarray(read(str(tmp_path), "beta")), table)
    for m, (lo, hi) in enumerate(tckpt.shard_bounds(203, 3)):
        got = np.asarray(read(str(tmp_path), "beta", shard_id=m, num_shards=3))
        np.testing.assert_array_equal(got, table[lo:hi])
    with pytest.raises(ValueError, match="num_shards"):
        tckpt.restore_sharded(str(tmp_path), "beta", shard_id=0)


# -- a world of one ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The port's `DistConfig` on an in-process gloo world of one."""
    store = tmp_path_factory.mktemp("world1") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    yield make_debug_dist(1, 1)
    tdist.destroy_process_group()


def _fopo_problem(seed=3, b=4, p=160, l=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l)).astype(np.float32),
            rng.standard_normal((p, l)).astype(np.float32),
            (rng.standard_normal((l, l)) / np.sqrt(l)).astype(np.float32),
            rng.integers(0, p, (b, 6)).astype(np.int32))


@pytest.mark.parametrize("retriever", ["streaming", "ivf_pallas"])
def test_world_of_one_matches_reference_1x1_mesh(world1, retriever):
    """fopo_loss with the in-kernel sampler on a world of one against the
    reference's dist code on a 1 x 1 mesh, through the sharded exact
    merge and through the IVF kernel over a one-shard index (the
    reference's, carried across): loss, diagnostics and theta
    gradients."""
    x, beta, w, pos = _fopo_problem()
    p = beta.shape[0]
    knobs = dict(num_items=p, num_samples=33, top_k=16, epsilon=0.5, retriever=retriever,
                 fused_sampler=True, sample_tile=8)
    jkw = tkw = {}
    if retriever == "ivf_pallas":
        jindex = j_build_ivf_sharded(jax.random.PRNGKey(2), jnp.asarray(beta), 1, 8, 64)
        jkw = {"index": jindex}
        tkw = {"index": convert.sharded_ivf_index_from_numpy(
            *(np.asarray(t) for t in jindex[:3]), p)}
    key = jax.random.PRNGKey(7)
    jplan = JPlan.resolve(JFOPOConfig(**knobs, fused_interpret=True,
                                      dist=j_make_debug_dist(1, 1)),
                          backend="cpu", retriever_kwargs=jkw)

    def jloss(wj):
        return jplan.execute(JPolicy(tower=j_linear, item_dim=8), {"w": wj}, key,
                             jnp.asarray(x), jnp.asarray(beta), j_reward(jnp.asarray(pos)))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(w))
    plan = ExecutionPlan.resolve(FOPOConfig(**knobs, dist=world1), retriever_kwargs=tkw)
    assert plan.fused and plan.dist is world1
    params = {"w": torch.from_numpy(w).requires_grad_(True)}
    loss, aux = plan.execute(SoftmaxPolicy(tower=linear_tower_apply, item_dim=8), params,
                             int(key_to_seed(key)), torch.from_numpy(x),
                             torch.from_numpy(beta), make_session_reward(torch.from_numpy(pos)))
    (g,) = torch.autograd.grad(loss, params["w"])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6, atol=1e-6)
    for k in ("ess", "rbar", "max_wbar"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("kw,index,match", [
    (dict(dist=object()), None, "DistConfig"),
    (dict(retriever="ivf_pallas"), "single", "build_ivf_sharded"),
    (dict(retriever="ivf_pallas"), "two_shards", "model axis is 1"),
    (dict(retriever="ivf"), "single", "has no dist route"),
])
def test_plan_dist_errors_name_the_reference_messages(world1, kw, index, match):
    items = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 8)).astype(np.float32))
    indexes = {
        "single": build_ivf(items, 4, device="cpu"),
        "two_shards": build_ivf_sharded(items, 2, 4, device="cpu"),
    }
    kw = {"dist": world1, **kw}
    with pytest.raises(ValueError, match=match):
        ExecutionPlan.resolve(FOPOConfig(num_items=64, **kw),
                              retriever_kwargs={"index": indexes[index]} if index else {})


def test_guard_agreement_on_a_world_of_one(world1):
    """`guarded_update(dist=)` agrees the verdict (a MAX over the world)
    and skips a bad step; a good one updates."""
    from repro_torch.health import guard as th

    cfg, st = th.HealthConfig(), th.init_guard_state()
    p = {"w": torch.ones(2)}
    upd = lambda params, o: ({"w": params["w"] + 1}, o)  # noqa: E731
    out, _, _, v = th.guarded_update(cfg, st, torch.tensor(float("nan")), torch.tensor(1.0),
                                     {}, p, {}, upd, dist=world1)
    assert int(v) != 0 and torch.equal(out["w"], p["w"])
    out, _, _, v = th.guarded_update(cfg, st, torch.tensor(1.0), torch.tensor(1.0), {}, p, {},
                                     upd, dist=world1)
    assert int(v) == 0 and torch.equal(out["w"], p["w"] + 1)


def test_sharded_retriever_over_a_group(world1):
    """retriever="sharded" without dist=: the streaming scan of each rank's
    slab merged over the given group (here the whole catalog)."""
    items = torch.from_numpy(np.random.default_rng(6).standard_normal((64, 8)).astype(np.float32))
    h = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 8)).astype(np.float32))
    plan = ExecutionPlan.resolve(FOPOConfig(num_items=64, top_k=5, retriever="sharded"),
                                 retriever_kwargs={"group": world1.model_group})
    got = plan.retrieve(h, items)
    want = torch.topk(h @ items.T, 5)
    np.testing.assert_array_equal(got.indices.numpy(), want.indices.int().numpy())
    np.testing.assert_allclose(got.scores.numpy(), want.values.numpy(), **TOL)


def test_dataclass_replace_keeps_the_groups(world1):
    d = dataclasses.replace(world1, routing="replicate")
    assert (d.n_data, d.n_model, d.data_rank, d.model_rank) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="routing"):
        dataclasses.replace(world1, routing="scatter")
