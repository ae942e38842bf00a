"""The port's IVF index maintenance (`repro_torch.mips.refresh`) against
the reference's (`repro.mips.refresh`), on the CPU.

Each op runs on the same seeded numpy inputs on both sides, from the
reference's own built state carried across (`refresh_state_from_numpy`).
Tolerances: ids, lists, `slot_of`, `delta_sizes`, `overflow`: exact;
gathered embeddings: exact; centroids and counts rtol 1e-5 / atol 1e-6
(fp32 sums in another order); query results as
`test_torch_common.assert_topk_equal`. `refresh_step` draws its rows
from a `torch.Generator` where the reference splits a JAX key, so the
parity runs pass it the reference's rows.

The trainer trajectory runs the maintained-index configuration
(`retriever="ivf_pallas"`, `index_refresh`, `fused_sampler=True`, TS 8)
for 3 steps with one `update_items`, from a reference-built index, the
reference's theta, Adam state, step seeds and refresh rows: the
reference's `ivf_topk` in Pallas interpret mode, the port's through its
plain version. Loss and diagnostics rtol 1e-5 / atol 1e-6, theta atol
1e-6 (`tests/test_torch_train.py`'s tolerance); the maintained state at
the end as above.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_common import assert_topk_equal, to_port  # noqa: E402

from repro.core import FOPOConfig as JFOPOConfig  # noqa: E402
from repro.data import SyntheticConfig as JSyntheticConfig  # noqa: E402
from repro.data import generate_sessions as j_generate  # noqa: E402
from repro.kernels.fused_sampler import key_to_seed  # noqa: E402
from repro.mips import build_ivf as j_build_ivf  # noqa: E402
from repro.mips import refresh as jr  # noqa: E402
from repro.train import FOPOTrainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import FOPOConfig  # noqa: E402
from repro_torch.data import clustered_catalog  # noqa: E402
from repro_torch.kernels.ivf_topk import ops as ivf_ops  # noqa: E402
from repro_torch.mips import refresh as tr  # noqa: E402
from repro_torch.mips.exact import recall_at_k, topk_exact  # noqa: E402
from repro_torch.mips.ivf import build_ivf, ivf_query  # noqa: E402
from repro_torch.train import FOPOTrainer, TrainerConfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
P, L, C, DCAP = 400, 12, 8, 8

# the reference's ops under one jit each: its eager ops compile one by one
J_APPEND = jax.jit(jr.delta_append)
J_QUERY = jax.jit(jr.refresh_query, static_argnums=(2, 3))

EXACT_FIELDS = ("lists", "list_embs", "delta_lists", "delta_embs", "delta_sizes",
                "slot_of", "overflow")


@pytest.fixture(scope="module")
def built():
    """(items [P, L], the reference's RefreshState over them): cap 48, so
    the largest clusters overflow their lists."""
    rng = np.random.default_rng(0)
    items = rng.standard_normal((P, L)).astype(np.float32)
    build = jax.jit(jr.build_refresh_state, static_argnums=(2, 3),
                    static_argnames=("delta_cap", "kmeans_iters"))
    state = build(jax.random.PRNGKey(1), jnp.asarray(items), C, 48, delta_cap=DCAP,
                  kmeans_iters=4)
    return items, state


def port_state(jstate) -> tr.RefreshState:
    return convert.refresh_state_from_numpy(
        **{f: np.asarray(getattr(jstate, f)) for f in tr.RefreshState._fields}
    )


def assert_state_equal(port, ref, exact=EXACT_FIELDS):
    for f in exact:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f
        )
    for f in ("centroids", "counts"):
        np.testing.assert_allclose(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f, **TOL
        )


def test_init_refresh_state_matches_reference(built):
    items, jstate = built
    jindex = jstate.as_index(P)
    port = tr.init_refresh_state(to_port(jindex), P, DCAP)
    assert_state_equal(port, jr.init_refresh_state(jindex, P, DCAP))
    assert int((port.lists >= 0).sum()) < P  # cap 48 dropped items: not in slot_of
    assert int((port.slot_of >= 0).sum()) == int((port.lists >= 0).sum())


@pytest.mark.parametrize("weighted", [False, True])
def test_minibatch_kmeans_step_matches_reference(weighted):
    rng = np.random.default_rng(1)
    cent = rng.standard_normal((C, L)).astype(np.float32)
    counts = rng.uniform(0, 50, C).astype(np.float32)
    batch = rng.standard_normal((64, L)).astype(np.float32)
    w = (rng.random(64) < 0.7).astype(np.float32) if weighted else None
    jc, jn = jr.minibatch_kmeans_step(
        jnp.asarray(cent), jnp.asarray(counts), jnp.asarray(batch),
        None if w is None else jnp.asarray(w), count_decay=0.9,
    )
    tc, tn = tr.minibatch_kmeans_step(
        torch.from_numpy(cent), torch.from_numpy(counts), torch.from_numpy(batch),
        None if w is None else torch.from_numpy(w), count_decay=0.9,
    )
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)


@pytest.mark.parametrize("num_valid", [None, 250])
def test_refresh_step_matches_reference_on_its_rows(built, num_valid):
    items, jstate = built
    key = jax.random.PRNGKey(5)
    rows = np.asarray(jax.random.randint(key, (96,), 0, num_valid or P))
    ref = jr.refresh_step(jstate, key, jnp.asarray(items), minibatch=96, count_decay=0.95,
                          num_valid=num_valid)
    port = tr.refresh_step(port_state(jstate), None, torch.from_numpy(items), minibatch=96,
                           count_decay=0.95, num_valid=num_valid, rows=torch.from_numpy(rows))
    assert_state_equal(port, ref)


def test_refresh_step_draws_from_its_generator(built):
    items, jstate = built
    state = port_state(jstate)
    a = tr.refresh_step(state, torch.Generator().manual_seed(3), torch.from_numpy(items),
                        minibatch=64)
    b = tr.refresh_step(state, torch.Generator().manual_seed(3), torch.from_numpy(items),
                        minibatch=64)
    assert torch.equal(a.centroids, b.centroids)
    assert not torch.equal(a.centroids, state.centroids)


def _appends(rng, ids, scale=1.0):
    ids = np.asarray(ids, np.int32)
    return ids, (scale * rng.standard_normal((len(ids), L))).astype(np.float32)


# each case: a list of (ids, embs) batches appended in turn
APPEND_CASES = {
    # pads of -1 between live ids, and ids the cap-48 build left unlisted
    "pads": lambda rng: [_appends(rng, [3, -1, 17, -1, 399, 200, -1, 42])],
    # more appends to one region than delta_cap holds: counted in overflow
    "overflow": lambda rng: [
        (np.arange(40, dtype=np.int32),
         np.tile(rng.standard_normal((1, L)).astype(np.float32), (40, 1))
         + 0.01 * rng.standard_normal((40, L)).astype(np.float32))],
    # a second batch re-appends ids of the first (delta tombstones) and
    # ids still in the main lists (main tombstones)
    "tombstones": lambda rng: [_appends(rng, [5, 6, 7, 8, 9]),
                               _appends(rng, [7, 9, 11, 13, -1, 300])],
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_delta_append_matches_reference(built, case):
    items, jstate = built
    rng = np.random.default_rng(2)
    port = port_state(jstate)
    for ids, embs in APPEND_CASES[case](rng):
        jstate = J_APPEND(jstate, jnp.asarray(ids), jnp.asarray(embs))
        before = [t.clone() for t in port]
        nxt = tr.delta_append(port, torch.from_numpy(ids), torch.from_numpy(embs))
        for old, new in zip(before, port):  # no op writes its input in place
            assert torch.equal(old, new)
        port = nxt
        assert_state_equal(port, jstate)
    if case == "overflow":
        assert int(port.overflow) > 0
    if case == "tombstones":
        ids = np.concatenate([port.lists.numpy().ravel(), port.delta_lists.numpy().ravel()])
        for i in (7, 9):  # each live exactly once, in the delta buffers
            assert int((ids == i).sum()) == 1


@pytest.mark.parametrize("num_valid", [None, 333])
def test_compact_matches_reference(built, num_valid):
    items, jstate = built
    rng = np.random.default_rng(3)
    ids, embs = _appends(rng, [1, 2, 3, 250, 390])
    cur = items.copy()
    cur[ids] = embs
    jstate = J_APPEND(jstate, jnp.asarray(ids), jnp.asarray(embs))
    port = port_state(jstate)
    ref = jax.jit(jr.compact, static_argnames="num_valid")(
        jstate, jnp.asarray(cur), num_valid=num_valid)
    got = tr.compact(port, torch.from_numpy(cur), num_valid=num_valid)
    assert_state_equal(got, ref)
    assert int(got.delta_sizes.sum()) == 0 and int(got.overflow) > 0  # cap 48 drops


def test_compact_with_room_recovers_every_row():
    rng = np.random.default_rng(4)
    items = rng.standard_normal((P, L)).astype(np.float32)
    state = tr.build_refresh_state(torch.from_numpy(items), C, P, delta_cap=2,
                                   kmeans_iters=3, device="cpu")
    ids, embs = _appends(rng, np.arange(64))
    state = tr.delta_append(state, torch.from_numpy(ids), torch.from_numpy(embs))
    assert int(state.overflow) > 0  # drops are counted
    items[ids] = embs
    state = tr.compact(state, torch.from_numpy(items))
    assert int(state.overflow) == 0
    lists = state.lists.numpy()
    assert sorted(lists[lists >= 0].tolist()) == list(range(P))


@pytest.mark.parametrize("num_valid", [None, 333])
def test_rebuild_matches_reference(built, num_valid):
    items, jstate = built
    ref = jax.jit(jr.rebuild, static_argnames=("iters", "num_valid"))(
        jstate, jnp.asarray(items), iters=3, num_valid=num_valid)
    got = tr.rebuild(port_state(jstate), torch.from_numpy(items), iters=3, num_valid=num_valid)
    assert_state_equal(got, ref)


@pytest.fixture(scope="module")
def live_delta(built):
    """(reference state, port state, queries): delta buffers holding live,
    tombstoned and overflowed slots."""
    items, jstate = built
    rng = np.random.default_rng(6)
    for ids, embs in (APPEND_CASES["overflow"](rng) + APPEND_CASES["tombstones"](rng)):
        jstate = J_APPEND(jstate, jnp.asarray(ids), jnp.asarray(embs))
    q = rng.standard_normal((6, L)).astype(np.float32)
    dl = np.asarray(jstate.delta_lists)
    assert int(jstate.overflow) > 0 and (dl >= 0).any() and (dl < 0).any()
    return jstate, port_state(jstate), q


@pytest.mark.parametrize("k,n_probe", [(10, 3), (32, 8)])
def test_refresh_query_matches_reference(live_delta, k, n_probe):
    jstate, port, q = live_delta
    ref = J_QUERY(jstate, jnp.asarray(q), k, n_probe)
    assert_topk_equal(tr.refresh_query(port, torch.from_numpy(q), k, n_probe), ref)


@pytest.mark.parametrize("k,n_probe", [(10, 3), (32, 8)])
def test_kernel_plain_version_with_live_delta_matches_refresh_query(live_delta, k, n_probe):
    """K7's wrapper on the CPU (its plain version, main then delta pass)
    against the reference's `refresh_query` on the same state."""
    jstate, port, q = live_delta
    ref = J_QUERY(jstate, jnp.asarray(q), k, n_probe)
    got = ivf_ops.ivf_topk(torch.from_numpy(q), port.as_index(P), k, n_probe=n_probe,
                           delta=port.delta())
    assert_topk_equal(got, ref)


def test_sampled_recall_matches_reference(built, live_delta):
    items, _ = built
    jstate, port, q = live_delta
    want = jr.sampled_recall(jstate, jnp.asarray(items), jnp.asarray(q), 16, n_probe=4)
    got = tr.sampled_recall(port, torch.from_numpy(items), torch.from_numpy(q), 16, n_probe=4)
    assert got == pytest.approx(float(want), abs=1e-12)


def test_delta_append_zero_staleness():
    """An updated item is served at once with its fresh embedding, and
    its stale main-list copy is tombstoned."""
    rng = np.random.default_rng(7)
    items = torch.from_numpy(rng.standard_normal((P, L)).astype(np.float32))
    state = tr.build_refresh_state(items, C, 128, delta_cap=32, kmeans_iters=4, device="cpu")
    q = torch.from_numpy(rng.standard_normal((1, L)).astype(np.float32))
    ids = torch.tensor([5, 17, 300], dtype=torch.int32)
    state = tr.delta_append(state, ids, (q * 4.0).repeat(3, 1))
    out = tr.refresh_query(state, q, 3, n_probe=C)
    assert set(out.indices[0].tolist()) == {5, 17, 300}
    all_ids = torch.cat([state.lists.ravel(), state.delta_lists.ravel()])
    for i in (5, 17, 300):
        assert int((all_ids == i).sum()) == 1


def test_staleness_regression_recall_under_drift():
    """`tests/test_refresh.py`'s drift gate on the port's own builds:
    churn 5 % of the catalog in four stages; the maintained index holds
    recall@64 >= 0.95 against the current embeddings while the stale
    build-time index falls below it."""
    p, l, c, k = 4096, 16, 64, 64
    items, queries = (torch.from_numpy(a) for a in clustered_catalog(p, l, 64, 8))
    stale = build_ivf(items, num_clusters=c, cap=256, kmeans_iters=4, cap_tile=32, seed=1,
                      device="cpu")
    state = tr.build_refresh_state(items, c, 256, delta_cap=64, kmeans_iters=4, cap_tile=32,
                                   seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    cur = items.clone()
    for stage in range(4):
        m = p // 20
        ids = torch.randperm(p, generator=gen)[:m].to(torch.int32)
        new = torch.from_numpy(clustered_catalog(m, l, 16, 1, seed=stage + 10)[0])
        cur[ids.long()] = new
        state = tr.delta_append(state, ids, new)
        state = tr.refresh_step(state, gen, cur, minibatch=512)
        if stage % 2 == 1:
            state = tr.compact(state, cur)
    exact = topk_exact(queries, cur, k)
    rec_on = recall_at_k(tr.refresh_query(state, queries, k, n_probe=8), exact)
    rec_off = recall_at_k(ivf_query(stale, queries, k, n_probe=8), exact)
    assert rec_on >= 0.95, rec_on
    assert rec_on > rec_off, (rec_on, rec_off)


# -- the trainer on the maintained index ------------------------------------------

REFRESH = dict(every=1, minibatch=64, compact_every=2, delta_cap=16)
KNOBS = dict(num_samples=32, top_k=16, epsilon=0.8, retriever="ivf_pallas", fused=False,
             fused_sampler=True, sample_tile=8)
STEPS, CHURN_AFTER = 3, 1


def _reference_seeds(seed: int, key_offset: int, n: int, fold: bool) -> list:
    """The reference trainer's per-step draws from PRNGKey(seed + offset),
    split once a step: the sampler seeds (folded) or the sub-keys."""
    key, out = jax.random.PRNGKey(seed + key_offset), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(int(key_to_seed(sub)) if fold else sub)
    return out


@pytest.fixture(scope="module")
def trajectories():
    ds = j_generate(JSyntheticConfig(num_items=300, num_users=120, embed_dim=16,
                                     session_len=8, seed=0)).split(0.85, seed=0)[0]
    jindex = j_build_ivf(jax.random.PRNGKey(1), jnp.asarray(ds.item_embeddings),
                         num_clusters=8, kmeans_iters=3, cap_tile=32)
    kw = dict(batch_size=4, learning_rate=3e-3, num_steps=STEPS, seed=0)
    rkw = {"n_probe": 4, "cap_tile": 32}
    jtr = JTrainer(JTrainerConfig(
        estimator="fopo", fopo=JFOPOConfig(num_items=300, index_refresh=jr.RefreshConfig(
            **REFRESH), **KNOBS), checkpoint_every=0, **kw), ds,
        retriever_kwargs={"index": jindex, **rkw})
    seeds = _reference_seeds(0, 17, STEPS, fold=True)
    rows = [np.asarray(jax.random.randint(sub, (REFRESH["minibatch"],), 0, 300))
            for sub in _reference_seeds(0, 31, STEPS, fold=False)]
    ttr = FOPOTrainer(
        TrainerConfig(estimator="fopo", fopo=FOPOConfig(
            num_items=300, index_refresh=tr.RefreshConfig(**REFRESH), **KNOBS), **kw),
        ds, device="cpu", retriever_kwargs={"index": to_port(jindex), **rkw},
        params=convert.linear_tower_params_from_numpy(jax.tree.map(np.asarray, jtr.params)),
        opt_state=convert.adam_state_from_numpy(jax.tree.map(np.asarray, jtr.opt_state)),
        step_seeds=lambda step: seeds[step], refresh_rows=lambda step: rows[step],
    )
    rng = np.random.default_rng(9)
    churn_ids = np.array([4, 77, -1, 150, 299], np.int32)
    churn = rng.standard_normal((5, 16)).astype(np.float32)
    jh, th = jtr.train(CHURN_AFTER), ttr.train(CHURN_AFTER)
    jtr.update_items(churn_ids, churn)
    ttr.update_items(churn_ids, churn)
    jh2, th2 = jtr.train(STEPS - CHURN_AFTER), ttr.train(STEPS - CHURN_AFTER)
    return jtr, ttr, {k: jh[k] + jh2[k] for k in jh if isinstance(jh[k], list)}, \
        {k: th[k] + th2[k] for k in th if isinstance(th[k], list)}


def test_maintained_trainer_matches_reference(trajectories):
    jtr, ttr, jh, th = trajectories
    for k in ("loss", "ess", "rbar", "max_wbar"):
        assert len(th[k]) == STEPS
        np.testing.assert_allclose(th[k], jh[k], **TOL)
    np.testing.assert_allclose(ttr.params["w"].numpy(), np.asarray(jtr.params["w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ttr.beta.numpy(), np.asarray(jtr.beta))


def test_maintained_trainer_state_matches_reference(trajectories):
    """The index after 3 refreshes, a churn append and a compaction at
    step 2 (the delta buffers cleared, the churned rows re-bucketed)."""
    jtr, ttr, _, _ = trajectories
    assert_state_equal(ttr.index_state, jtr.index_state)
    assert int(ttr.index_state.delta_sizes.sum()) == 0
