"""The port's DIN, DIEN and Wide&Deep (`repro_torch.models.recsys`)
against the JAX reference at SMOKE_CONFIG, on the CPU, with the
reference's weights carried across by `recsys_params_from_numpy`.

Histories hold -1 holes in the middle and one all -1 row. Logits,
scores and user vectors within rtol 1e-5 / atol 1e-5 (fp32 matmuls and
DIEN's 20 GRU steps summed in another order). `_wd_flat_ids` bit for
bit. Top-K is compared as sorted scores, and as id sets above the K-th
score: `jax.lax.top_k` and `torch.topk` break ties differently (an empty
history's user vector scores every candidate alike). The
reference scores one query (B = 1); the port takes a batch, each row of
which must equal the reference's answer for that row alone.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import recsys_params_from_numpy  # noqa: E402
from repro_torch.models import recsys  # noqa: E402

ARCHS = ["din", "dien", "wide-deep"]
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.cache
def _setup(arch: str, seed: int = 0):
    """(cfg, the reference's cfg, its params, the port's copy of them);
    cached per module, read only."""
    cfg, jcfg = get_arch(arch).SMOKE_CONFIG, jax_get_arch(arch).SMOKE_CONFIG
    jparams = jax_recsys.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jparams, recsys_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _batch(cfg, b: int, seed: int) -> dict:
    """numpy inputs of every kind: hist, target, sparse, dense."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(-1, cfg.item_vocab, (b, cfg.seq_len)).astype(np.int32)
    hist[rng.random(hist.shape) < 0.3] = -1  # holes in the middle
    hist[0] = -1  # an empty history
    return {
        "hist": hist,
        "target": rng.integers(0, cfg.item_vocab, (b,)).astype(np.int32),
        "sparse": rng.integers(0, 10**6, (b, cfg.n_sparse)).astype(np.int32),
        "dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
    }


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for name in ("CONFIG", "SMOKE_CONFIG"):
        mine, ref = getattr(get_arch(arch), name), getattr(jax_get_arch(arch), name)
        assert mine == type(mine)(**vars(ref))
    assert get_arch(arch).FAMILY == "recsys"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """Same leaves, shapes and dtypes as the reference's tree (the draws
    differ: another generator)."""
    cfg, _, jparams, _ = _setup(arch)
    mine = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    shapes = {jax.tree_util.keystr(p): tuple(np.shape(v)) for p, v in ref_leaves}
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape, np.float32), mine,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))
    )[0]
    assert {jax.tree_util.keystr(p): v.shape for p, v in flat} == shapes


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, seed):
    cfg, jcfg, jparams, params = _setup(arch, seed)
    batch = _batch(cfg, 6, seed)
    ref = np.asarray(jax_recsys.forward(jcfg, jparams, _j(batch)))
    out = recsys.forward(cfg, params, _t(batch))
    assert out.shape == (6,) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_din_retrieval_scores_match_reference_row_by_row():
    cfg, jcfg, jparams, params = _setup("din")
    batch = _batch(cfg, 3, 2)
    cands = np.arange(40, dtype=np.int32) * 7
    out = recsys.din_retrieval_scores(
        cfg, params, torch.from_numpy(batch["hist"]), torch.from_numpy(cands)
    )
    assert out.shape == (3, 40)
    for row in range(3):
        ref = jax_recsys.din_retrieval_scores(
            jcfg, jparams, jnp.asarray(batch["hist"][row:row + 1]), jnp.asarray(cands)
        )
        np.testing.assert_allclose(out[row].numpy(), np.asarray(ref), **TOL)


def test_dien_user_vector_matches_reference():
    cfg, jcfg, jparams, params = _setup("dien", 1)
    batch = _batch(cfg, 7, 3)
    ref = np.asarray(jax_recsys.dien_user_vector(jcfg, jparams, jnp.asarray(batch["hist"])))
    out = recsys.dien_user_vector(cfg, params, torch.from_numpy(batch["hist"]))
    assert out.shape == (7, cfg.embed_dim)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_wd_flat_ids_are_bit_for_bit():
    cfg, jcfg, _, _ = _setup("wide-deep")
    rng = np.random.default_rng(4)
    ids = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, (64, 40)).astype(np.int32)
    ids[0] = np.iinfo(np.int32).max  # the salt add wraps at 2^32
    ids[1] = -1
    for c, jc in ((cfg, jcfg), (get_arch("wide-deep").CONFIG, jax_get_arch("wide-deep").CONFIG)):
        ref = np.asarray(jax_recsys._wd_flat_ids(jc, jnp.asarray(ids)))
        out = recsys._wd_flat_ids(c, torch.from_numpy(ids))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("arch", ARCHS + ["sasrec"])
def test_retrieval_topk_matches_reference_row_by_row(arch):
    cfg, jcfg, jparams, params = _setup(arch, 1)
    batch = _batch(cfg, 3, 5)
    cands = np.arange(300, dtype=np.int32) * 5 + 11
    tb = {**_t(batch), "candidates": torch.from_numpy(cands)}
    vals, ids = recsys.retrieval_topk(cfg, params, tb, k=10)
    assert vals.shape == ids.shape == (3, 10)
    for row in range(3):
        one = {k: v[row:row + 1] for k, v in batch.items()}
        jv, ji = jax_recsys.retrieval_topk(jcfg, jparams, {**_j(one), "candidates":
                                                          jnp.asarray(cands)}, k=10)
        jv, ji = np.asarray(jv)[0], np.asarray(ji)[0]
        v, i = vals[row].numpy(), ids[row].numpy()
        np.testing.assert_allclose(np.sort(v), np.sort(jv), **TOL)
        # ids above the K-th score equal as sets; those tied with it (row
        # 0's empty history scores every candidate alike) may differ
        kth = np.sort(jv)[0] + 1e-5 + 1e-5 * abs(np.sort(jv)[0])
        np.testing.assert_array_equal(np.sort(i[v > kth]), np.sort(ji[jv > kth]))
