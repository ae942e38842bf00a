"""The port's IVF index (`repro_torch.mips.ivf`, `mips.refresh`,
`mips.exact`) against the JAX reference, on the CPU.

The layout helpers, the bucketing, the cluster assignment and the
maintained-state wrapper are pinned to the reference exactly; the plain
query and the K-merge within `test_torch_common.assert_topk_equal`'s
tolerances. The port's own `build_ivf` draws k-means++ seeds from a
torch.Generator, so it is held to properties instead: every item in
exactly one list, and recall against the exact top-K.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_common import assert_topk_equal, data, jax_index, to_port  # noqa: E402

from repro.data import clustered_catalog  # noqa: E402
from repro.kernels.ivf_topk import tile_align_index as jax_tile_align  # noqa: E402
from repro.mips import exact as jax_exact  # noqa: E402
from repro.mips import ivf as jax_ivf  # noqa: E402
from repro.mips import refresh as jax_refresh  # noqa: E402
from repro_torch.convert import refresh_state_from_numpy  # noqa: E402
from repro_torch.kernels.ivf_topk import ivf_topk, tile_align_index  # noqa: E402
from repro_torch.mips import exact, ivf, refresh  # noqa: E402


def test_ivf_query_matches_reference():
    _, jindex = jax_index(400, 16, 8, seed=4, key=4, cap_tile=16)
    _, q = data(400, 16, 5, seed=9)
    ref = jax_ivf.ivf_query(jindex, jnp.asarray(q), 20, n_probe=3)
    out = ivf.ivf_query(to_port(jindex), torch.from_numpy(q), 20, n_probe=3)
    assert_topk_equal(out, ref)


def test_merge_topk_demotes_dead_slots_like_reference():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((4, 12)).astype(np.float32)
    ids = rng.permutation(48).astype(np.int32).reshape(4, 12)
    ids[rng.random((4, 12)) < 0.4] = -1
    ref = jax_exact.merge_topk(jnp.asarray(scores), jnp.asarray(ids), 8)
    out = exact.merge_topk(torch.from_numpy(scores), torch.from_numpy(ids), 8)
    assert_topk_equal(out, ref)


@pytest.mark.parametrize("cap_tile", [None, 7, 8, 16, 64, 300])
@pytest.mark.parametrize("cap", [3, 8, 50, 64, 256])
def test_resolve_cap_tile_and_cap_match_reference(cap_tile, cap):
    assert ivf.resolve_cap_tile(cap_tile, cap) == jax_ivf.resolve_cap_tile(cap_tile, cap)
    assert ivf.resolve_cap(cap, cap_tile) == jax_ivf.resolve_cap(cap, cap_tile)


@pytest.mark.parametrize("cap_tile", [None, 7, 16, 24])
def test_tile_align_index_matches_reference(cap_tile):
    _, jindex = jax_index(300, 8, 8, seed=3, key=6)
    jal, jct = jax_tile_align(jindex, cap_tile)
    al, ct = tile_align_index(to_port(jindex), cap_tile)
    assert ct == jct
    np.testing.assert_array_equal(al.lists.numpy(), np.asarray(jal.lists))
    np.testing.assert_array_equal(al.list_embs.numpy(), np.asarray(jal.list_embs))


@pytest.mark.parametrize("cap", [4, 16, 64])
def test_bucket_items_matches_reference(cap):
    """Exact, including the drop rules: ranks past `cap` and the drop
    bucket C."""
    p, l, c = 200, 6, 10
    rng = np.random.default_rng(cap)
    assign = rng.integers(0, c + 1, p).astype(np.int32)  # c = drop bucket
    items = rng.standard_normal((p, l)).astype(np.float32)
    jl, je = jax_ivf.bucket_items(jnp.asarray(assign), jnp.asarray(items), c, cap)
    tl, te = ivf.bucket_items(torch.from_numpy(assign), torch.from_numpy(items), c, cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_assign_clusters_matches_reference():
    """Exact on distinct distances."""
    rng = np.random.default_rng(11)
    points = rng.standard_normal((700, 16)).astype(np.float32)
    cents = rng.standard_normal((24, 16)).astype(np.float32)
    ref = np.asarray(jax_ivf.assign_clusters(jnp.asarray(points), jnp.asarray(cents)))
    out = ivf.assign_clusters(torch.from_numpy(points), torch.from_numpy(cents))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("delta_cap,id_base", [(8, 0), (3, 0), (4, 50)])
def test_init_refresh_state_matches_reference(delta_cap, id_base):
    _, jindex = jax_index(300, 8, 8, seed=3, key=6)
    if id_base:  # ids of a later slab; some fall outside [0, rows)
        jindex = jindex._replace(
            lists=jnp.where(jindex.lists >= 0, jindex.lists + id_base, -1)
        )
    rows = 300
    ref = jax_refresh.init_refresh_state(jindex, rows, delta_cap, id_base=id_base)
    out = refresh.init_refresh_state(to_port(jindex), rows, delta_cap, id_base=id_base)
    carried = refresh_state_from_numpy(
        **{name: np.asarray(getattr(ref, name)) for name in ref._fields}
    )
    for name in refresh.RefreshState._fields:
        np.testing.assert_array_equal(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
        assert torch.equal(getattr(carried, name), getattr(out, name)), name
    assert out.delta()[0].shape == (8, delta_cap)
    assert out.as_index(rows).lists is out.lists


def test_default_num_clusters_matches_reference_rule():
    for p in (10, 2000, 4096, 131072, 1_000_000):
        want = max(1, int(2 ** round(jnp.log2(jnp.sqrt(p)).item())))
        assert ivf.default_num_clusters(p) == want


# ---------------------------------------------------------------------------
# the port's own build (its own RNG): held to properties
# ---------------------------------------------------------------------------

def test_build_ivf_buckets_every_item_once():
    items, _ = data(900, 12, 1, seed=21)
    index = ivf.build_ivf(torch.from_numpy(items), num_clusters=12, device="cpu")
    lists = index.lists.numpy()
    assert sorted(lists[lists >= 0].tolist()) == list(range(900))
    live = lists >= 0
    np.testing.assert_array_equal(index.list_embs.numpy()[live], items[lists[live]])
    assert (index.list_embs.numpy()[~live] == 0).all()
    cap = lists.shape[1]
    assert cap & (cap - 1) == 0  # derive path: a power of two


def test_build_ivf_static_path_and_cap_tile():
    items, _ = data(256, 8, 1, seed=22)
    index = ivf.build_ivf(
        torch.from_numpy(items), num_clusters=8, cap=100, cap_tile=16, device="cpu"
    )
    assert index.lists.shape == (8, ivf.resolve_cap(100, 16))


def test_build_ivf_recall_on_clustered_catalog():
    """recall@K >= 0.95 against the exact top-K, at the reference's
    recall-test geometry and n_probe (`tests/test_ivf_pallas.py`)."""
    p, l, c, b, k, n_probe = 4096, 16, 64, 8, 32, 4
    items, queries = clustered_catalog(p, l, c, b, seed=7)
    items_t = torch.from_numpy(items.astype(np.float32))
    q_t = torch.from_numpy(queries.astype(np.float32))
    index = ivf.build_ivf(
        items_t, num_clusters=c, kmeans_iters=6, cap_tile=32, device="cpu"
    )
    got = ivf_topk(q_t, index, k, n_probe=n_probe)
    assert exact.recall_at_k(got, exact.topk_exact(q_t, items_t, k)) >= 0.95
