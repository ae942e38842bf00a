"""The port's neighbour sampler (`repro_torch.data.graph_sampling`)
against the reference's, on the CPU: host numpy in both, so from the
same seeds and the same `np.random.Generator` every array is equal, bit
for bit. Also the reference's own sampler tests (`tests/test_data.py`),
mirrored.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import graph_sampling as jgs  # noqa: E402
from repro_torch.data import CSRGraph, random_graph, sample_neighbors  # noqa: E402


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,deg,seed", [(4, 2, 0), (500, 10, 0), (2708, 4, 3), (3000, 25, 7)])
def test_random_graph_equals_reference(n, deg, seed):
    got, want = random_graph(n, avg_degree=deg, seed=seed), jgs.random_graph(n, deg, seed=seed)
    assert got.num_nodes == want.num_nodes == n
    _same(got.indptr, want.indptr)
    _same(got.indices, want.indices)
    assert [got.degree(v) for v in range(0, n, 97)] == [want.degree(v) for v in range(0, n, 97)]


def test_from_edge_index_equals_reference():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    src[:7] = 49  # a node with several edges, in input order
    got, want = CSRGraph.from_edge_index(src, dst, 60), jgs.CSRGraph.from_edge_index(src, dst, 60)
    _same(got.indptr, want.indptr)
    _same(got.indices, want.indices)
    assert got.degree(59) == want.degree(59) == 0  # trailing nodes without edges


@pytest.mark.parametrize("fanouts,n_seeds", [((15, 10), 64), ((5, 3), 32), ((4,), 8),
                                             ((3, 2, 2), 16)])
def test_sample_neighbors_equals_reference(fanouts, n_seeds):
    """From generators in the same state both samplers take the same
    draws: node ids, padded edges, the seed count and the generator's
    state afterwards. Several steps in a row, as a training loop draws."""
    g = random_graph(1500, avg_degree=20, seed=2)
    jg = jgs.random_graph(1500, 20, seed=2)
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        seeds = rng_t.choice(1500, n_seeds, replace=False)
        assert np.array_equal(seeds, rng_j.choice(1500, n_seeds, replace=False))
        got = sample_neighbors(g, seeds, fanouts, rng_t)
        want = jgs.sample_neighbors(jg, seeds, fanouts, rng_j)
        _same(got.node_ids, want.node_ids)
        _same(got.edge_src, want.edge_src)
        _same(got.edge_dst, want.edge_dst)
        assert got.num_seeds == want.num_seeds == n_seeds
        assert rng_t.bit_generator.state == rng_j.bit_generator.state


def test_sampler_with_an_empty_frontier_equals_reference():
    """A hop that finds no new node continues from node 0 in both: with
    node 0 in the subgraph it samples node 0's neighbours again (the same
    arrays); with node 0 outside it both raise KeyError (seeds without
    neighbours; see ROADMAP Queue C)."""
    src = np.asarray([0, 0, 1, 3])
    dst = np.asarray([1, 3, 0, 1])
    g, jg = CSRGraph.from_edge_index(src, dst, 6), jgs.CSRGraph.from_edge_index(src, dst, 6)
    seeds = np.asarray([0, 1, 3])
    got = sample_neighbors(g, seeds, (2, 2), np.random.default_rng(0))
    want = jgs.sample_neighbors(jg, seeds, (2, 2), np.random.default_rng(0))
    for k in ("node_ids", "edge_src", "edge_dst"):
        _same(getattr(got, k), getattr(want, k))
    assert int((got.edge_dst == 0).sum()) == 4  # node 0's two edges, taken at both hops
    for sampler, graph in ((sample_neighbors, g), (jgs.sample_neighbors, jg)):
        with pytest.raises(KeyError):
            sampler(graph, np.asarray([4, 5]), (2, 2), np.random.default_rng(0))


# -- the reference's sampler tests (tests/test_data.py), mirrored --------------

def test_csr_graph_and_sampler():
    src = np.asarray([0, 0, 1, 2, 2, 2, 3])
    dst = np.asarray([1, 2, 0, 0, 1, 3, 2])
    g = CSRGraph.from_edge_index(src, dst, 4)
    assert g.degree(0) == 2 and g.degree(2) == 3

    rng = np.random.default_rng(0)
    sub = sample_neighbors(g, np.asarray([0, 3]), (2, 2), rng)
    assert sub.num_seeds == 2
    valid = sub.edge_src >= 0
    # every edge child is a real neighbor of its parent in the original graph
    for s_local, d_local in zip(sub.edge_src[valid], sub.edge_dst[valid]):
        child = sub.node_ids[s_local]
        parent = sub.node_ids[d_local]
        lo, hi = g.indptr[parent], g.indptr[parent + 1]
        assert child in g.indices[lo:hi]


def test_sampler_respects_fanout():
    g = random_graph(500, avg_degree=10, seed=0)
    rng = np.random.default_rng(1)
    seeds = np.arange(32)
    sub = sample_neighbors(g, seeds, (5, 3), rng)
    n_valid = int((sub.edge_src >= 0).sum())
    assert n_valid <= 32 * 5 + 32 * 5 * 3
    assert len(sub.edge_src) == 32 * 5 + 32 * 5 * 3  # static padded size

