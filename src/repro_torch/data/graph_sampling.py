"""Neighbor sampling for minibatch GNN training (GraphSAGE-style).

The `minibatch_lg` shape cell (Reddit-scale: 233K nodes / 115M edges,
batch 1024 seeds, fanout 15-10) needs a *real* neighbor sampler: uniform
without-replacement sampling from each seed's adjacency list, two hops,
returning a compact padded subgraph with relabelled node ids.

Host-side numpy over a CSR adjacency (the standard production split:
sampling on CPU hosts feeding the card); output shapes are static
(padded to batch * prod(fanout)), so every step hands the device the
same shapes. A copy of the reference's `repro/data/graph_sampling.py`:
from the same `np.random.Generator` it gives the same arrays, bit for
bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    num_nodes: int

    @staticmethod
    def from_edge_index(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> "CSRGraph":
        order = np.argsort(src, kind="stable")
        s, d = src[order], dst[order]
        counts = np.bincount(s, minlength=num_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSRGraph(indptr=indptr, indices=d.astype(np.int64), num_nodes=num_nodes)

    def degree(self, node: int) -> int:
        return int(self.indptr[node + 1] - self.indptr[node])


@dataclasses.dataclass
class SampledSubgraph:
    """Padded 2-hop block: edges point child -> parent (message direction)."""

    node_ids: np.ndarray  # [M] original ids of all subgraph nodes (seeds first)
    edge_src: np.ndarray  # [E_pad] local ids, -1 pad
    edge_dst: np.ndarray  # [E_pad] local ids, -1 pad
    num_seeds: int


def sample_neighbors(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> SampledSubgraph:
    """Uniform fanout sampling, GraphSAGE-style, hop by hop."""
    frontier = seeds.astype(np.int64)
    local_of = {int(n): i for i, n in enumerate(frontier)}
    nodes = list(frontier)
    src_l, dst_l = [], []
    # static worst-case edge capacity (actual frontiers shrink under
    # dedup/low degree, but the padded shape must be data-independent)
    e_cap, cap_frontier = 0, len(seeds)
    for fanout in fanouts:
        e_cap += cap_frontier * fanout
        cap_frontier *= fanout
    for fanout in fanouts:
        next_frontier = []
        for dst_node in frontier:
            lo, hi = graph.indptr[dst_node], graph.indptr[dst_node + 1]
            neigh = graph.indices[lo:hi]
            if len(neigh) == 0:
                continue
            take = min(fanout, len(neigh))
            picked = rng.choice(neigh, size=take, replace=False)
            for nb in picked:
                nb = int(nb)
                if nb not in local_of:
                    local_of[nb] = len(nodes)
                    nodes.append(nb)
                    next_frontier.append(nb)
                src_l.append(local_of[nb])
                dst_l.append(local_of[int(dst_node)])
        frontier = np.array(next_frontier or [0], np.int64)

    e = len(src_l)
    edge_src = np.full(e_cap, -1, np.int32)
    edge_dst = np.full(e_cap, -1, np.int32)
    edge_src[:e] = src_l
    edge_dst[:e] = dst_l
    return SampledSubgraph(
        node_ids=np.asarray(nodes, np.int64),
        edge_src=edge_src,
        edge_dst=edge_dst,
        num_seeds=len(seeds),
    )


def random_graph(
    num_nodes: int, avg_degree: int, seed: int = 0
) -> CSRGraph:
    """Power-law-ish random graph for tests/smokes."""
    rng = np.random.default_rng(seed)
    e = num_nodes * avg_degree
    # preferential-attachment-flavoured: sample dst ~ zipf over node ids
    src = rng.integers(0, num_nodes, e)
    w = 1.0 / np.arange(1, num_nodes + 1) ** 0.8
    w /= w.sum()
    dst = rng.choice(num_nodes, size=e, p=w)
    keep = src != dst
    return CSRGraph.from_edge_index(src[keep], dst[keep], num_nodes)
