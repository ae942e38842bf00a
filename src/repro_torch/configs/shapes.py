"""Canonical shape cells per architecture family (the reference's
`repro/configs/shapes.py`, field for field)."""
from __future__ import annotations

from repro_torch.models.configs_base import ShapeCell

LM_SHAPES = {
    "train_4k": ShapeCell(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeCell(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeCell(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    "long_500k": ShapeCell(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
}

RECSYS_SHAPES = {
    "train_batch": ShapeCell(name="train_batch", kind="train", global_batch=65536),
    "serve_p99": ShapeCell(name="serve_p99", kind="serve", global_batch=512),
    "serve_bulk": ShapeCell(name="serve_bulk", kind="serve", global_batch=262144),
    "retrieval_cand": ShapeCell(
        name="retrieval_cand", kind="retrieval", global_batch=1, n_candidates=1_000_000
    ),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeCell(
        name="full_graph_sm", kind="graph", n_nodes=2708, n_edges=10556, d_feat=1433
    ),
    "minibatch_lg": ShapeCell(
        name="minibatch_lg", kind="graph", n_nodes=232_965, n_edges=114_615_892,
        batch_nodes=1024, fanout=(15, 10), d_feat=602,
    ),
    "ogb_products": ShapeCell(
        name="ogb_products", kind="graph", n_nodes=2_449_029, n_edges=61_859_140,
        d_feat=100,
    ),
    "molecule": ShapeCell(
        name="molecule", kind="graph", n_nodes=30, n_edges=64, global_batch=128,
        d_feat=32,
    ),
}
