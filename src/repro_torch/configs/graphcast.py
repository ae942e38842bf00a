"""graphcast [gnn] — n_layers=16 d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227 — encoder-processor-decoder mesh GNN.
[arXiv:2212.12794; unverified]

The same configuration as the reference's `repro/configs/graphcast.py`:
`CONFIG` is the full width, `SMOKE_CONFIG` the small one the train CLI
and the tests use. Each shape cell brings its own graph (`GNN_SHAPES`).

FOPO applicability: NONE (dense regression, no catalog softmax)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.configs_base import GNNConfig

FAMILY = "gnn"

CONFIG = GNNConfig(
    name="graphcast",
    num_layers=16,
    d_hidden=512,
    aggregator="sum",
    n_vars=227,
    mesh_refinement=6,
)

SHAPES = dict(GNN_SHAPES)
SKIPPED_SHAPES: dict[str, str] = {}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, num_layers=3, d_hidden=32, n_vars=8
)
