"""wide-deep [recsys] — n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat. [arXiv:1606.07792; paper]

The same configuration as the reference's `repro/configs/wide_deep.py`:
`CONFIG` is the full width (40 sparse fields hashed into one shared table
of 4 x 10^6 rows, 13 dense features), `SMOKE_CONFIG` the small one the
serving CLI and the tests use. It serves through `DenseCandidateRoute`
(the two-tower factorisation of `retrieval_topk`)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.configs_base import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="wide-deep",
    kind="wide_deep",
    item_vocab=1_000_000,
    embed_dim=32,
    mlp_dims=(1024, 512, 256),
    n_sparse=40,
    n_dense=13,
    field_vocab=1_000_000,
)

SHAPES = dict(RECSYS_SHAPES)
SKIPPED_SHAPES: dict[str, str] = {}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, field_vocab=500, item_vocab=2000, mlp_dims=(64, 32), n_sparse=8, n_dense=4
)
