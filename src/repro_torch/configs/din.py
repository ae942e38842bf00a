"""din [recsys] — embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn. [arXiv:1706.06978; paper]

The same configuration as the reference's `repro/configs/din.py`:
`CONFIG` is the full width (a catalog of 10^6 items), `SMOKE_CONFIG` the
small one the serving CLI and the tests use. DIN has no
target-independent user vector, so it serves through
`DenseCandidateRoute` (target attention recomputed per candidate)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.configs_base import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="din",
    kind="din",
    item_vocab=1_000_000,
    embed_dim=18,
    seq_len=100,
    attn_mlp_dims=(80, 40),
    mlp_dims=(200, 80),
)

SHAPES = dict(RECSYS_SHAPES)
SKIPPED_SHAPES: dict[str, str] = {}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, item_vocab=2000, seq_len=20, attn_mlp_dims=(16, 8), mlp_dims=(32, 16)
)
