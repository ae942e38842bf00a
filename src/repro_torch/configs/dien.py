"""dien [recsys] — embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru. [arXiv:1809.03672; unverified]

The same configuration as the reference's `repro/configs/dien.py`:
`CONFIG` is the full width (a catalog of 10^6 items), `SMOKE_CONFIG` the
small one the serving CLI and the tests use. DIEN serves retrieval
through `RecsysMIPSRoute`: the stage-1 GRU state, projected into item
space (L 18), queries the `ivf_topk` kernel."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.configs_base import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="dien",
    kind="dien",
    item_vocab=1_000_000,
    embed_dim=18,
    seq_len=100,
    gru_dim=108,
    mlp_dims=(200, 80),
)

SHAPES = dict(RECSYS_SHAPES)
SKIPPED_SHAPES: dict[str, str] = {}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, item_vocab=2000, seq_len=20, gru_dim=24, mlp_dims=(32, 16)
)
