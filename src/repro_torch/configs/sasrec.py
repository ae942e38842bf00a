"""sasrec [recsys] — embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq. [arXiv:1808.09781; paper]

The same configuration as the reference's `repro/configs/sasrec.py`:
`CONFIG` is the full width (10^6 items), `SMOKE_CONFIG` the small one the
serving CLI and the tests use."""
from __future__ import annotations

import dataclasses

from repro_torch.models.configs_base import RecsysConfig

FAMILY = "recsys"

CONFIG = RecsysConfig(
    name="sasrec",
    kind="sasrec",
    item_vocab=1_000_000,
    embed_dim=50,
    seq_len=50,
    num_blocks=2,
    num_heads=1,
    fopo_top_k=256,
    fopo_num_samples=1000,
    fopo_epsilon=0.8,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, item_vocab=2000, seq_len=16, fopo_top_k=32, fopo_num_samples=64
)
