"""Config dataclasses of the ported architectures (recsys for now)."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: Literal["din", "dien", "sasrec", "wide_deep"] = "din"
    item_vocab: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    mlp_dims: tuple[int, ...] = (200, 80)
    attn_mlp_dims: tuple[int, ...] = (80, 40)  # din
    gru_dim: int = 108  # dien
    num_blocks: int = 2  # sasrec
    num_heads: int = 1  # sasrec
    n_sparse: int = 40  # wide_deep
    n_dense: int = 13  # wide_deep
    field_vocab: int = 100_000  # wide_deep per-field vocab
    dtype: str = "float32"
    # FOPO head (sasrec/din policy-learning mode over the item catalog)
    fopo_top_k: int = 256
    fopo_num_samples: int = 1000
    fopo_epsilon: float = 0.8
