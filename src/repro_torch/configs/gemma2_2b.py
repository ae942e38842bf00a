"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating, logit softcap. [arXiv:2408.00118; hf]

The same configuration as the reference's `repro/configs/gemma2_2b.py`:
`CONFIG` is the full width (2.6 B parameters, bf16), `SMOKE_CONFIG` the
small fp32 one the serving CLI and the tests use. Even layers attend
within a 4096-token sliding window, odd layers globally; attention
logits are soft-capped at 50, final logits at 30; the embedding is tied
and scaled by sqrt(d_model); the MLP is gated with tanh-approximated
gelu."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.configs_base import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="gemma2-2b",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=256,
    sliding_window=4096,
    local_global_alternating=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    gated_act="gelu",
    tie_embeddings=True,
    dtype="bfloat16",
    microbatch=32,
)

SHAPES = dict(LM_SHAPES)
SKIPPED_SHAPES: dict[str, str] = {}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    sliding_window=8,
    dtype="float32",
    microbatch=0,
)
