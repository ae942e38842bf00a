"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]

The same configuration as the reference's `repro/configs/olmoe_1b_7b.py`:
`CONFIG` is the full width (6.9 B parameters, bf16), `SMOKE_CONFIG` the
small fp32 one the CLIs and the tests use. Full attention with no
window and no soft-cap; each layer's FFN is `models.moe.moe_ffn` over 64
experts of width 1024, 8 a token, at capacity factor 1.25."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.configs_base import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="olmoe-1b-7b",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    num_experts_per_tok=8,
    moe_d_ff=1024,
    gated_act="silu",
    dtype="bfloat16",
    microbatch=32,
)

SHAPES = dict(LM_SHAPES)
SKIPPED_SHAPES = {"long_500k": "pure full-attention arch"}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=32,
    capacity_factor=4.0,
    dtype="float32",
    microbatch=0,
)
