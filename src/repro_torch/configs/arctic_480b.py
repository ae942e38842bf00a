"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

The same configuration as the reference's `repro/configs/arctic_480b.py`:
`CONFIG` is the full width (480 B parameters, ~17 B active), `SMOKE_CONFIG`
the small fp32 one the CLIs and the tests use. Each layer adds a dense
gated MLP, run in parallel on the same input, to its experts' output
(``dense_residual``); Adam keeps its moments in bf16
(``moments_dtype``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.configs_base import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="arctic-480b",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,  # dense-residual branch hidden
    vocab_size=32000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_d_ff=4864,
    dense_residual=True,
    gated_act="silu",
    dtype="bfloat16",
    microbatch=16,
    moments_dtype="bfloat16",
)

SHAPES = dict(LM_SHAPES)
SKIPPED_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §5)"}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    num_experts=4,
    num_experts_per_tok=2,
    moe_d_ff=32,
    capacity_factor=4.0,
    dtype="float32",
    microbatch=0,
)
