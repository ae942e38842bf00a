"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768. [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

The same configuration as the reference's
`repro/configs/mistral_large_123b.py`: `CONFIG` is the full width (123 B
parameters, bf16, an explicit head_dim of 128, bf16 Adam moments),
`SMOKE_CONFIG` the small fp32 one the CLIs and the tests use (head_dim
16). Full attention."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.configs_base import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="mistral-large-123b",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    gated_act="silu",
    dtype="bfloat16",
    microbatch=16,
    moments_dtype="bfloat16",
)

SHAPES = dict(LM_SHAPES)
SKIPPED_SHAPES = {
    "long_500k": "pure full-attention arch; 500k dense KV cache reserved for sub-quadratic archs"
}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    dtype="float32",
    microbatch=0,
)
