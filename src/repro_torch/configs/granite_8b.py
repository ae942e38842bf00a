"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]

The same configuration as the reference's `repro/configs/granite_8b.py`:
`CONFIG` is the full width (bf16, rope theta 10^7), `SMOKE_CONFIG` the
small fp32 one the CLIs and the tests use. Full attention."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.configs_base import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="granite-8b",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
    gated_act="silu",
    dtype="bfloat16",
    microbatch=32,
)

SHAPES = dict(LM_SHAPES)
SKIPPED_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §5)"}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    dtype="float32",
    microbatch=0,
)
