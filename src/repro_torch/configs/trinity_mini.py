"""trinity-mini [moe] — AFMoE: 32L d_model=2048 32H (GQA kv=4, head 128)
vocab=200,192; 2 dense layers (SwiGLU 6144), then 128 experts of 1024,
top-8 by sigmoid scores, 1 shared expert; three sliding-window layers
(2048) then one full layer. [hf: arcee-ai/Trinity-Mini config.json]

A port-only configuration (the reference has no AFMoE): `CONFIG` is the
published model, every routed expert held; `SMOKE_CONFIG` the small fp32
one the CPU tests run, at 8 layers so that full layers follow the dense
ones. The details `config.json` leaves to the modeling code
(`modeling_afmoe.py`) are `AFMoEConfig`'s defaults: q / k RMSNorm per
head, the attention's sigmoid output gate, no RoPE on full layers,
sandwich norms, the embedding times sqrt(d) (`mup_enabled`). The expert
bias is held at zero (its out-of-gradient update is left out), so the
selection is the top-8 of the sigmoid scores. The benchmark's cut (12
layers, 32 of 128 experts held) is `bench/configs/trinity-mini.json`."""
from __future__ import annotations

import dataclasses

from repro_torch.models.configs_base import AFMoEConfig

FAMILY = "lm"

PERIOD = ("sliding", "sliding", "sliding", "full")  # `layer_types`, repeated


def layer_types(n: int) -> tuple[str, ...]:
    """The first ``n`` of the published `layer_types`."""
    return tuple(PERIOD[i % len(PERIOD)] for i in range(n))


CONFIG = AFMoEConfig(
    name="trinity-mini",
    num_layers=32,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,
    vocab_size=200_192,
    sliding_window=2048,
    rope_theta=10_000.0,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1024,
    gated_act="silu",
    rms_eps=1e-5,
    dtype="float32",
    use_flash_kernel=True,
    layer_types=layer_types(32),
    num_dense_layers=2,
    route_scale=2.826,
    num_shared_experts=1,
    compute_dtype="bfloat16",
)

SHAPES: dict = {}  # no dry-run cell: the benchmark's cell runs it
SKIPPED_SHAPES: dict[str, str] = {}

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    sliding_window=8,
    num_experts=16,
    num_experts_per_tok=4,
    moe_d_ff=32,
    use_flash_kernel=False,
    layer_types=layer_types(8),
    compute_dtype=None,
)
