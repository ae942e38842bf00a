"""Config dataclasses of the ported architectures (the LM family, recsys
and the GNN) and the dry-run shape cell the configs list."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's `LMConfig`, every field kept. The port reads the
    model fields, `use_flash_kernel`, `decode_gqa_einsum`, `remat` (a
    checkpoint per layer in training), `microbatch` and `flash_axes` (the
    kernel's batch axes on a DTensor mesh); the dry run's programs
    (`launch.specs`) read `moments_dtype`. The scan knobs (`pair_scan`,
    `scan_layers`) have no effect in a port whose layers run in a Python
    loop with a static window each."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    # attention variants
    sliding_window: int | None = None  # local attention window
    local_global_alternating: bool = False  # gemma-2: even layers local
    attn_logit_softcap: float | None = None  # gemma-2: 50.0
    final_logit_softcap: float | None = None  # gemma-2: 30.0
    rope_theta: float = 10_000.0
    # MoE (num_experts == 0 -> dense)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int | None = None  # expert hidden size (d_ff used for dense part)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # activation / norm
    gated_act: Literal["silu", "gelu"] = "silu"
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # numerics / memory policy
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # variants
    use_flash_kernel: bool = False  # the flash-attention kernel (K9)
    flash_axes: tuple = ()  # the reference's shard_map batch axes
    decode_gqa_einsum: bool = False  # grouped-einsum GQA decode (no KV repeat)
    pair_scan: bool = False  # the reference's (local, global) pair scan
    # training
    microbatch: int = 0  # 0 = no gradient accumulation
    moments_dtype: str = "float32"

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        d, dh = self.d_model, self.dh
        attn = d * self.num_heads * dh + 2 * d * self.num_kv_heads * dh + self.num_heads * dh * d
        if self.num_experts:
            eff = self.moe_d_ff or self.d_ff
            ffn = self.num_experts * 3 * d * eff
            if self.dense_residual:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        eff = self.moe_d_ff or self.d_ff
        full_ffn = self.num_experts * 3 * d * eff
        active_ffn = self.num_experts_per_tok * 3 * d * eff
        return self.param_count() - self.num_layers * (full_ffn - active_ffn)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    num_layers: int = 16
    d_hidden: int = 512
    aggregator: str = "sum"
    n_vars: int = 227  # output variables per node (GraphCast)
    mesh_refinement: int = 6  # recorded; input graphs are provided per cell
    d_feat: int = 128  # input node feature dim (overridden per shape cell)
    dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True


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


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell, the reference's
    fields."""

    name: str
    kind: str  # train | prefill | decode | serve | retrieval | graph
    seq_len: int = 0
    global_batch: int = 0
    # gnn fields
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    # recsys fields
    n_candidates: int = 0
