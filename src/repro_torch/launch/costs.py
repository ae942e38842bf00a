"""Roofline arithmetic: the card's constants and the MODEL_FLOPS
(useful-work) estimators per shape cell (the reference's
`repro/launch/costs.py`, but for its HLO collective-byte parser, which
comes with the dry run).

Hardware: one NVIDIA H100 SXM. The constants are NVIDIA's datasheet
figures at the 700 W power limit, not measurements: 989 TFLOP/s dense
bf16 on the tensor cores, 3.35 TB/s HBM (`obs.drift.HBM_BYTES_PER_S`,
defined once), 450 GB/s NVLink each direction. The estimators count
FLOPs from the configuration and the cell alone, as the reference's do.
"""
from __future__ import annotations

from repro_torch.obs.drift import HBM_BYTES_PER_S

__all__ = [
    "HBM_BW",
    "LINK_BW",
    "PEAK_FLOPS",
    "gnn_model_flops",
    "lm_model_flops",
    "recsys_model_flops",
    "roofline_terms",
]

PEAK_FLOPS = 989e12  # bf16 FLOP/s, dense, tensor cores (H100 SXM datasheet)
HBM_BW = HBM_BYTES_PER_S  # bytes/s (H100 SXM datasheet)
LINK_BW = 450e9  # NVLink bytes/s each direction (H100 SXM datasheet)


# ---------------------------------------------------------------------------
# MODEL_FLOPS estimators (useful work, excl. framework overhead/remat)
# ---------------------------------------------------------------------------

def lm_model_flops(cfg, cell) -> float:
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    if cell.kind == "decode":
        return 2.0 * n_active * cell.global_batch
    raise ValueError(cell.kind)


def gnn_model_flops(cfg, cell) -> float:
    """Training FLOPs of one step (3x the forward): a sampled minibatch
    counts its worst-case subgraph, batched graphs their block-diagonal
    union."""
    dh = cfg.d_hidden
    n = cell.n_nodes if not cell.global_batch else cell.n_nodes * cell.global_batch
    if cell.batch_nodes:  # sampled minibatch: subgraph sizes
        n_sub = cell.batch_nodes * (1 + cell.fanout[0] + cell.fanout[0] * cell.fanout[1])
        e_sub = cell.batch_nodes * (cell.fanout[0] + cell.fanout[0] * cell.fanout[1])
        n, e = n_sub, e_sub
    else:
        e = cell.n_edges if not cell.global_batch else cell.n_edges * cell.global_batch
    per_layer = e * 2 * (2 * dh * dh + dh * dh) + n * 2 * (2 * dh * dh + dh * dh)
    enc = n * 2 * (cell.d_feat * dh + dh * dh)
    dec = n * 2 * (dh * dh + dh * cfg.n_vars)
    fwd = cfg.num_layers * per_layer + enc + dec
    return 3.0 * fwd  # full-batch/minibatch cells are training cells


def _mlp_flops(dims) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def recsys_model_flops(cfg, cell) -> float:
    d = cfg.embed_dim
    if cfg.kind == "din":
        attn = cfg.seq_len * _mlp_flops((4 * d,) + cfg.attn_mlp_dims + (1,))
        top = _mlp_flops((2 * d,) + cfg.mlp_dims + (1,))
        per = attn + top
    elif cfg.kind == "dien":
        g = cfg.gru_dim
        gru = cfg.seq_len * 2 * (3 * (d + g) * g + 3 * (g + g) * g)
        per = gru + _mlp_flops((g + d,) + cfg.mlp_dims + (1,))
    elif cfg.kind == "sasrec":
        t = cfg.seq_len
        blocks = cfg.num_blocks * (4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * t * 2 * d * d)
        per = blocks / 1.0
    elif cfg.kind == "wide_deep":
        per = _mlp_flops((cfg.n_sparse * d + cfg.n_dense,) + cfg.mlp_dims + (1,))
    else:
        raise ValueError(cfg.kind)
    if cell.kind == "train":
        return 3.0 * per * cell.global_batch
    if cell.kind == "serve":
        return per * cell.global_batch
    if cell.kind == "retrieval":
        if cfg.kind == "din":
            return per * cell.n_candidates
        return 2.0 * d * cell.n_candidates  # dot-product scoring
    raise ValueError(cell.kind)


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    coll_bytes: float,
    chips: int,
) -> dict:
    """The reference's roofline split under the card's constants: compute,
    memory and collective seconds, the dominant term, the bound and the
    compute share of it. (The first argument's name is the reference's;
    any count of FLOPs does.)"""
    compute_s = hlo_flops / (chips * PEAK_FLOPS)
    memory_s = hlo_bytes / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * LINK_BW)
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    bound = max(compute_s, memory_s, collective_s)
    terms["step_time_lower_bound_s"] = bound
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms
