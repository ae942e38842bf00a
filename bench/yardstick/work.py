"""The work a call needs, counted from its shapes and its data: FLOPs
from the algorithm and bytes with each input read once and each output
written once, whatever a given kernel reads again. Frozen here from
`repro_torch.kernels.mips_topk.kernel.mips_topk_work`,
`repro_torch.kernels.ivf_topk.kernel.ivf_probe_work` (there every
query's probed lists count; here a list the batch probes is read once)
and `repro_torch.launch.costs.recsys_model_flops` (there SASRec is
charged an output projection it does not have; here its blocks count
what `sasrec_user_vector` computes)."""
from __future__ import annotations

__all__ = [
    "centroid_stage_flops", "fopo_ivf_step_flops", "fopo_step_flops", "ivf_probe", "mips_topk",
    "sasrec_tower_flops",
]

F32 = 4  # bytes of an fp32 value or an int32 id


def mips_topk(b: int, p: int, l: int, k: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the exact top-K of [B, L] queries against [P, L]
    items: 2 B P L, the items and queries read once, [B, K] scores and
    ids written."""
    return 2.0 * b * p * l, float(F32 * (p * l + b * l + 2 * b * k))


def fopo_step_flops(b: int, p: int, l: int, s: int) -> float:
    """Useful FLOPs of one FOPO step of a linear tower h = x W ([L, L]):
    the tower forward (2 B L^2), the scoring of the catalog for the
    top-K (2 B P L), the S sampled scores (2 B S L), their gradient into
    h (2 B S L) and the weight gradient x^T dh (2 B L^2)."""
    return 2.0 * b * p * l + 4.0 * b * s * l + 4.0 * b * l * l


def fopo_ivf_step_flops(b: int, l: int, s: int, c: int, probed_live: float) -> float:
    """Useful FLOPs of one FOPO step of the linear tower on the IVF
    route: `fopo_step_flops` with the catalog's scoring replaced by the
    centroid stage (2 B C L) and 2 L for each probed live candidate of
    each query (``probed_live`` summed over the batch)."""
    return 2.0 * b * c * l + 2.0 * l * probed_live + 4.0 * b * s * l + 4.0 * b * l * l


def sasrec_tower_flops(b: int, t: int, d: int, blocks: int) -> float:
    """FLOPs of SASRec's user tower over [B, T] histories, every position
    computed as `sasrec_user_vector` does: per block the q, k, v
    projections (3 x 2 T D^2), the scores and the weighted values
    (2 x 2 T^2 D) and the two-layer feed-forward (2 x 2 T D^2)."""
    return float(b) * blocks * (10.0 * t * d * d + 4.0 * t * t * d)


def centroid_stage_flops(b: int, c: int, l: int) -> float:
    """FLOPs of the IVF centroid stage: [B, L] queries against C centroids."""
    return 2.0 * b * c * l


def ivf_probe(b: int, l: int, k: int, n_probe: int, union_live: float,
              probed_live: float) -> tuple[float, float]:
    """(FLOPs, bytes) of the IVF probe of one batch: 2 L FLOPs for each
    live candidate of each query (``probed_live`` summed over the
    queries); bytes are the ids and embeddings of the live rows of the
    lists the batch probes, each read once (``union_live`` rows), the
    queries and probe ids read, and the [B, K] scores and ids written."""
    nbytes = union_live * F32 * (l + 1) + b * F32 * (l + n_probe + 2 * k)
    return 2.0 * l * probed_live, float(nbytes)
