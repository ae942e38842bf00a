"""Roofline-drift monitor: measured step time against an analytic model.

`predict_step_bytes(plan, ...)` evaluates the byte models at the plan's
resolved shape into one predicted per-step count of device-memory
bytes, and `predict_step_seconds` divides it by the card's memory rate.
`DriftMonitor` then tracks the run against it:

  * the first ``calibration_steps`` measured step times (after
    ``skip_steps`` warm-up steps, which carry the kernels' first builds
    and launches) set a baseline scale: the model counts bytes only,
    and a step that waits on the host (a launch-bound step does) sits
    far above it, so drift is tracked against the run's own calibrated
    baseline, and the shape scaling is the signal;
  * each later step folds measured / predicted / scale into an EMA
    drift ratio (1.0 = tracking the model). When the EMA leaves the
    band the monitor emits ONE warning event and stays quiet until the
    ratio comes back inside the narrower re-arm band (hysteresis, no
    warning spam at the edge).

The byte formulas are the reference's analytic models
(`benchmarks/roofline.py`: `snis_hbm_bytes`, the sampler term of
`dist_comms_model` at one model shard, `ivf_query_model`'s per-route
bytes), kept here so the port imports nothing of the reference; at the
same plan shape they give the same counts. The memory rate is the H100
SXM's, 3.35 TB/s.

`jaxpr_step_bytes(fn, *args)` is the reference's cross-check of that
model: the bytes of one run of ``fn(*args)`` through the op walker
(`launch.jaxpr_cost.analyze`), which costs each kernel by its rule.
Meta arguments trace without the card and give the same count as real
ones on any device.
"""
from __future__ import annotations

import dataclasses
import statistics

__all__ = [
    "DriftConfig",
    "DriftMonitor",
    "HBM_BYTES_PER_S",
    "ivf_query_bytes",
    "jaxpr_step_bytes",
    "predict_step_bytes",
    "predict_step_seconds",
    "sampler_hbm_bytes",
    "snis_hbm_bytes",
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Knobs of the roofline-drift monitor.

    band               relative EMA excursion from the calibrated
                       baseline that triggers a warning (0.5 = warn when
                       the EMA drift ratio leaves [0.5, 1.5])
    ema_decay          decay of the drift-ratio EMA
    calibration_steps  measured steps folded into the baseline scale
                       before the monitor arms
    skip_steps         leading measurements discarded before calibration
                       starts: step 0 carries the kernels' builds and
                       first launches and would otherwise poison the
                       baseline into a false "fast" excursion
    rearm_frac         an excursion ends (re-arming the warning) once
                       |EMA - 1| falls back under band * rearm_frac: the
                       hysteresis gap that prevents warning spam
    """

    band: float = 0.5
    ema_decay: float = 0.9
    calibration_steps: int = 5
    skip_steps: int = 1
    rearm_frac: float = 0.6

    def __post_init__(self):
        if self.band <= 0:
            raise ValueError(f"band must be > 0, got {self.band}")
        if self.skip_steps < 0:
            raise ValueError(f"skip_steps must be >= 0, got {self.skip_steps}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must lie in (0, 1), got {self.ema_decay}")
        if self.calibration_steps < 1:
            raise ValueError(
                f"calibration_steps must be >= 1, got {self.calibration_steps}"
            )
        if not 0.0 < self.rearm_frac < 1.0:
            raise ValueError(
                f"rearm_frac must lie in (0, 1), got {self.rearm_frac}"
            )


class DriftMonitor:
    """Feed it measured per-step seconds; it answers with a warning
    event exactly once per excursion outside the band (None otherwise).
    `ema` is the current drift ratio (None until calibrated)."""

    def __init__(self, predicted_s: float, cfg: DriftConfig = DriftConfig()):
        if predicted_s <= 0:
            raise ValueError(f"predicted_s must be > 0, got {predicted_s}")
        self.predicted_s = predicted_s
        self.cfg = cfg
        self._skip = cfg.skip_steps
        self._cal: list[float] = []
        self.scale: float | None = None  # calibrated baseline ratio
        self.ema: float | None = None
        self._excursion = False
        self.warnings = 0

    def observe(self, measured_s: float) -> dict | None:
        if self._skip > 0:  # warm-up steps: not even calibration
            self._skip -= 1
            return None
        raw = measured_s / self.predicted_s
        if self.scale is None:
            self._cal.append(raw)
            if len(self._cal) >= self.cfg.calibration_steps:
                self.scale = statistics.median(self._cal)
            return None
        r = raw / self.scale
        d = self.cfg.ema_decay
        self.ema = r if self.ema is None else d * self.ema + (1.0 - d) * r
        dev = self.ema - 1.0
        if not self._excursion and abs(dev) > self.cfg.band:
            self._excursion = True
            self.warnings += 1
            return {
                "event": "roofline_drift",
                "direction": "slow" if dev > 0 else "fast",
                "ema": self.ema,
                "ratio": r,
                "band": self.cfg.band,
            }
        if self._excursion and abs(dev) < self.cfg.band * self.cfg.rearm_frac:
            self._excursion = False
        return None


# ---------------------------------------------------------------------------
# the byte models (the reference's formulas)
# ---------------------------------------------------------------------------

def snis_hbm_bytes(b: int, s: int, l: int, *, fused: bool, dtype_bytes: int = 4) -> int:
    """Device-memory bytes of one SNIS + covariance-gradient step. Fused:
    the beta rows are read once and only (B, S) / (B, L) tensors touch
    memory; unfused, the gather also writes the (B, S, L) embeddings and
    the weighting chain reads them back."""
    gather_read = b * s * l
    small = 4 * b * s + b * s + 2 * b * l  # scores/logq/rewards/actions + wbar + h/grad
    if fused:
        return dtype_bytes * (gather_read + small)
    return dtype_bytes * (gather_read + 2 * b * s * l + small)


def sampler_hbm_bytes(b: int, s: int, k: int, *, fused_sampler: bool,
                      dtype_bytes: int = 4) -> int:
    """The mixture's (B, S, K) Gumbel tensor, written and read back by
    its argmax; the in-kernel sampler keeps its draws on chip (0)."""
    return 0 if fused_sampler else 2 * b * s * k * dtype_bytes


def ivf_query_bytes(
    b: int, l: int, p: int, *, c: int, n_probe: int, cap: int, k: int,
    dtype_bytes: int = 4,
) -> dict:
    """Device-memory bytes of one MIPS query batch by retriever route:
    exact writes and reads back the (B, P) scores; streaming and pallas
    read beta once and carry the top-K; ivf gathers the (B, n_probe *
    cap, L) candidates into memory and reads them back; ivf_pallas
    streams each probed list once."""
    topk_out = 2 * b * k
    exact = p * l + 2 * b * p + topk_out
    streaming = p * l + topk_out
    centroid_stage = c * l + 2 * b * c
    cand = b * n_probe * cap
    ivf_jnp = centroid_stage + 3 * cand * l + cand + 2 * cand + topk_out
    ivf_pallas = centroid_stage + cand * (l + 1) + topk_out
    return {
        "exact_bytes": dtype_bytes * exact,
        "streaming_bytes": dtype_bytes * streaming,
        "ivf_jnp_bytes": dtype_bytes * ivf_jnp,
        "ivf_pallas_bytes": dtype_bytes * ivf_pallas,
    }


def predict_step_bytes(plan, batch_size: int, embed_dim: int) -> dict:
    """The byte models at the plan's resolved shape, per step. The port
    runs on one device, so the comms term is 0."""
    cfg = plan.cfg
    b, s, k, p = batch_size, cfg.num_samples, cfg.top_k, cfg.num_items
    l = embed_dim
    snis = snis_hbm_bytes(b, s, l, fused=plan.fused)
    sampler = sampler_hbm_bytes(b, s, k, fused_sampler=plan.fused_sampler)
    retrieval = _retrieval_bytes(cfg.retriever, b, l, p, k)
    comms = 0
    return {
        "snis_bytes": snis,
        "sampler_bytes": sampler,
        "retrieval_bytes": retrieval,
        "comms_bytes": comms,
        "total_bytes": snis + sampler + retrieval + comms,
    }


def _retrieval_bytes(route: str, b: int, l: int, p: int, k: int) -> int:
    """Per-batch retrieval bytes by route. The IVF routes use the
    canonical C ~ sqrt(P) build and n_probe 2, not the built index's
    (C, cap): calibration absorbs the constant, drift tracks scaling."""
    c = max(1, int(round(p ** 0.5)))
    cap = max(1, -(-p // c) * 2)
    m = ivf_query_bytes(b, l, p, c=c, n_probe=2, cap=cap, k=k)
    if route == "exact":
        return m["exact_bytes"]
    if route == "ivf":
        return m["ivf_jnp_bytes"]
    if route == "ivf_pallas":
        return m["ivf_pallas_bytes"]
    # streaming / pallas: one beta pass, carried top-K
    return m["streaming_bytes"]


def predict_step_seconds(
    plan, batch_size: int, embed_dim: int, *, hbm_bw: float = HBM_BYTES_PER_S
) -> float:
    """Memory-bound time of one step: the predicted bytes over the
    card's memory rate. `DriftMonitor` calibrates the constant away."""
    return predict_step_bytes(plan, batch_size, embed_dim)["total_bytes"] / hbm_bw


def jaxpr_step_bytes(fn, *args) -> float | None:
    """Cross-check: the bytes of ``fn(*args)`` from the op walker
    (`repro_torch.launch.jaxpr_cost.analyze`), the program's I/O
    included. Heavier than the closed-form models (one traced run), so
    call it once per plan, not per step. ``args`` may be meta tensors
    (nothing runs) or real ones on any device. None when the run fails."""
    try:
        from repro_torch.launch.jaxpr_cost import analyze

        return float(analyze(fn, *args)["bytes"])
    except Exception:
        return None
