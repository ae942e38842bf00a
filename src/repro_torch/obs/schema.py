"""The history schema: every key the trainer emits, with its kind.

The reference's `repro/obs/schema.py`, copied: `FOPOTrainer.train`
returns a ``history`` dict in the same form as the reference's,
`empty_history` gives its canonical empty shape, `validate_history`
rejects undeclared keys, and `history_from_records` folds the bus's
drained records (through a `RingSink`) back into the dict. The serving
engine's and the cluster dispatcher's keys are bus-only: they ride the
JSONL stream and the report's Serving and Cluster sections, not the
history.
"""
from __future__ import annotations

__all__ = [
    "EVENT_KEYS",
    "HISTORY_SCHEMA",
    "SCALAR_KEYS",
    "SERIES_KEYS",
    "SERVE_CLUSTER_COUNTER_KEYS",
    "SERVE_CLUSTER_TIMING_KEYS",
    "SERVE_GAUGE_KEYS",
    "SERVE_TIMING_KEYS",
    "empty_history",
    "history_from_records",
    "validate_history",
]

# key -> (kind, description). kinds: series (per-step float list),
# events (list of payload dicts), evals ((step, value) tuple list),
# scalar (single float set at run end).
HISTORY_SCHEMA: dict[str, tuple[str, str]] = {
    "loss": ("series", "per-step scalar loss"),
    "step_time": ("series", "per-step wall seconds (dispatch -> blocked)"),
    "ess": ("series", "batch-mean SNIS effective sample size (DIAGNOSTIC_KEYS)"),
    "rbar": ("series", "batch-mean SNIS reward estimate (DIAGNOSTIC_KEYS)"),
    "max_wbar": ("series", "batch-mean max normalised SNIS weight (DIAGNOSTIC_KEYS)"),
    "drift": ("series", "roofline-drift EMA ratio (obs drift monitor armed)"),
    "reward": ("evals", "(step, R_test) from eval_every evaluations"),
    "health": ("events", "guard verdicts: {step, verdict, checks}"),
    "events": ("events", "trainer lifecycle: rollbacks {step, event, to, restarts}"),
    "index_health": ("events", "ladder probes: {step, recall, overflow, action}"),
    "drift_events": ("events", "roofline-drift excursion warnings"),
    "total_time": ("scalar", "wall seconds of the whole train() call"),
}

SERIES_KEYS = tuple(k for k, (kind, _) in HISTORY_SCHEMA.items() if kind == "series")
EVENT_KEYS = tuple(k for k, (kind, _) in HISTORY_SCHEMA.items() if kind == "events")
SCALAR_KEYS = tuple(k for k, (kind, _) in HISTORY_SCHEMA.items() if kind == "scalar")

# the serving engine's metrics (repro_torch.serve.engine), bus-only
SERVE_TIMING_KEYS = ("serve_queue_wait", "serve_latency", "serve_batch_service")
SERVE_GAUGE_KEYS = ("serve_batch_size", "serve_occupancy")

# the cluster dispatcher's metrics (repro_torch.serve.cluster), bus-only:
# the counters tell the chaos story; the timings are a request's cluster
# view (original arrival -> winning finish, retries and backoff
# included), where the engine's serve_latency is one attempt's
SERVE_CLUSTER_COUNTER_KEYS = (
    "serve_requests",
    "serve_abandoned",
    "serve_retries",
    "serve_hedges",
    "serve_timeouts",
    "serve_deadline_misses",
    "serve_replica_deaths",
    "serve_rebalances",
    "serve_readmissions",
)
SERVE_CLUSTER_TIMING_KEYS = ("serve_cluster_latency", "serve_cluster_queue_wait")

def empty_history() -> dict:
    """The canonical shape: every declared list key present and empty
    (consumers index history["health"] etc. without guards)."""
    return {k: [] for k, (kind, _) in HISTORY_SCHEMA.items() if kind != "scalar"}


def validate_history(history: dict) -> dict:
    """Reject undeclared keys — the regression gate against silent
    metric loss. Returns the history unchanged so callers can chain."""
    unknown = set(history) - set(HISTORY_SCHEMA)
    if unknown:
        raise KeyError(
            f"history keys {sorted(unknown)} are not declared in "
            "repro.obs.schema.HISTORY_SCHEMA — declare them (with a kind "
            "and description) or stop emitting them; undeclared keys rot"
        )
    return history


def history_from_records(records) -> dict:
    """Fold a drained record stream (bus -> RingSink) back into the
    history dict shape. Records whose names aren't schema keys (bus-only
    metrics like probe gauges or serve timings) are simply not part of
    the history view."""
    h = empty_history()
    for rec in records:
        name, kind = rec.get("name"), rec.get("kind")
        if name in SERIES_KEYS and kind in ("gauge", "timing"):
            h[name].append(rec["value"])
        elif name == "reward" and kind == "event":
            p = rec["value"]
            h["reward"].append((p["step"], p["value"]))
        elif name in EVENT_KEYS and kind == "event":
            h[name].append(rec["value"])
    return h
