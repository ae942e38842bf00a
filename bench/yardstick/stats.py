"""Order statistics of a run's samples."""
from __future__ import annotations

__all__ = ["percentile"]


def percentile(values: list[float], p: float) -> float:
    """The sample at rank round(p / 100 * (n - 1)) of the sorted values
    (`chip_smoke.py:percentile`)."""
    vs = sorted(values)
    if not vs:
        raise ValueError("no samples")
    return vs[min(len(vs) - 1, max(0, round(p / 100.0 * (len(vs) - 1))))]
