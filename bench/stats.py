"""Statistics of a measured window and of a set of runs."""
from __future__ import annotations

import math
import statistics


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95 % of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def window_metrics(job_s: list[float], window_s: float) -> dict:
    """End-to-end metrics of one closed-loop window: every job completed in
    it over all its seconds, and the tail of every job's time."""
    if not job_s or window_s <= 0:
        raise ValueError("a window with no completed job")
    return {"jobs_per_s": len(job_s) / window_s,
            "job_p95_ms": p95(job_s) * 1e3}


def spread(values: list[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (Python's default quartiles)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
