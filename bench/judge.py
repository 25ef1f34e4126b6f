"""The comparison that decides ``correct``.

A driver's ``compare`` gives, for one checked job, each row's gap from the
reference: kNN the largest relative gap of its k nearest distances (the
reduce's merged top-k), infinite where its vote differs; CF the largest
absolute gap of its predictions, in stars.  A row is off when its gap
exceeds the cell's ``row_tol``.  The number compared, ``rows_off``, is the
share of rows off in the worst checked job; its limit is the cell's.  Why
those tolerances and limits: PERF.md, section 2.
"""
from __future__ import annotations

import math

import torch


def summarize(gaps: list[torch.Tensor], row_tol: float) -> dict:
    """Numbers of a run's checked jobs, each [rows] float64 gaps."""
    shares = [float((g > row_tol).double().mean()) for g in gaps]
    every = torch.cat(gaps)
    finite = every[torch.isfinite(every)]
    return {
        "rows_off": max(shares),
        "widest_finite_gap": float(finite.max()) if finite.numel() else 0.0,
        "rows_unbounded": int((~torch.isfinite(every)).sum()),
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}})."""
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
