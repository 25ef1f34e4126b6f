"""BENCH regression gate: compare a fresh combined BENCH json to a baseline,
as ``src/repro/obs/regression.py`` does (the port keeps its own copy; the
module has no device code).

The perf trajectory is only a trajectory if something refuses to let it
slide.  ``compare(baseline, current)`` walks a declarative list of
``MetricSpec``s — dotted paths into the combined BENCH dict, each with a
better-direction and a noise tolerance — and classifies every metric:

  * ``regression``  — past the tolerance band in the bad direction (gating
    specs make the report fail);
  * ``improved``    — past the band in the good direction;
  * ``ok``          — inside the band;
  * ``missing``     — the path is absent on either side (never gating:
    suites come and go, tiny mode skips some fields).

Tolerance is ``base * (1 +/- tolerance * slack) +/- absolute * slack`` —
relative for scale-free noise, absolute for sub-millisecond latencies
where relative bands collapse, and ``slack`` scales both for noisy
environments (cross-run comparisons pass ``slack > 1``; the
injected-regression check uses the default 1.0 against identical inputs).
The boundary itself passes: a value exactly at the limit is ``ok``, one
strictly past it regresses — the edge the gate tests pin.

Watch metrics (``WATCH_EXTRACTORS``) are recorded but never gate: the
measured wall-clock kernel speedups and the kernel probe's measured p50s
live here, so measured times are visible in every comparison beside the
modeled-bytes gate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One gated metric: where it lives, which way is better, how much
    noise to forgive."""

    path: str                  # dotted path into the combined BENCH dict
    direction: str = "lower"   # "lower" | "higher" is better
    tolerance: float = 0.15    # relative band
    absolute: float = 0.0      # additive band (same unit as the metric)
    gating: bool = True

    def __post_init__(self):
        if self.direction not in ("lower", "higher"):
            raise ValueError(f"direction {self.direction!r}")
        if self.tolerance < 0 or self.absolute < 0:
            raise ValueError("tolerances must be non-negative")


# The default gate over the combined BENCH json (benchmarks/run.py).
# Latency specs carry an absolute band because tiny-mode p50s are a few ms
# and scheduler noise is additive, not proportional.
DEFAULT_SPECS: tuple[MetricSpec, ...] = (
    MetricSpec("serve_latency.stage1_latency_ms.p50",
               "lower", tolerance=0.15, absolute=1.0),
    MetricSpec("serve_latency.stage1_latency_ms.p99",
               "lower", tolerance=0.35, absolute=2.0),
    MetricSpec("serve_latency.total_latency_ms.p50",
               "lower", tolerance=0.15, absolute=1.0),
    MetricSpec("serve_latency.total_latency_ms.p99",
               "lower", tolerance=0.35, absolute=2.0),
    MetricSpec("serve_latency.deadline_met_rate",
               "higher", tolerance=0.0, absolute=0.10),
    MetricSpec("serve_latency.cache.hit_rate",
               "higher", tolerance=0.0, absolute=0.05),
    # Modeled-bytes reductions are deterministic functions of shapes: any
    # drift is a real change, not noise.
    MetricSpec("kernel_bench.stage1_bytes_reduction",
               "higher", tolerance=0.01),
    MetricSpec("kernel_bench.stage2_bytes_reduction",
               "higher", tolerance=0.01),
    MetricSpec("store_reuse.merge_speedup",
               "higher", tolerance=0.35, absolute=0.5),
    # Graceful-degradation contract (benchmarks/chaos_soak.py): deadline
    # attainment under one killed shard relative to the healthy phase,
    # shed-strictly-before-reject ordering, and zero silent drops.  These
    # are near-boolean curves — small absolute bands, no relative slack.
    MetricSpec("chaos_soak.deadline_met_under_fault_ratio",
               "higher", tolerance=0.0, absolute=0.05),
    MetricSpec("chaos_soak.deadline_met_under_overload_ratio",
               "higher", tolerance=0.0, absolute=0.05),
    MetricSpec("chaos_soak.shed_before_reject",
               "higher", tolerance=0.0),
    MetricSpec("chaos_soak.answered_fraction",
               "higher", tolerance=0.0),
    # Error-bound honesty (benchmarks/error_bounds.py): worst-case claimed-CI
    # coverage against exact results must never slide below the stated
    # confidence, and the accuracy-SLO skip path must keep buying latency.
    # Coverage is a fraction of queries — absolute band, no relative slack.
    MetricSpec("error_bounds.knn_coverage",
               "higher", tolerance=0.0, absolute=0.05),
    MetricSpec("error_bounds.cf_coverage",
               "higher", tolerance=0.0, absolute=0.05),
    MetricSpec("error_bounds.serving.latency_win",
               "higher", tolerance=0.35, absolute=0.5),
    # Decode-engine contract (benchmarks/decode_bench.py): full-refine
    # aggregated decode bit-matches exact attention (boolean — no band),
    # throughput stays put, and the stage-1 logit divergence from exact
    # must not grow (it is a deterministic function of the aggregation,
    # so only a tiny absolute band for float noise).
    MetricSpec("decode_bench.exact_match_at_full_refine",
               "higher", tolerance=0.0),
    MetricSpec("decode_bench.levels.p0.tokens_per_s",
               "higher", tolerance=0.35, absolute=2.0),
    MetricSpec("decode_bench.levels.p100.tokens_per_s",
               "higher", tolerance=0.35, absolute=2.0),
    MetricSpec("decode_bench.levels.p0.kl_vs_exact",
               "lower", tolerance=0.05, absolute=1e-4),
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One compared metric's outcome."""

    path: str
    status: str                # "ok" | "regression" | "improved" | "missing"
    baseline: float | None
    current: float | None
    direction: str
    gating: bool
    limit: float | None = None # the tolerance boundary that was applied

    @property
    def delta(self) -> float | None:
        if self.baseline is None or self.current is None:
            return None
        return self.current - self.baseline

    @property
    def ratio(self) -> float | None:
        if not self.baseline or self.current is None:
            return None
        return self.current / self.baseline

    def to_dict(self) -> dict:
        return {
            "path": self.path, "status": self.status,
            "baseline": self.baseline, "current": self.current,
            "direction": self.direction, "gating": self.gating,
            "limit": self.limit,
        }


def get_path(d: Any, path: str) -> Any:
    """Dotted-path lookup returning None when any segment is missing."""
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _as_number(v: Any) -> float | None:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    if math.isnan(v):
        return None
    return float(v)


def compare_metric(
    spec: MetricSpec, baseline: dict, current: dict, *, slack: float = 1.0,
) -> Finding:
    base = _as_number(get_path(baseline, spec.path))
    cur = _as_number(get_path(current, spec.path))
    if base is None or cur is None:
        return Finding(spec.path, "missing", base, cur,
                       spec.direction, spec.gating)
    rel = spec.tolerance * slack
    absolute = spec.absolute * slack
    if spec.direction == "lower":
        limit = base * (1.0 + rel) + absolute
        if cur > limit:
            status = "regression"
        elif cur < base * (1.0 - rel) - absolute:
            status = "improved"
        else:
            status = "ok"
    else:
        limit = base * (1.0 - rel) - absolute
        if cur < limit:
            status = "regression"
        elif cur > base * (1.0 + rel) + absolute:
            status = "improved"
        else:
            status = "ok"
    return Finding(spec.path, status, base, cur,
                   spec.direction, spec.gating, limit=limit)


# ---------------------------------------------------------------------------
# watch channel (recorded, never gating)
# ---------------------------------------------------------------------------

def _kernel_speedup_watch(combined: dict) -> dict[str, float]:
    """Measured wall-clock fused-vs-unfused speedups per stage and N."""
    out: dict[str, float] = {}
    for row in get_path(combined, "kernel_bench.sizes") or []:
        n = row.get("n")
        for stage in ("stage1", "stage2"):
            v = _as_number(row.get(stage, {}).get("speedup"))
            if v is not None:
                out[f"kernel_bench.{stage}_speedup_n{n}"] = v
    return out


def _kernel_measured_watch(combined: dict) -> dict[str, float]:
    """Kernel-probe measured p50 per (op, path[, shape]) dispatch."""
    out: dict[str, float] = {}
    measured = get_path(combined, "kernel_bench.measured") or {}
    for key, row in measured.items():
        v = _as_number(row.get("p50_s")) if isinstance(row, dict) else None
        if v is not None:
            out[f"kernel_bench.measured.{key}.p50_s"] = v
    return out


WATCH_EXTRACTORS: tuple[Callable[[dict], dict[str, float]], ...] = (
    _kernel_speedup_watch,
    _kernel_measured_watch,
)


@dataclasses.dataclass(frozen=True)
class WatchEntry:
    """Non-gating observed pair: here to be seen, not to fail builds."""

    name: str
    baseline: float | None
    current: float | None

    @property
    def ratio(self) -> float | None:
        if not self.baseline or self.current is None:
            return None
        return self.current / self.baseline

    def to_dict(self) -> dict:
        return {"name": self.name, "baseline": self.baseline,
                "current": self.current, "ratio": self.ratio}


def extract_watch(
    baseline: dict, current: dict,
    extractors: Sequence[Callable] = WATCH_EXTRACTORS,
) -> list[WatchEntry]:
    base_vals: dict[str, float] = {}
    cur_vals: dict[str, float] = {}
    for ex in extractors:
        base_vals.update(ex(baseline))
        cur_vals.update(ex(current))
    names = sorted(set(base_vals) | set(cur_vals))
    return [
        WatchEntry(n, base_vals.get(n), cur_vals.get(n)) for n in names
    ]


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Report:
    findings: list[Finding]
    watch: list[WatchEntry]
    slack: float = 1.0

    @property
    def regressions(self) -> list[Finding]:
        return [f for f in self.findings
                if f.status == "regression" and f.gating]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "slack": self.slack,
            "findings": [f.to_dict() for f in self.findings],
            "watch": [w.to_dict() for w in self.watch],
        }

    def render(self) -> str:
        lines = []
        order = {"regression": 0, "improved": 1, "ok": 2, "missing": 3}
        for f in sorted(self.findings, key=lambda f: order[f.status]):
            tag = f.status.upper() if f.status == "regression" else f.status
            if f.baseline is None or f.current is None:
                lines.append(f"{tag:>10}  {f.path}  (absent)")
                continue
            arrow = "<=" if f.direction == "lower" else ">="
            lines.append(
                f"{tag:>10}  {f.path}  {f.baseline:.6g} -> {f.current:.6g}"
                f"  (limit {arrow} {f.limit:.6g})"
            )
        if self.watch:
            lines.append("watch (non-gating measured-time channel):")
            for w in self.watch:
                b = "-" if w.baseline is None else f"{w.baseline:.6g}"
                c = "-" if w.current is None else f"{w.current:.6g}"
                r = "" if w.ratio is None else f"  ({w.ratio:.2f}x)"
                lines.append(f"     watch  {w.name}  {b} -> {c}{r}")
        verdict = "PASS" if self.ok else (
            f"FAIL: {len(self.regressions)} gating regression(s)"
        )
        lines.append(verdict)
        return "\n".join(lines)


def compare(
    baseline: dict,
    current: dict,
    specs: Sequence[MetricSpec] = DEFAULT_SPECS,
    *,
    slack: float = 1.0,
) -> Report:
    """Compare two combined BENCH dicts; the report fails on any gating
    metric past its tolerance band in the bad direction."""
    if slack <= 0:
        raise ValueError("slack must be positive")
    findings = [
        compare_metric(spec, baseline, current, slack=slack)
        for spec in specs
    ]
    return Report(findings, extract_watch(baseline, current), slack=slack)
