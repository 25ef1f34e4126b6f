"""Serving metrics: latency percentiles, granted eps, cache hits, shuffle bytes.

Reimplemented on ``repro_torch.obs.metrics.MetricsRegistry`` so the serving path
shares one metrics vocabulary with the kernel probes and the runtime, and so
memory stays flat under sustained load: per-request latency/eps samples land
in bounded reservoirs (Vitter algorithm R) instead of the unbounded Python
lists the first version kept.  Exact count/sum/min/max survive sampling, so
``summary()`` is unchanged for small runs and statistically faithful for
long ones.

Latency is recorded twice per the anytime contract: ``stage1_latency_s``
(admission -> initial answer) and ``total_latency_s`` (admission -> best
answer), so the accuracy-vs-deadline trade-off the paper plots offline falls
out of the serving path directly.  New in this layer: the accuracy-proxy
channel (stage-1 vs refined divergence per request, when the servable can
compute it) and cache-source attribution (hit / built / merged / restored).

Each ``ServeMetrics`` owns a *private* registry — two servers in one process
must never share counters.  ``snapshot()``/``to_prometheus()`` export it.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Sequence

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.metrics import percentile as _percentile
from repro_torch.obs.timeseries import WindowedRollup
from repro_torch.serve.request import Response

# Per-series retained samples; exact stats are kept regardless (algorithm R).
RESERVOIR_CAPACITY = 4096

# Deadline -> coarse SLO class label (for per-class attainment series).
_SLO_CLASSES = ((0.01, "lt10ms"), (0.1, "lt100ms"), (1.0, "lt1s"))


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (p in [0, 100]); nan on empty input."""
    return _percentile(values, p)


def slo_class(deadline_s: float) -> str:
    for bound, name in _SLO_CLASSES:
        if deadline_s < bound:
            return name
    return "ge1s"


class ServeMetrics:
    """Accumulates per-request records and batch-level counters.

    Rates in ``summary()`` follow the re-execution rule: re-execution rows
    carry a server-invented relaxed deadline; they are real work (latency,
    eps, shuffle) but must not count toward SLO attainment or request
    volume — that would double-count every escalated request and flatter
    ``deadline_met_rate``.
    """

    def __init__(
        self,
        *,
        capacity: int = RESERVOIR_CAPACITY,
        window_s: float | None = None,
        max_windows: int = 64,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.registry = MetricsRegistry()
        # Optional time axis: lifetime reservoirs answer "since startup",
        # the rollup answers "in the last N seconds" (the SLO monitor's
        # input).  Off by default — a server without window_s pays nothing.
        self.rollup: WindowedRollup | None = (
            WindowedRollup(window_s, max_windows=max_windows, clock=clock)
            if window_s is not None else None
        )
        r = self.registry
        self._responses = r.counter(
            "serve_responses_total", "Responses emitted (incl. re-executions).",
            labels=("kind",),
        )
        self._reexecutions = r.counter(
            "serve_reexecutions_total", "Escalation re-execution responses.",
            labels=("kind",),
        )
        self._refined = r.counter(
            "serve_refined_total", "Responses carrying a stage-2 answer.",
            labels=("kind",),
        )
        self._deadline_met = r.counter(
            "serve_deadline_met_total",
            "First responses whose stage-1 answer beat the SLO.",
            labels=("kind", "slo"),
        )
        self._slo_seen = r.counter(
            "serve_requests_total",
            "First responses by servable kind and SLO class.",
            labels=("kind", "slo"),
        )
        self._escalated = r.counter(
            "serve_escalated_total",
            "First responses whose grant fell below the eps floor.",
            labels=("kind",),
        )
        self._batches = r.counter(
            "serve_batches_total", "Executed batches."
        )
        self._shuffle = r.counter(
            "serve_shuffle_bytes_total",
            "Map->reduce shuffle bytes metered by the engine.",
        )
        self._occupancy = r.counter(
            "serve_batch_occupancy_total",
            "Real (un-padded) requests packed into executed batches.",
        )
        self._partial = r.counter(
            "serve_partial_total",
            "Responses merged from surviving failure domains only "
            "(degraded, not error).",
            labels=("kind",),
        )
        self._cache_source = r.counter(
            "serve_cache_source_total",
            "Aggregate lookups by source (hit/built/merged/restored).",
            labels=("source",),
        )
        self._stage1_ms = r.reservoir(
            "serve_stage1_latency_ms", "Admission -> stage-1 answer (ms).",
            labels=("kind",), capacity=capacity,
        )
        self._total_ms = r.reservoir(
            "serve_total_latency_ms", "Admission -> best answer (ms).",
            labels=("kind",), capacity=capacity,
        )
        self._eps = r.reservoir(
            "serve_eps_granted", "Refinement fraction granted per response.",
            labels=("kind",), capacity=capacity,
        )
        self._accuracy = r.reservoir(
            "serve_accuracy_proxy",
            "Stage-1 vs refined divergence (0 = refinement changed nothing).",
            labels=("kind",), capacity=capacity,
        )
        self._error_bound = r.reservoir(
            "serve_error_bound",
            "Claimed stage-1 ErrorBound.value per response (finite only).",
            labels=("kind",), capacity=capacity,
        )
        self._refine_skipped = r.counter(
            "serve_refine_skipped_total",
            "Batches whose stage 2 was skipped because every request's "
            "claimed bound already met its accuracy SLO (latency win).",
        )
        self._accuracy_boost = r.counter(
            "serve_accuracy_boost_total",
            "Batches refined past the default grant to chase a max_error.",
        )

    # ------------------------------------------------------------------
    def record(self, response: Response) -> None:
        kind = response.kind
        roll = self.rollup
        stage1_ms = response.stage1_latency_s * 1e3
        total_ms = response.total_latency_s * 1e3
        self._responses.labels(kind=kind).inc()
        self._stage1_ms.labels(kind=kind).observe(stage1_ms)
        self._total_ms.labels(kind=kind).observe(total_ms)
        self._eps.labels(kind=kind).observe(response.eps_granted)
        if response.refined is not None:
            self._refined.labels(kind=kind).inc()
        if getattr(response, "partial_shards", ()):
            self._partial.labels(kind=kind).inc()
            if roll is not None:
                roll.count("partial")
        proxy = getattr(response, "accuracy_proxy", None)
        if proxy is not None:
            self._accuracy.labels(kind=kind).observe(proxy)
            if roll is not None:
                roll.observe("accuracy_proxy", proxy)
        bound = getattr(response, "error_bound", None)
        if bound is not None and math.isfinite(bound.value):
            self._error_bound.labels(kind=kind).observe(bound.value)
        # Accuracy-SLO verdicts feed the claimed-bound burn-rate channel:
        # bound_held / bound_checked is the windowed attainment ratio the
        # AccuracyObjective can alert on (use_claimed_bound=True).
        if response.accuracy_met is not None and roll is not None:
            roll.count("bound_checked")
            if response.accuracy_met:
                roll.count("bound_held")
        if response.reexecuted:
            self._reexecutions.labels(kind=kind).inc()
            return
        slo = slo_class(response.deadline_s)
        self._slo_seen.labels(kind=kind, slo=slo).inc()
        if response.deadline_met:
            self._deadline_met.labels(kind=kind, slo=slo).inc()
        if response.escalated:
            self._escalated.labels(kind=kind).inc()
        if roll is not None:
            # Window the SLO-relevant streams for first executions only —
            # same re-execution rule as the lifetime rates above.
            roll.observe("stage1_ms", stage1_ms)
            roll.observe(f"stage1_ms[{slo}]", stage1_ms)
            roll.observe("total_ms", total_ms)
            roll.count("requests")
            roll.count(f"requests[{slo}]")
            if response.deadline_met:
                roll.count("deadline_met")
                roll.count(f"deadline_met[{slo}]")
            if response.escalated:
                roll.count("escalated")

    def record_batch(
        self, shuffle_bytes: int, occupancy: int = 0,
        cache_source: str | None = None,
    ) -> None:
        self._batches.inc()
        self._shuffle.inc(shuffle_bytes)
        self._occupancy.inc(occupancy)
        if cache_source is not None:
            self._cache_source.labels(source=cache_source).inc()

    def record_accuracy_decision(
        self, *, skipped: bool = False, boosted: bool = False
    ) -> None:
        """One batch's accuracy-SLO outcome (skip-early or boost)."""
        if skipped:
            self._refine_skipped.inc()
        if boosted:
            self._accuracy_boost.inc()

    def reset(self) -> None:
        """Drop all records (e.g. after a kernel-build/cache warmup phase)."""
        self.registry.reset()
        if self.rollup is not None:
            self.rollup = WindowedRollup(
                self.rollup.window_s,
                max_windows=self.rollup.max_windows,
                clock=self.rollup.clock,
            )

    def windowed(self, windows: int = 10) -> dict:
        """Recent-window view: 'last N windows' rates and percentiles next
        to the lifetime stats (requires ``window_s``)."""
        roll = self.rollup
        if roll is None:
            raise RuntimeError("ServeMetrics built without window_s")
        span_s = windows * roll.window_s
        requests = roll.total("requests", windows)
        met = roll.total("deadline_met", windows)
        return {
            "span_s": span_s,
            "requests": requests,
            "request_rate": roll.rate("requests", windows),
            "deadline_met_rate": (
                met / requests if requests else math.nan
            ),
            "escalated": roll.total("escalated", windows),
            "stage1_latency_ms": {
                "p50": roll.quantile("stage1_ms", 50, windows=windows),
                "p99": roll.quantile("stage1_ms", 99, windows=windows),
            },
            "total_latency_ms": {
                "p50": roll.quantile("total_ms", 50, windows=windows),
                "p99": roll.quantile("total_ms", 99, windows=windows),
            },
        }

    # --- back-compat accessors (pre-registry attribute API) ---
    @property
    def n_batches(self) -> int:
        return int(self._batches.value)

    @property
    def shuffle_bytes_total(self) -> int:
        return int(self._shuffle.value)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Full registry snapshot (schema-pinned JSON) for BENCH embeds."""
        return self.registry.snapshot()

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    # ------------------------------------------------------------------
    def summary(
        self, cache_stats: dict | None = None,
        store_stats: list[dict] | None = None,
    ) -> dict:
        n_all = int(self._responses.total())
        n_reexec = int(self._reexecutions.total())
        n_first = n_all - n_reexec
        eps = self._eps.merged_stats()
        acc = self._accuracy.merged_stats()
        n_batches = self.n_batches
        out = {
            "n_requests": n_first,
            "n_reexecutions": n_reexec,
            "n_batches": n_batches,
            "stage1_latency_ms": {
                "p50": percentile(self._stage1_ms.merged_samples(), 50),
                "p99": percentile(self._stage1_ms.merged_samples(), 99),
            },
            "total_latency_ms": {
                "p50": percentile(self._total_ms.merged_samples(), 50),
                "p99": percentile(self._total_ms.merged_samples(), 99),
            },
            "eps_granted": {
                "mean": eps["mean"],
                "min": eps["min"],
                "max": eps["max"],
            },
            "deadline_met_rate": (
                self._deadline_met.total() / n_first if n_first else math.nan
            ),
            "refined_rate": (
                self._refined.total() / n_all if n_all else math.nan
            ),
            "escalated_rate": (
                self._escalated.total() / n_first if n_first else math.nan
            ),
            "shuffle_bytes_total": self.shuffle_bytes_total,
            "mean_batch_occupancy": (
                self._occupancy.value / n_batches if n_batches else math.nan
            ),
        }
        n_partial = int(self._partial.total())
        if n_partial:
            out["partial_rate"] = n_partial / n_all
        if acc["count"]:
            out["accuracy_proxy"] = {
                "n": acc["count"],
                "mean": acc["mean"],
                "p50": acc["p50"],
                "max": acc["max"],
            }
        bound = self._error_bound.merged_stats()
        if bound["count"]:
            out["error_bound"] = {
                "n": bound["count"],
                "mean": bound["mean"],
                "p50": bound["p50"],
                "max": bound["max"],
            }
        n_skipped = int(self._refine_skipped.value)
        n_boosted = int(self._accuracy_boost.value)
        if n_skipped or n_boosted:
            out["accuracy_slo"] = {
                "refine_skipped_batches": n_skipped,
                "boosted_batches": n_boosted,
            }
        if cache_stats is not None:
            out["cache"] = dict(cache_stats)
            misses = cache_stats.get("misses", 0)
            coarsened = cache_stats.get("coarsened_hits")
            if coarsened is not None:
                # Fraction of cache misses absorbed by cross-ratio merges
                # (repro_torch.store pyramid reuse) instead of cold rebuilds.
                out["cache"]["coarsened_hit_rate"] = (
                    coarsened / misses if misses else 0.0
                )
        if store_stats is not None:
            out["store"] = list(store_stats)
        if self.rollup is not None:
            out["windowed"] = self.windowed()
        return out
