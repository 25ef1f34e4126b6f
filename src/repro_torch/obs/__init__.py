"""repro_torch.obs — end-to-end observability for the anytime serving path
and the batch jobs.

The paper's product is a *trade-off curve* (execution time vs. accuracy
loss, §IV); this subsystem makes both axes observable from the running
system instead of only from offline benchmarks.

Layers (trace -> metrics -> probes -> decision)
===============================================

    [ trace ]    repro_torch.obs.trace — span trees with explicit host
        |        clocks.  The serving path's spans close only where the
        |        card has finished: one served batch yields one tree of
        |        batcher enqueue->admit waits, the deadline grant, the
        |        aggregate-cache lookup (hit/built/merged/restored),
        |        MapReduce map/reduce with shuffle bytes, and stage-2
        |        refinement.  A run_accurateml job yields one tree of
        |        launch-side spans that never synchronise: job, then
        |        map.lsh, map.aggregate, map.stage1, map.select and
        |        map.refine per map task, and reduce.  While torch.profiler
        |        records, every span is mirrored as a "span:<name>" range,
        |        so each stage's device time and idle gaps come from the
        |        profiler's trace.  Propagated by contextvar (use_tracer /
        |        current_tracer); the default NULL_TRACER records nothing.
        |        Export: JSON-lines (schema pinned by validate_trace_jsonl)
        |        + tree dump.
        v
    [ metrics ]  repro_torch.obs.metrics — typed registry of counters,
        |        gauges, fixed-bucket histograms, and bounded reservoirs
        |        (Vitter algorithm R: flat memory under sustained load)
        |        with labeled series (servable kind, SLO class, cache
        |        source, kernel op/path).  Export: snapshot() JSON
        |        (validate_snapshot pins the schema) + Prometheus text.
        v
    [ probes ]   repro_torch.obs.probes — KernelProbe hooks the dispatch
        |        layer in kernels/ops.py: op calls are timed until the card
        |        has finished them (measured p50 per op and path + pow2-
        |        bucketed dominant-shape label); calls under a CUDA graph
        |        capture pass through untimed.  The accuracy-proxy channel
        |        (stage-1 vs refined divergence: top-k overlap for kNN,
        |        rating-MAE delta for CF) rides Servable.accuracy_proxy
        |        into ServeMetrics.
        v
    [ decision ] the closed loop over the raw signals:
                 * repro_torch.obs.timeseries — WindowedRollup: aligned
                   fixed-width windows over observations and registry
                   counter deltas (rates, per-window streaming quantiles,
                   "last 10s p99" next to lifetime reservoirs);
                 * repro_torch.obs.slo — declarative Objectives
                   (deadline-met rate, windowed p99, accuracy-proxy floor)
                   with multi-window burn-rate alerting + hysteresis,
                   LoadSignal (the DeadlineController's windowed load
                   input) and StragglerWatch (per-shard latency skew);
                 * repro_torch.obs.flight — FlightRecorder: tail-sampling
                   ring keeping full span trees only for SLO-missed /
                   escalated / slowest-decile batches.

    [ gate ]     repro_torch.obs.regression — the BENCH gate: declarative
                 MetricSpecs with noise tolerances, measured wall-clock
                 speedups as a non-gating watch channel.

Everything is off by default and cheap when off: a server or job without a
tracer runs against NULL_TRACER (one check of the profiler a span, no
allocation), the kernel wrappers cost one ``is None`` test
when no probe is installed, and a server without ``window_s`` builds no
rollup, monitor, or recorder.
"""
from repro_torch.obs.flight import (
    FlightEntry, FlightRecorder, validate_flight_jsonl,
)
from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, Reservoir,
    default_registry, percentile, validate_snapshot,
)
from repro_torch.obs.probes import (
    KernelProbe, dominant_shape_label, install_kernel_probe,
    uninstall_kernel_probe,
)
from repro_torch.obs.regression import (
    DEFAULT_SPECS, Finding, MetricSpec, Report, WatchEntry, compare,
)
from repro_torch.obs.slo import (
    AccuracyObjective, Alert, DeadlineObjective, LatencyObjective,
    LoadSignal, Objective, SLOMonitor, StragglerWatch, default_objectives,
)
from repro_torch.obs.timeseries import WindowedRollup
from repro_torch.obs.trace import (
    NULL_TRACER, NullTracer, Span, Tracer, current_tracer, use_tracer,
    validate_trace_jsonl,
)

__all__ = [
    "AccuracyObjective",
    "Alert",
    "Counter",
    "DEFAULT_SPECS",
    "DeadlineObjective",
    "Finding",
    "FlightEntry",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "KernelProbe",
    "LatencyObjective",
    "LoadSignal",
    "MetricSpec",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Objective",
    "Report",
    "Reservoir",
    "SLOMonitor",
    "Span",
    "StragglerWatch",
    "Tracer",
    "WatchEntry",
    "WindowedRollup",
    "compare",
    "current_tracer",
    "default_objectives",
    "default_registry",
    "dominant_shape_label",
    "install_kernel_probe",
    "percentile",
    "uninstall_kernel_probe",
    "use_tracer",
    "validate_flight_jsonl",
    "validate_snapshot",
    "validate_trace_jsonl",
]
