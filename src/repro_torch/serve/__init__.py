"""repro_torch.serve — anytime, deadline-aware serving of AccurateML workloads.

Design (request -> deadline -> (r, eps) -> anytime response)
============================================================

The paper's two-stage algorithm is an *anytime* algorithm: stage 1 answers
from aggregated points in O(N/r), stage 2 spends eps*N more work refining
the top-correlated buckets toward the exact answer.  Offline, (r, eps) are
static job knobs; this subsystem turns them into per-request serving knobs
driven by each request's latency SLO.

Life of a request::

    submit(kind, payload, deadline_s)
        |                                  repro_torch.serve.scheduler
        v
    [ ContinuousBatcher ]  heterogeneous queue; emits kind-homogeneous,
        |                  SLO-class-compatible batches padded to a bounded
        |                  set of shapes
        v
    [ DeadlineController ] repro_torch.serve.deadline — maps the batch's tightest
        |                  remaining budget through CostModel.solve_eps and
        |                  BudgetPolicy into a Grant(compression_ratio, eps):
        |                  load degrades eps, never correctness; below the
        |                  eps floor it escalates (should_reexecute) to a
        |                  relaxed-deadline full-eps re-execution
        v
    [ AggregateCache ]     repro_torch.serve.cache — stage-1 aggregates built once
        |                  per (dataset shard, LSHConfig), LRU + hit metering;
        |                  misses delegate to repro_torch.store.AggregateStore:
        |                  new compression ratios merge the shard's resident
        |                  pyramid level (coarsened_hits) and snapshots
        |                  warm-start restarted servers (restored_hits)
        v
    [ Servable.run ]       the workload's two-stage map + combine on the
        |                  MapReduce engine (shuffle bytes metered); stage 1
        |                  executes first and its answers are released
        |                  immediately (on_stage1), stage 2 only if granted
        v
    Response(stage1, refined, eps_granted, stage1/total latency, ...)
        |
    [ ServeMetrics ]       repro_torch.serve.metrics — p50/p99 of both anytime
                           latencies, granted-eps stats, deadline-met rate,
                           cache hit rate, shuffle bytes, and the stage-1 vs
                           refined accuracy proxy — bounded reservoirs on a
                           repro_torch.obs.MetricsRegistry (flat memory, labeled
                           series, Prometheus/JSON export)

Observability: pass ``tracer=repro_torch.obs.Tracer()`` to ``Server`` and every
batch records a span tree (batcher wait -> grant -> cache lookup -> per-shard
map -> refine); see ``repro_torch.obs``.

Workloads implement the small ``Servable`` protocol (repro_torch.serve.request);
``repro_torch.apps.knn.KNNServable``, ``repro_torch.apps.cf.CFServable``, and
``repro_torch.serve.lm.LMServable`` (aggregated-KV LM decoding: the bucketed KV
cache is the "dataset shard", a decode step the query, and the granted
eps is the per-step ``refine_frac``) are the shipped instances.

Robustness: ``repro_torch.serve.frontdoor.FrontDoor`` puts admission control in
front of this loop — per-tenant token-bucket quotas, a bounded admission
queue, and a load-shed ladder that degrades eps fleet-wide before the
first typed ``Overloaded`` refusal.  A servable that loses a failure
domain answers without it (see ``Response.partial_shards``).

The server, the cache and the front door hold no tensors of their own: they
run wherever their servables run (``device="cuda"`` by default).
"""
from repro_torch.serve.cache import AggregateCache
from repro_torch.serve.deadline import DeadlineController, Grant
from repro_torch.serve.frontdoor import (
    FrontDoor, LoadShedLadder, TenantSpec, TokenBucket,
)
from repro_torch.serve.metrics import ServeMetrics, percentile
from repro_torch.serve.request import Overloaded, Request, Response, Servable
from repro_torch.serve.scheduler import ContinuousBatcher, ScheduledBatch
from repro_torch.serve.server import Server

__all__ = [
    "AggregateCache",
    "ContinuousBatcher",
    "DeadlineController",
    "FrontDoor",
    "Grant",
    "LoadShedLadder",
    "Overloaded",
    "Request",
    "Response",
    "ScheduledBatch",
    "Servable",
    "ServeMetrics",
    "Server",
    "TenantSpec",
    "TokenBucket",
    "percentile",
]
