"""Request/response types and the ``Servable`` workload protocol.

A ``Request`` is one user query against a named workload ("knn", "cf", ...)
with a latency SLO.  The server answers it *anytime*-style: the ``Response``
always carries the stage-1 (aggregated) answer, and additionally the refined
answer whenever the deadline left room for stage 2.  Both stages' latencies
are recorded so accuracy-vs-deadline curves can be drawn from the serving
path itself.

``Servable`` is the contract an application implements to be admitted by the
scheduler.  It deliberately mirrors the offline Algorithm-1 decomposition:
``build`` produces the cacheable aggregates for one compression ratio (the
expensive LSH + segment-sum pass), ``run`` executes the two-stage map +
combine for a fixed-shape query batch at a static ``refine_budget``.

The answer contract (what a caller may receive for one submitted rid)
----------------------------------------------------------------------
Every admitted-or-rejected rid gets exactly one terminal answer; silent
drops are bugs, degraded answers are not:

  * ``Response`` with ``refined`` set — the full two-stage answer;
  * ``Response`` stage-1 only — the anytime degraded answer (budget ran
    out before stage 2);
  * ``Response`` with ``partial_shards`` non-empty — merged from the
    surviving failure domains only (a shard died or was still
    recovering); *degraded, not an error*: ``stage1``/``refined`` are
    real answers over K-1 shards' data;
  * ``Overloaded`` — the front door refused admission (tenant quota
    exhausted, or the load-shed ladder is maxed and the admission queue
    full).  Carries ``retry_after_s``; the request never entered the
    batcher.

The accuracy-SLO contract (what ``max_error`` buys, next to the latency SLO)
----------------------------------------------------------------------------
Every stage-1 answer carries a typed ``ErrorBound``: a *claimed* upper
bound on the answer's divergence from the exact result (the same metric as
the accuracy proxy — kNN label divergence, CF rating error), derived from
the per-bucket second-moment sufficient statistics, valid at the bound's
stated ``confidence``.  A request may additionally set ``max_error`` — an
accuracy SLO next to the latency SLO ``deadline_s``.  The server trades
the two off explicitly:

  * bound already <= ``max_error`` after stage 1 -> refinement is *skipped*
    (``Response.refine_skipped``) — a latency win purchased with the bound;
  * bound > ``max_error`` and deadline slack remains -> the controller may
    *boost* eps past the default grant to chase the accuracy SLO;
  * neither is an error: the answer is still anytime-total, and
    ``Response.accuracy_met`` records whether the claim satisfied the SLO.

``max_error`` never causes a drop or a refusal; empty/unknown buckets
report infinite uncertainty, so an unknown answer can never satisfy an
accuracy SLO by accident.

The token-streaming answer shape (LM generation, ``serve/lm``)
--------------------------------------------------------------
Generation rides the same contract with a structured per-request answer:
``stage1`` / ``refined`` are each ``{"tokens": [T] int32, "logits":
[T, V] float32}`` — the greedy token sequence and the pre-argmax logits
at every emitted position (T = ``max_new_tokens``).  Token 0 of both
stages comes from the same *exact* prefill, so it always agrees; the
stages diverge only in decode, where stage 1 runs at ``refine_frac=0``
(pure centroid attention) and the refined answer at the granted
``refine_frac = refine_budget / K``.  ``accuracy_proxy`` is the fraction
of emitted positions whose greedy token differs between the stages, and
``on_stage1`` fires with the full stage-1 token block as soon as it is
ready — the streaming hook: a caller renders approximate tokens
immediately and patches in the refined sequence when (if) it lands.
``partial_shards`` means dead bucket stripes were masked out of the
aggregate (see ``serve/lm/sharded.py``): shorter memory, still an
answer.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Hashable, Protocol, Sequence, runtime_checkable


_rid_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class ErrorBound:
    """Claimed upper bound on a stage-1 answer's divergence from exact.

    ``value`` is in the units of ``metric`` (the servable's accuracy-proxy
    metric: kNN "label_divergence" in [0,1], CF "rating_mae" in rating
    units); ``confidence`` is the claimed coverage level — the fraction of
    queries whose observed error the bound should dominate, calibrated by
    ``benchmarks/error_bounds.py``.  ``float("inf")`` means *unknown*
    (empty bucket, pre-second-moment snapshot) and can never satisfy an
    accuracy SLO.
    """

    value: float
    metric: str
    confidence: float = 0.9

    def met(self, max_error: float | None) -> bool:
        """Does this claim satisfy an accuracy SLO? (None -> trivially yes)."""
        return max_error is None or self.value <= max_error


@dataclasses.dataclass
class Request:
    """One admitted query with a latency SLO (and optional accuracy SLO)."""

    kind: str                    # servable name ("knn", "cf", ...)
    payload: tuple               # per-query arrays (servable-specific)
    deadline_s: float            # SLO: seconds from arrival to answer
    arrival_t: float             # server clock at admission
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))
    reexecution: bool = False    # escalated re-run of an earlier request
    on_stage1: Callable[[int, Any], None] | None = None
    # Accuracy SLO: claimed ErrorBound.value must be <= this, in the
    # servable's bound metric.  None = latency SLO only (default).
    max_error: float | None = None

    def remaining(self, now: float) -> float:
        return self.deadline_s - (now - self.arrival_t)


@dataclasses.dataclass
class Response:
    """Anytime answer: stage-1 always, refined when the budget allowed it."""

    rid: int
    kind: str
    stage1: Any                    # initial answer from aggregates
    refined: Any | None            # stage-2 answer (None if budget ran out)
    eps_granted: float             # refinement fraction the controller gave
    compression_ratio: float
    deadline_s: float
    queue_wait_s: float            # admission -> batch start
    stage1_latency_s: float        # admission -> stage-1 answer ready
    total_latency_s: float         # admission -> final answer ready
    deadline_met: bool             # stage-1 answer inside the SLO?
    escalated: bool = False        # eps fell below the policy floor
    reexecuted: bool = False       # answer came from the re-execution path
    cache_hit: bool = False        # aggregates served from the cache
    batch_size: int = 0            # real requests packed into the batch
    # Stage-1 vs refined divergence (0.0 = refinement changed nothing);
    # None when stage 2 didn't run or the servable can't compute it.
    accuracy_proxy: float | None = None
    # Failure domains absent from this answer (dead or still recovering).
    # Non-empty means the answer was merged from the surviving shards only:
    # a *degraded* answer under the anytime contract, never an error.
    partial_shards: tuple[int, ...] = ()
    # Claimed confidence interval on the stage-1 answer (None only when the
    # servable predates the bound contract).
    error_bound: ErrorBound | None = None
    # Accuracy-SLO verdict: None = no max_error on the request; otherwise
    # whether the claimed bound satisfied it.
    accuracy_met: bool | None = None
    # Stage 2 skipped because the bound already met the accuracy SLO —
    # the metered latency win of the error-bound contract.
    refine_skipped: bool = False

    @property
    def answer(self) -> Any:
        """Best available answer (the anytime contract)."""
        return self.refined if self.refined is not None else self.stage1

    @property
    def degraded(self) -> bool:
        """Answer is missing refinement or whole failure domains."""
        return self.refined is None or bool(self.partial_shards)


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed refusal from the front door — an answer, not an exception.

    Emitted only after fleet-wide eps degradation has been exhausted (for
    ``reason="overload"``: the load-shed ladder is at its deepest level
    *and* the bounded admission queue is full) or when a tenant is out of
    token-bucket quota (``reason="quota"`` — per-tenant contract, does not
    consult fleet load).  The request never entered the batcher; the
    caller should back off ``retry_after_s`` seconds and resubmit.
    """

    rid: int
    kind: str
    tenant: str
    reason: str                  # "quota" | "overload"
    retry_after_s: float
    shed_level: int = 0          # ladder depth at refusal time

    @property
    def answer(self) -> None:
        """Uniform surface with ``Response.answer`` (always None here)."""
        return None


@runtime_checkable
class Servable(Protocol):
    """What a workload provides to be served.

    Shapes: ``pad_batch`` must return arrays whose leading axis is exactly
    ``batch`` (the scheduler's quantized size) so ``run`` hits a bounded set
    of jit signatures; ``unpack`` slices the first ``n`` real answers back
    out.

    Optionally a servable may also define ``accuracy_proxy(stage1_out,
    refined_out, n) -> list[float]`` returning one per-request divergence
    score between the stage-1 and refined batched outputs (0.0 = refinement
    changed nothing).  It is *not* part of this protocol's required surface
    — the server discovers it with ``getattr`` and records it into the
    metrics' accuracy-proxy channel when present.

    Similarly optional: ``error_bounds(stage1_out, n) -> list[ErrorBound]``
    returning one *claimed* confidence interval per request, computed from
    the stage-1 outputs alone (the per-bucket second-moment statistics ride
    inside the prepared aggregates).  When present, the server attaches the
    bounds to every ``Response`` and uses them to honor ``max_error``
    accuracy SLOs (skip refinement early / boost eps); when absent,
    ``Response.error_bound`` stays None and ``max_error`` is ignored.
    """

    name: str
    n_points: int            # original points per shard — the N of eps_to_budget
    last_shuffle_bytes: int  # metered by the servable's MapReduce engine

    def cache_key(self, compression_ratio: float) -> Hashable:
        """Key identifying (dataset shard, LSHConfig) for the aggregate cache."""
        ...

    def build(self, compression_ratio: float) -> Any:
        """Build the stage-1 aggregates (LSH + segment sums). Cacheable."""
        ...

    def probe_payload(self) -> tuple:
        """One representative payload for cost-model calibration probes."""
        ...

    def pad_batch(self, payloads: Sequence[tuple], batch: int) -> tuple:
        """Stack per-request payloads into one fixed-shape batch."""
        ...

    def run(self, prepared: Any, batch_payload: tuple, *, refine_budget: int) -> Any:
        """Two-stage map + combine for the whole batch at a static budget."""
        ...

    def unpack(self, outputs: Any, n: int) -> list:
        """Split batched outputs into the first ``n`` per-request answers."""
        ...
