"""The serving loop: admit -> batch -> grant -> anytime answer -> record.

``Server`` glues the subsystem together around the existing core:

  * ``ContinuousBatcher`` packs heterogeneous requests into kind-homogeneous
    fixed-shape batches,
  * ``DeadlineController`` turns the batch's tightest remaining SLO into a
    ``(compression_ratio, eps)`` grant through ``CostModel``/``BudgetPolicy``,
  * ``AggregateCache`` reuses stage-1 aggregates across requests,
  * the servable executes the two-stage map + combine on ``MapReduce`` (so
    shuffle bytes are metered from the same code path the benchmarks use),
  * ``ServeMetrics`` records both anytime latencies per request.

Execution of one batch is the anytime contract in miniature: stage 1 runs
first and its answers are released immediately (per-request ``on_stage1``
callbacks fire before refinement starts); stage 2 runs only when the grant
left budget for it.  Escalated requests (grant below the eps floor) are
answered stage-1-only inside their SLO and re-queued as a relaxed-deadline
re-execution that refines at full ``eps_max`` — the serving analogue of the
paper's re-execute-instead-of-approximate straggler rule.
"""
from __future__ import annotations

import gc
import os
import statistics
import time
from typing import Any, Callable, Iterable

from repro_torch.core.budget import BudgetPolicy
from repro_torch.core.refine import eps_to_budget
from repro_torch.device import block_until_ready
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.slo import LoadSignal, Objective, SLOMonitor
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer, use_tracer
from repro_torch.serve.cache import AggregateCache
from repro_torch.serve.deadline import DeadlineController
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import Request, Response, Servable
from repro_torch.serve.scheduler import ContinuousBatcher, ScheduledBatch

# Escalated requests re-execute with this multiple of their original SLO.
REEXEC_DEADLINE_FACTOR = 8.0
CALIBRATE_RUNS = 5        # timed runs of each probe, after a warm-up


def _median_times(clock: Callable[[], float],
                  fns: Iterable[Callable[[], None]]) -> list[float]:
    """Each of ``fns`` once (a warm-up: kernel builds), then the median of
    CALIBRATE_RUNS timed runs of each, the functions in turns, so that a
    slow spell of the host slows each alike (timed one after the other, a
    pass at eps_max could measure no slower than one at eps 0, and a model
    fitted on it grants eps 0 to every finite deadline): robust to
    scheduler noise without the systematic underestimate a min would give
    (grants sized from an underestimate miss their deadlines)."""
    fns = list(fns)
    for fn in fns:
        fn()
    ts = [[] for _ in fns]
    for _ in range(CALIBRATE_RUNS):
        for fn, t in zip(fns, ts):
            t0 = clock()
            fn()
            t.append(clock() - t0)
    return [statistics.median(t) for t in ts]


def _full_collections() -> int:
    """Full (generation 2) garbage collections so far in this process."""
    return gc.get_stats()[2]["collections"]


class Server:
    """Synchronous-loop anytime server over a set of ``Servable`` workloads."""

    def __init__(
        self,
        servables: Iterable[Servable],
        *,
        policy: BudgetPolicy | None = None,
        controller: DeadlineController | None = None,
        batcher: ContinuousBatcher | None = None,
        cache: AggregateCache | None = None,
        clock: Callable[[], float] = time.perf_counter,
        tracer: Tracer | NullTracer | None = None,
        window_s: float | None = None,
        slo_objectives: Iterable[Objective] | None = None,
        flight: FlightRecorder | None = None,
    ):
        self.servables: dict[str, Servable] = {s.name: s for s in servables}
        if not self.servables:
            raise ValueError("need at least one servable")
        if policy is not None and controller is not None:
            raise ValueError("pass either policy or controller, not both")
        self.controller = (
            controller if controller is not None else DeadlineController(policy)
        )
        # `is None`, not `or`: an empty ContinuousBatcher is falsy (len 0),
        # so `batcher or ...` would silently discard a caller's batcher.
        self.batcher = batcher if batcher is not None else ContinuousBatcher()
        self.cache = cache if cache is not None else AggregateCache()
        self.metrics = ServeMetrics(window_s=window_s, clock=clock)
        self.clock = clock
        # Span-tree recorder for the whole batch path (repro_torch.obs).  The
        # default NULL_TRACER no-ops every call, so an un-observed server
        # pays nothing; pass obs.Tracer(clock=...) to record.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # Closed observability loop, all opt-in via window_s: the metrics
        # rollup feeds an SLOMonitor (burn-rate alerts into the default
        # registry + this batch's trace), the controller's cost correction
        # becomes a windowed LoadSignal quantile, and a FlightRecorder
        # keeps full span trees for SLO-missed/escalated/tail batches.
        self.slo: SLOMonitor | None = None
        if window_s is not None and slo_objectives is not None:
            self.slo = SLOMonitor(
                self.metrics.rollup, list(slo_objectives), clock=clock
            )
        if window_s is not None and self.controller.load_signal is None:
            self.controller.load_signal = LoadSignal(
                window_s=window_s, clock=clock
            )
        self.flight = flight
        # (kind, padded_size, refine_budget) combos already executed once:
        # first executions pay the kernel build and the libraries' handle
        # set-up, so their wall time must not feed the controller's cost
        # correction.
        self._seen_combos: set[tuple] = set()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(
        self, kind: str, payload: tuple, deadline_s: float,
        *, on_stage1: Callable[[int, Any], None] | None = None,
        max_error: float | None = None,
    ) -> int:
        if kind not in self.servables:
            raise KeyError(f"unknown workload kind: {kind!r}")
        req = Request(
            kind=kind, payload=payload, deadline_s=deadline_s,
            arrival_t=self.clock(), on_stage1=on_stage1,
            max_error=max_error,
        )
        self.batcher.submit(req)
        return req.rid

    # ------------------------------------------------------------------
    # calibration
    # ------------------------------------------------------------------
    def calibrate(self, kind: str, *, batch: int | None = None) -> None:
        """Fit the kind's CostModel from two timed probe batches.

        Probes run at the scheduler's largest pad size by default, so the
        fitted per-point costs are conservative for smaller batches.  The
        probe also builds the kernels and warms the aggregate cache for the
        policy's compression ratio.  Every timed run ends when the card has
        finished it: a fit of launch times would size every later grant for
        a card many times faster than this one.  Every row of the probe
        batch is the probe payload, not padding: the CF kernels work on
        rated entries only, so a zero row would cost them nothing and the
        fit would price a full batch at one row's work.  A timed pass is
        the work the server does around each run of a batch: padding, the
        run, the wait for the card, ``unpack`` (the copy of the answers to
        the host) and ``error_bounds`` where the servable has them, under a
        scratch tracer of the server's kind, so that a run pays for the
        engine's spans as a served one does.  Every pass's answers are held
        until the fit, as a served batch's responses hold theirs, so that
        each pass copies its answers into host memory no earlier pass has
        just freed, as a served batch does: passes that dropped their
        answers priced CF's batches (4.5 MB of predictions a pass) under
        their window, and the load correction that followed escalated the
        relaxed class.

        The rest of a served batch's window, outside those passes, is timed
        too and fitted into ``c_fixed``: the batch's spans (its root, a wait
        span a request, the grant, the cache lookup and the two stages), the
        grant, the cache lookup and the accuracy proxy.  A two-stage batch's
        prediction counts the model at eps 0 once more (the second stage-1
        pass that ``grant`` charges), and so ``c_fixed`` twice: each carries
        half of that time.  Without it the model priced a relaxed kNN batch
        some 20 % under its window on the card, and the load correction that
        followed cut batches whose deadline had been derived at a correction
        of 1.0.  The two probes are timed in turns (``_median_times``).
        """
        servable = self.servables[kind]
        policy = self.controller.policy
        r = policy.compression_ratio
        prepared, _ = self.cache.get_or_build(servable, r)
        n_pad = batch or self.batcher.pad_sizes[-1]
        payloads = [servable.probe_payload()] * n_pad
        bounds_fn = getattr(servable, "error_bounds", None)
        eps1 = max(policy.eps_max, self.controller.eps_grid[1])
        budget1 = eps_to_budget(servable.n_points, eps1)

        scratch = Tracer(clock=self.clock) if self.tracer.enabled \
            else NULL_TRACER
        proxy_fn = getattr(servable, "accuracy_proxy", None)
        outs: dict[int, Any] = {}
        answers: list[Any] = []

        def served_pass(refine_budget: int) -> None:
            padded = servable.pad_batch(payloads, n_pad)
            out = block_until_ready(
                servable.run(prepared, padded, refine_budget=refine_budget)
            )
            answers.append(servable.unpack(out, n_pad))
            if bounds_fn is not None:
                bounds_fn(out, n_pad)
            outs[refine_budget] = out

        def bookkeeping() -> None:
            # what _execute_batch does around its two passes
            t0 = self.clock()
            with scratch.span("serve.batch", kind=kind, n=n_pad):
                for i in range(n_pad):
                    scratch.add_span("batcher.wait", t0, t0, rid=i,
                                     deadline_s=0.0)
                with scratch.span("deadline.grant") as sp:
                    grant = self.controller.grant(
                        kind, servable.n_points, float("inf"))
                    sp.set(eps=grant.eps, escalate=grant.escalate)
                with scratch.span("cache.lookup") as sp:
                    sp.set(hit=self.cache.holds(servable, r))
                with scratch.span("stage1"):
                    pass
                with scratch.span("stage2.refine"):
                    if proxy_fn is not None:
                        proxy_fn(outs[0], outs[budget1], n_pad)

        with use_tracer(scratch):
            t_eps0, t_eps1 = _median_times(
                self.clock, (lambda: served_pass(0),
                             lambda: served_pass(budget1)))
            (t_host,) = _median_times(self.clock, (bookkeeping,))
        half = t_host / 2
        self.controller.fit_from_probes(
            kind, servable.n_points, r, t_eps0 + half, t_eps1 + half, eps1,
            t_fixed=half,
        )

    def prewarm(
        self, kind: str, *, batch: int | None = None,
        eps_values: Iterable[float] | None = None,
    ) -> None:
        """Run once every (shape, refine_budget) combo serving can grant.

        The controller only grants grid eps values <= eps_max, so warming
        those budgets (plus stage 1) removes first-run costs (kernel
        builds, library handles, allocator growth) — and the aggregate
        build — from steady-state latency.  With ``batch`` set
        only that pad size is warmed (cheap, for servers pinned to one
        shape); by default every scheduler pad size is covered.
        """
        servable = self.servables[kind]
        ctl = self.controller
        prepared, _ = self.cache.get_or_build(
            servable, ctl.policy.compression_ratio
        )
        if eps_values is None:
            eps_values = [e for e in ctl.eps_grid if e <= ctl.policy.eps_max]
        budgets = {0} | {
            eps_to_budget(servable.n_points, e) for e in eps_values
        }
        pads = (batch,) if batch is not None else self.batcher.pad_sizes
        for n_pad in pads:
            probe = servable.pad_batch([servable.probe_payload()], n_pad)
            for b in sorted(budgets):
                block_until_ready(
                    servable.run(prepared, probe, refine_budget=b)
                )
                self._seen_combos.add((kind, n_pad, b))

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def step(self) -> list[Response]:
        """Schedule and execute one batch; return its responses."""
        now = self.clock()
        batch = self.batcher.next_batch(now)
        if batch is None:
            return []
        return self._execute(batch)

    def drain(self, max_steps: int = 10_000) -> list[Response]:
        """Run until the queue (including escalation re-runs) is empty.

        ``max_steps`` bounds the loop: re-execution batches never
        re-escalate (pinned by test), so the queue shrinks monotonically —
        but a pathological controller must hit a loud RuntimeError, not
        spin forever.
        """
        out: list[Response] = []
        steps = 0
        while len(self.batcher):
            if steps >= max_steps:
                raise RuntimeError(
                    f"drain exceeded max_steps={max_steps} with "
                    f"{len(self.batcher)} requests still queued"
                )
            out.extend(self.step())
            steps += 1
        return out

    # ------------------------------------------------------------------
    def _execute(self, batch: ScheduledBatch) -> list[Response]:
        # Install the server's tracer as the context tracer so the deeper
        # layers (MapReduce engine, aggregate store) attach their spans to
        # this batch's tree without a parameter threading through.
        with use_tracer(self.tracer):
            responses = self._execute_batch(batch)
        # Flight recording needs the *closed* root span (duration, full
        # tree), so it happens after the batch span has been finished.
        if self.flight is not None and self.tracer.enabled:
            traces = self.tracer.traces()
            if traces:
                self.flight.record(traces[-1], responses)
        return responses

    def _execute_batch(self, batch: ScheduledBatch) -> list[Response]:
        servable = self.servables[batch.kind]
        reexecution = all(r.reexecution for r in batch.requests)
        tracer = self.tracer
        with tracer.span(
            "serve.batch", kind=batch.kind, n=batch.n,
            padded=batch.padded_size, reexecution=reexecution,
        ) as root:
            t_start = self.clock()
            full_gc = _full_collections()
            if tracer.enabled:
                # Queue wait per request, from clock values captured at
                # admission (a span can't wrap work that already happened).
                for req in batch.requests:
                    tracer.add_span(
                        "batcher.wait", req.arrival_t, t_start,
                        rid=req.rid, deadline_s=req.deadline_s,
                    )

            with tracer.span("deadline.grant") as g_sp:
                if reexecution:
                    # Fault path: refine at full eps, no deadline pressure.
                    grant = self.controller.grant(
                        batch.kind, servable.n_points, float("inf")
                    )
                else:
                    grant = self.controller.grant(
                        batch.kind, servable.n_points,
                        batch.min_remaining(t_start),
                    )
                g_sp.set(
                    eps=grant.eps, ratio=grant.compression_ratio,
                    refine_budget=grant.refine_budget,
                    escalate=grant.escalate, predicted_s=grant.predicted_s,
                )

            # Deadline propagation into the failure domains: a sharded
            # servable derives per-shard timeouts (straggler eps-shrink)
            # and its hedging headroom from the batch's remaining budget.
            deadline_hook = getattr(servable, "on_batch_deadline", None)
            if deadline_hook is not None:
                deadline_hook(
                    float("inf") if reexecution
                    else batch.min_remaining(t_start)
                )

            with tracer.span("cache.lookup") as c_sp:
                prepared, cache_hit = self.cache.get_or_build(
                    servable, grant.compression_ratio
                )
                cache_source = self.cache.last_source
                c_sp.set(hit=cache_hit, source=cache_source)

            padded = servable.pad_batch(
                [r.payload for r in batch.requests], batch.padded_size
            )
            combos = {(batch.kind, batch.padded_size, 0)}
            shuffle_bytes = 0

            # ---- stage 1: immediate aggregated answers ----
            with tracer.span("stage1") as s1_sp:
                s1_out = block_until_ready(
                    servable.run(prepared, padded, refine_budget=0)
                )
                s1_sp.set(shuffle_bytes=servable.last_shuffle_bytes)
            t_stage1 = self.clock()
            shuffle_bytes += servable.last_shuffle_bytes
            stage1_answers = servable.unpack(s1_out, batch.n)
            for req, ans in zip(batch.requests, stage1_answers):
                if req.on_stage1 is not None:
                    req.on_stage1(req.rid, ans)

            # ---- accuracy SLO: trade the bound against the grant ----
            # The servable's claimed per-request ErrorBounds (optional
            # surface, like accuracy_proxy) are read off the stage-1
            # outputs; when every request carries a max_error the bound
            # already satisfies, stage 2 is skipped outright (the metered
            # latency win); when some bound misses and deadline slack
            # remains, the controller may boost eps past the default grant.
            bounds_fn = getattr(servable, "error_bounds", None)
            bounds = (
                bounds_fn(s1_out, batch.n) if bounds_fn is not None else None
            )
            eps_used = grant.eps
            refine_budget = grant.refine_budget
            refine_skipped = False
            boosted = False
            if bounds is not None and not reexecution:
                maxes = [r.max_error for r in batch.requests]
                met = [b.met(m) for b, m in zip(bounds, maxes)]
                if (
                    refine_budget > 0
                    and all(m is not None for m in maxes)
                    and all(met)
                ):
                    refine_skipped = True
                    refine_budget = 0
                elif (
                    not grant.escalate
                    and any(m is not None and not ok
                            for m, ok in zip(maxes, met))
                ):
                    boost = self.controller.boost_for_accuracy(
                        batch.kind, servable.n_points,
                        batch.min_remaining(self.clock()),
                        base_eps=grant.eps,
                    )
                    if boost is not None:
                        boosted = True
                        eps_used = boost.eps
                        refine_budget = boost.refine_budget
            if refine_budget > 0:
                combos.add((batch.kind, batch.padded_size, refine_budget))
            warmed = combos <= self._seen_combos

            # ---- stage 2: refine if the grant left budget for it ----
            refined_answers: list[Any] | None = None
            proxies: list[float] | None = None
            if refine_budget > 0:
                with tracer.span(
                    "stage2.refine", refine_budget=refine_budget,
                    boosted=boosted,
                ) as s2_sp:
                    ref_out = block_until_ready(
                        servable.run(
                            prepared, padded,
                            refine_budget=refine_budget,
                        )
                    )
                    s2_sp.set(shuffle_bytes=servable.last_shuffle_bytes)
                shuffle_bytes += servable.last_shuffle_bytes
                refined_answers = servable.unpack(ref_out, batch.n)
                proxy_fn = getattr(servable, "accuracy_proxy", None)
                if proxy_fn is not None:
                    # Stage-1 vs refined divergence per request: how much
                    # the refinement actually moved the answer.
                    proxies = proxy_fn(s1_out, ref_out, batch.n)
            t_end = self.clock()

            # Failure domains absent from this batch's answer (shard died
            # or is still recovering): flagged on every response — a
            # degraded answer under the anytime contract, not an error.
            partial_shards = tuple(
                getattr(servable, "last_partial_shards", ())
            )

            # Cold batches (first run of a shape or aggregate build) are deploy
            # cost, not steady-state serving cost: keep them out of the
            # correction — as are accuracy-SLO deviations (skip/boost),
            # whose wall time no longer matches the grant's prediction, and
            # batches the garbage collector stopped for a full collection
            # (a pause of 100 ms and more in a large process, 20 times a kNN
            # batch on the card: one such ratio in the correction's high
            # quantile cut every later grant of the window).
            if warmed and cache_hit and refine_budget == grant.refine_budget \
                    and _full_collections() == full_gc:
                self.controller.observe(
                    batch.kind, grant.predicted_s, t_end - t_start
                )
            self._seen_combos |= combos
            self.metrics.record_batch(
                shuffle_bytes, occupancy=batch.n, cache_source=cache_source
            )
            if refine_skipped or boosted:
                self.metrics.record_accuracy_decision(
                    skipped=refine_skipped, boosted=boosted
                )
            root.set(
                eps=eps_used, shuffle_bytes=shuffle_bytes,
                refined=refined_answers is not None,
                refine_skipped=refine_skipped, boosted=boosted,
            )

            responses = []
            for i, req in enumerate(batch.requests):
                stage1_latency = t_stage1 - req.arrival_t
                total_latency = (
                    t_end - req.arrival_t if refined_answers is not None
                    else stage1_latency
                )
                bound = bounds[i] if bounds is not None else None
                resp = Response(
                    rid=req.rid,
                    kind=req.kind,
                    stage1=stage1_answers[i],
                    refined=refined_answers[i] if refined_answers else None,
                    eps_granted=eps_used,
                    compression_ratio=grant.compression_ratio,
                    deadline_s=req.deadline_s,
                    queue_wait_s=t_start - req.arrival_t,
                    stage1_latency_s=stage1_latency,
                    total_latency_s=total_latency,
                    deadline_met=stage1_latency <= req.deadline_s,
                    escalated=grant.escalate,
                    reexecuted=req.reexecution,
                    cache_hit=cache_hit,
                    batch_size=batch.n,
                    accuracy_proxy=(
                        float(proxies[i]) if proxies is not None else None
                    ),
                    partial_shards=partial_shards,
                    error_bound=bound,
                    accuracy_met=(
                        bound.met(req.max_error)
                        if bound is not None and req.max_error is not None
                        else None
                    ),
                    refine_skipped=refine_skipped,
                )
                responses.append(resp)
                self.metrics.record(resp)
                if grant.escalate and not req.reexecution:
                    self._requeue_for_reexecution(req)
            if self.slo is not None:
                # Evaluate inside the batch span so alert transitions land
                # as slo.alert events on this batch's tree.
                self.slo.evaluate()
            return responses

    def _requeue_for_reexecution(self, req: Request) -> None:
        self.batcher.submit(
            Request(
                kind=req.kind,
                payload=req.payload,
                deadline_s=req.deadline_s * REEXEC_DEADLINE_FACTOR,
                arrival_t=self.clock(),
                rid=req.rid,            # same logical request, second answer
                reexecution=True,
            )
        )

    # ------------------------------------------------------------------
    # aggregate persistence (repro_torch.store warm-start)
    # ------------------------------------------------------------------
    def _stores(self) -> list:
        stores: dict[int, Any] = {}
        for s in self.servables.values():
            store = getattr(s, "store", None)
            if store is not None:
                stores[id(store)] = store
        return list(stores.values())

    def save_aggregates(self, directory) -> int:
        """Snapshot every servable's built aggregate pyramids to disk so a
        restarted server can warm-start; returns pyramids written.

        Multiple distinct stores (servables not sharing one) are namespaced
        under ``store<i>/`` subdirectories.
        """
        stores = self._stores()
        if len(stores) == 1:
            return stores[0].save(directory)
        return sum(
            store.save(os.path.join(str(directory), f"store{i}"))
            for i, store in enumerate(stores)
        )

    def warm_start(
        self, directory, *, ratios: Iterable[float] | None = None
    ) -> dict:
        """Restore aggregate snapshots and pre-populate the cache.

        Probes both snapshot layouts (flat, and the ``store<i>/`` subdirs a
        multi-store server writes) against every servable, so the restoring
        server's store-sharing topology need not match the saver's —
        snapshots adopt by identity, never by position.  After this, the
        first request at a warmed compression ratio (by default the
        policy's) is a cache *hit*.

        Returns ``{"restored": pyramids adopted, "warmed": cache entries}``.
        ``restored == 0`` with ``warmed > 0`` means the snapshot did NOT
        match (stale fingerprint, different LSH key, ...) and the warm
        entries were *cold-built* — the caller paid full generation cost
        and should re-snapshot.
        """
        candidates = [str(directory)]
        if os.path.isdir(str(directory)):
            candidates += sorted(
                e.path for e in os.scandir(str(directory))
                if e.is_dir() and e.name.startswith("store")
            )
        servables = list(self.servables.values())
        restored = 0
        for servable in servables:
            store = getattr(servable, "store", None)
            if store is None:
                continue
            for candidate in candidates:
                n = store.restore(candidate, [servable])
                if n:
                    restored += n
                    break
        if ratios is None:
            ratios = [self.controller.policy.compression_ratio]
        warmed = self.cache.warm_from_store(servables, ratios)
        return {"restored": restored, "warmed": warmed}

    # ------------------------------------------------------------------
    def reset_metrics(self) -> None:
        """Zero request/batch/cache meters (after a warmup phase)."""
        self.metrics.reset()
        self.cache.reset_stats()

    def summary(self) -> dict:
        store_stats = [s.stats() for s in self._stores()]
        return self.metrics.summary(
            cache_stats=self.cache.stats(),
            store_stats=store_stats or None,
        )
