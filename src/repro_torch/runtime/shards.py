"""Failure-domain execution: fan one batch over N logical shards, convert
faults into accuracy loss instead of latency collapse.

One ``ShardedServable`` wraps N per-shard ``Servable`` instances (each
holding one slice of the dataset) behind the ordinary serving protocol, so
the server, batcher, controller, and cache are untouched — but execution
gains failure domains:

  * **deadline propagation** — the server hands the batch's remaining SLO
    budget to ``on_batch_deadline``; each shard's wall time is judged
    against a per-shard timeout derived from it;
  * **straggler eps-shrink** — a shard that blows its timeout gets its
    refinement budget scaled down (grid-quantized, so the budgets stay
    bounded) on subsequent batches, and earns it back by running fast: the
    paper's degrade-accuracy-not-latency rule applied per failure domain;
  * **hedged re-dispatch** — when the slowest shard's time is a large
    multiple of the fleet median and the deadline can absorb one more
    median-cost run, the shard is re-dispatched (chaos ``attempt=1``
    escapes the original attempt's injected stall) and the faster result
    wins;
  * **shard death** — a killed shard (``chaos.ShardDead``) is dropped from
    the batch; the answer is merged from the survivors and flagged
    ``partial_shards`` (a *degraded* answer, never an error), while a
    background recovery path restores the shard from its aggregate
    snapshot (``repro_torch.store`` persistence) — or cold-rebuilds when the
    snapshot is corrupted — after ``recovery_batches`` further batches.

Faults come from ``runtime.chaos.ChaosInjector`` (deterministic,
seed-driven) so every degradation path is exercised by tests and by
``chip_smoke.py``'s fleet phase.  The port of
``src/repro/runtime/shards.py``: a shard's time is read after its outputs
exist (``device.block_until_ready``), an injected slowdown is a real busy
wait on the clock, and each domain's LSH draw is passed in.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Sequence

from repro_torch.device import block_until_ready
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import current_tracer
from repro_torch.runtime import chaos as chaos_lib
from repro_torch.runtime.fault_tolerance import Heartbeat, emit_shard_event

HEALTHY = "healthy"
DEAD = "dead"

# Per-shard refinement-budget scales: grid-quantized so each (shard,
# budget) pair hits a bounded set of budgets, mirroring the controller's
# eps grid.  0.0 = stage-1-only from that shard.
EPS_SCALE_GRID = (0.0, 0.125, 0.25, 0.5, 1.0)


def _scale_down(scale: float) -> float:
    i = EPS_SCALE_GRID.index(scale)
    return EPS_SCALE_GRID[max(i - 1, 0)]


def _scale_up(scale: float) -> float:
    i = EPS_SCALE_GRID.index(scale)
    return EPS_SCALE_GRID[min(i + 1, len(EPS_SCALE_GRID) - 1)]


class ShardedServable:
    """N per-shard servables behind one ``Servable`` surface.

    ``merge_fn(outputs) -> merged`` folds the surviving shards' raw map
    outputs into one batch output (for kNN: ``merge_topk`` + majority
    vote); ``unpack``/``accuracy_proxy`` delegate to shard 0, whose output
    shape the merge preserves.
    """

    def __init__(
        self,
        shards: Sequence[Any],
        merge_fn: Callable[[list], Any],
        *,
        chaos: chaos_lib.ChaosInjector | None = None,
        watch=None,
        clock: Callable[[], float] = time.perf_counter,
        timeout_frac: float = 0.35,
        min_timeout_s: float = 0.0,
        hedge: bool = True,
        hedge_skew: float = 4.0,
        min_hedge_s: float = 0.005,
        recovery_batches: int = 2,
        snapshot_dir=None,
        max_slow_sleep_s: float = 0.05,
    ):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = list(shards)
        self.merge_fn = merge_fn
        self.chaos = chaos
        self.watch = watch
        self.clock = clock
        self.timeout_frac = timeout_frac
        self.min_timeout_s = min_timeout_s
        self.hedge = hedge
        self.hedge_skew = hedge_skew
        self.min_hedge_s = min_hedge_s
        self.recovery_batches = recovery_batches
        self.snapshot_dir = snapshot_dir
        self.max_slow_sleep_s = max_slow_sleep_s

        self.name = self.shards[0].name
        # The refine budget a grant computes from this is per *shard* (each
        # map task refines eps*N of its own slice, exactly as the offline
        # algorithm does per map task).
        self.n_points = max(s.n_points for s in self.shards)
        n = len(self.shards)
        self._state = [HEALTHY] * n
        self._eps_scale = [1.0] * n
        self._dead_at: dict[int, int] = {}
        self._prepared_override: dict[int, Any] = {}
        self._heartbeats: dict[int, Heartbeat] = {}
        self._deadline_s: float | None = None
        self._last_ratio: float | None = None
        self._last_shuffle = 0
        self.step = 0
        self.last_partial_shards: tuple[int, ...] = ()
        self.last_reports: list[dict] = []
        self.kills = 0
        self.recoveries = 0
        self.hedges = 0
        self.hedge_wins = 0
        r = default_registry()
        self._eps_scale_gauge = r.gauge(
            "runtime_shard_eps_scale",
            "Fraction of the granted refinement budget a shard currently "
            "receives (straggler eps-shrink mitigation).",
            labels=("shard",),
        )
        self._recoveries_counter = r.counter(
            "runtime_shard_recoveries_total",
            "Dead-shard recoveries by outcome (restored from snapshot / "
            "cold rebuild).",
            labels=("outcome",),
        )
        self._hedge_counter = r.counter(
            "runtime_hedges_total",
            "Hedged shard re-dispatches (won = hedge beat the original).",
            labels=("won",),
        )

    # ------------------------------------------------------------------
    # Servable protocol (delegation)
    # ------------------------------------------------------------------
    @property
    def last_shuffle_bytes(self) -> int:
        return self._last_shuffle

    def shared_store(self):
        """The shared aggregate store when every shard uses one, else None.

        Deliberately NOT exposed as a ``store`` attribute: the aggregate
        cache treats ``servable.store`` as "this servable speaks the
        mergeable-stats protocol", which the sharded wrapper doesn't —
        each *shard* does, through ``build``'s per-shard delegation.
        """
        stores = {id(getattr(s, "store", None)) for s in self.shards}
        first = getattr(self.shards[0], "store", None)
        return first if len(stores) == 1 else None

    def cache_key(self, compression_ratio: float):
        self._last_ratio = compression_ratio  # recovery rebuilds at it
        return tuple(s.cache_key(compression_ratio) for s in self.shards)

    def build(self, compression_ratio: float) -> tuple:
        self._last_ratio = compression_ratio
        return tuple(s.build(compression_ratio) for s in self.shards)

    def probe_payload(self) -> tuple:
        return self.shards[0].probe_payload()

    def pad_batch(self, payloads, batch: int) -> tuple:
        return self.shards[0].pad_batch(payloads, batch)

    def unpack(self, outputs: Any, n: int) -> list:
        return self.shards[0].unpack(outputs, n)

    def accuracy_proxy(self, stage1_out, refined_out, n: int) -> list[float]:
        return self.shards[0].accuracy_proxy(stage1_out, refined_out, n)

    def error_bounds(self, stage1_out, n: int) -> list:
        # The merge already folded per-shard bounds conservatively (max),
        # so shard 0's decoder reads the merged channel directly.
        return self.shards[0].error_bounds(stage1_out, n)

    # ------------------------------------------------------------------
    # deadline propagation (server hook)
    # ------------------------------------------------------------------
    def on_batch_deadline(self, remaining_s: float) -> None:
        """Server hands over the batch's remaining SLO budget before run."""
        self._deadline_s = remaining_s

    # ------------------------------------------------------------------
    # snapshots (recovery source)
    # ------------------------------------------------------------------
    def save_snapshot(self, directory) -> int:
        """Snapshot every shard's aggregate pyramid (recovery source)."""
        store = self.shared_store()
        if store is None:
            raise RuntimeError("shards do not share one AggregateStore")
        return store.save(directory)

    # ------------------------------------------------------------------
    # fault-domain execution
    # ------------------------------------------------------------------
    def _budget_for(self, shard: int, refine_budget: int) -> int:
        return int(refine_budget * self._eps_scale[shard])

    def _run_shard(
        self, shard: int, prepared, batch_payload, refine_budget: int,
        step: int, *, attempt: int = 0,
    ) -> tuple[Any, float]:
        """Execute one shard's map, applying injected slowdowns for real."""
        s = self.shards[shard]
        t0 = self.clock()
        out = block_until_ready(
            s.run(prepared, batch_payload,
                  refine_budget=self._budget_for(shard, refine_budget))
        )
        dt = self.clock() - t0
        if self.chaos is not None:
            ev = self.chaos.fires(step, shard, chaos_lib.SLOW, attempt=attempt)
            if ev is not None:
                # A real stall (bounded), not bookkeeping: measured batch
                # latency, the straggler watch, and the deadline-met rate
                # must all feel the slowdown.
                stall = min(dt * (ev.factor - 1.0), self.max_slow_sleep_s)
                if stall > 0:
                    t_end = self.clock() + stall
                    while self.clock() < t_end:
                        pass
                dt = self.clock() - t0
        return out, dt

    def _mark_dead(self, shard: int, step: int) -> None:
        self._state[shard] = DEAD
        self._dead_at[shard] = step
        self.kills += 1
        emit_shard_event("died", shard, step)
        # Simulate the failure domain losing its memory: the resident
        # pyramid is gone; recovery must come from disk or a cold rebuild.
        store = getattr(self.shards[shard], "store", None)
        if store is not None:
            store.invalidate(self.shards[shard])

    def _tick_recovery(self, step: int) -> None:
        for shard, died_at in list(self._dead_at.items()):
            if step - died_at < self.recovery_batches:
                continue
            outcome = "rebuilt"
            s = self.shards[shard]
            corrupted = (
                self.chaos is not None
                and self.chaos.fires(
                    step, shard, chaos_lib.CORRUPT_SNAPSHOT
                ) is not None
            )
            store = getattr(s, "store", None)
            if self.snapshot_dir is not None and store is not None \
                    and not corrupted:
                try:
                    if store.restore(self.snapshot_dir, [s]):
                        outcome = "restored"
                except Exception:
                    outcome = "rebuilt"  # unreadable snapshot: fall through
            if self._last_ratio is not None:
                # Re-prepare this shard's aggregates (one merge from the
                # restored level-0 stats, or a cold LSH+aggregate rebuild).
                self._prepared_override[shard] = s.build(self._last_ratio)
            self._state[shard] = HEALTHY
            del self._dead_at[shard]
            self.recoveries += 1
            self._recoveries_counter.labels(outcome=outcome).inc()
            emit_shard_event("recovered", shard, step, outcome=outcome)

    def run(self, prepared: tuple, batch_payload: tuple, *,
            refine_budget: int) -> Any:
        step = self.step
        self.step += 1
        self._tick_recovery(step)
        # Kept (not popped) across stage-1/stage-2 runs of the same batch;
        # the server refreshes it via on_batch_deadline before each batch.
        deadline = (
            self._deadline_s if self._deadline_s is not None else math.inf
        )
        tracer = current_tracer()
        t_batch = self.clock()
        n = len(self.shards)
        outs: dict[int, Any] = {}
        dts: dict[int, float] = {}
        reports: list[dict] = []
        shuffle = 0

        alive = [i for i in range(n) if self._state[i] == HEALTHY]
        for i in alive:
            if self.chaos is not None and len(alive) > 1:
                # Never kill the last failure domain standing: an empty
                # answer would break the degraded-not-error contract.
                kill = self.chaos.fires(step, i, chaos_lib.KILL)
                if kill is not None and (len(outs) + len(alive) - alive.index(i)) > 1:
                    self._mark_dead(i, step)
                    reports.append({"shard": i, "status": "dead", "dt": 0.0})
                    continue
            shard_prepared = self._prepared_override.get(i, prepared[i])
            out, dt = self._run_shard(
                i, shard_prepared, batch_payload, refine_budget, step
            )
            outs[i] = out
            dts[i] = dt
            shuffle += self.shards[i].last_shuffle_bytes
            hb = self._heartbeats.setdefault(i, Heartbeat(shard=i))
            dropped = (
                self.chaos is not None
                and self.chaos.fires(step, i, chaos_lib.DROP_HEARTBEAT)
                is not None
            )
            if not dropped:
                hb.beat(step)
                if self.watch is not None:
                    self.watch.beat(i, step, dt)
            reports.append({"shard": i, "status": "ok", "dt": dt})

        # ---- hedged re-dispatch of the slowest shard ----
        if self.hedge and len(dts) >= 2:
            med = sorted(dts.values())[len(dts) // 2]
            slowest = max(dts, key=lambda i: dts[i])
            remaining = deadline - (self.clock() - t_batch)
            # Absolute floor on top of the relative skew: sub-millisecond
            # jitter must not look like a straggler worth re-dispatching.
            if (
                dts[slowest] >= self.hedge_skew * med
                and dts[slowest] >= self.min_hedge_s
                and remaining > med
            ):
                self.hedges += 1
                shard_prepared = self._prepared_override.get(
                    slowest, prepared[slowest]
                )
                out2, dt2 = self._run_shard(
                    slowest, shard_prepared, batch_payload, refine_budget,
                    step, attempt=1,
                )
                won = dt2 < dts[slowest]
                if won:
                    outs[slowest] = out2
                    dts[slowest] = dt2
                    self.hedge_wins += 1
                self._hedge_counter.labels(won=str(won).lower()).inc()
                emit_shard_event("hedged", slowest, step, won=won)
                for rep in reports:
                    if rep["shard"] == slowest:
                        rep["status"] = "hedged"

        # ---- per-shard timeout -> straggler eps-shrink (and earn-back) ----
        timeout_s = max(self.min_timeout_s, self.timeout_frac * deadline)
        for i, dt in dts.items():
            if math.isfinite(timeout_s) and dt > timeout_s:
                old = self._eps_scale[i]
                self._eps_scale[i] = _scale_down(old)
                emit_shard_event(
                    "straggling", i, step, dt=dt, eps_scale=self._eps_scale[i]
                )
                for rep in reports:
                    if rep["shard"] == i and rep["status"] == "ok":
                        rep["status"] = "slow"
            elif self._eps_scale[i] < 1.0:
                self._eps_scale[i] = _scale_up(self._eps_scale[i])
            self._eps_scale_gauge.labels(shard=i).set(self._eps_scale[i])

        if not outs:
            raise chaos_lib.ShardDead(-1, step)  # unreachable by guard
        self.last_partial_shards = tuple(
            i for i in range(n) if i not in outs
        )
        self.last_reports = reports
        self._last_shuffle = shuffle
        if self.last_partial_shards:
            tracer.event(
                "batch.partial", step=step,
                partial_shards=list(self.last_partial_shards),
            )
        return self.merge_fn([outs[i] for i in sorted(outs)])

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        return {
            "n_shards": len(self.shards),
            "state": list(self._state),
            "eps_scale": list(self._eps_scale),
            "kills": self.kills,
            "recoveries": self.recoveries,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
        }


# ---------------------------------------------------------------------------
# concrete fleet: sharded kNN (the workload the chaos harness drives)
# ---------------------------------------------------------------------------

def sharded_knn(
    train_x, train_y, *, n_shards: int, n_classes: int, k: int = 5,
    lsh_generators: Sequence | None = None, lsh_params: Sequence | None = None,
    store=None, n_hashes: int = 4, bucket_width: float = 4.0,
    device="cuda", **sharded_kwargs,
) -> ShardedServable:
    """Split one kNN shard into ``n_shards`` failure domains.

    Each domain is a full ``KNNServable`` over its slice with its own LSH
    draw: ``lsh_generators`` (one ``torch.Generator`` a domain) or
    ``lsh_params`` (one ``(a, b)`` a domain; the JAX package folds its key
    with the domain's index, and a comparison passes those draws in), and
    a shared ``AggregateStore`` so snapshots and recovery live in one
    place.  The merge stacks the surviving domains' top-k once as
    ``[S, Q, k]`` for ``merge_topk`` (one ``candidate_topk`` launch) and
    re-votes — stage-1 answers from K-1 shards are degraded answers, not
    errors.
    """
    import torch

    from repro_torch.apps import knn as knn_lib
    from repro_torch.store import AggregateStore

    if (lsh_generators is None) == (lsh_params is None):
        raise ValueError("pass exactly one of lsh_generators and lsh_params")
    draws = lsh_generators if lsh_generators is not None else lsh_params
    if len(draws) != n_shards:
        raise ValueError(f"{len(draws)} LSH draws for {n_shards} shards")
    if store is None:
        store = AggregateStore()
    n = int(train_x.shape[0])
    shards = []
    for s in range(n_shards):
        sl = slice(s * n // n_shards, (s + 1) * n // n_shards)
        draw = ({"lsh_generator": lsh_generators[s]}
                if lsh_generators is not None
                else {"lsh_params": lsh_params[s]})
        shards.append(
            knn_lib.KNNServable(
                train_x[sl], train_y[sl], n_classes=n_classes, k=k,
                n_hashes=n_hashes, bucket_width=bucket_width, store=store,
                device=device, **draw,
            )
        )

    def merge_fn(outs: list) -> tuple:
        d = torch.stack([o[0] for o in outs])
        l = torch.stack([o[1] for o in outs])
        md, ml = knn_lib.merge_topk(d, l, k)
        # Conservative bound merge: the claim must dominate every surviving
        # shard's contribution to the merged answer.
        mb = torch.stack([o[3] for o in outs]).max(dim=0).values
        return md, ml, knn_lib.majority_vote(md, ml, n_classes), mb

    return ShardedServable(shards, merge_fn, **sharded_kwargs)
