"""Async front door: admission control, tenant quotas, and the load-shed
ladder in front of the synchronous ``Server`` loop.

``Server.step()``/``drain()`` answer whatever is already queued; nothing
bounds what gets *in*.  The front door is that boundary, built on the
paper's degrade-before-refuse ordering:

  1. **Quota** — each tenant has a token bucket; an out-of-quota submit is
     refused with a typed ``Overloaded(reason="quota")`` carrying the
     bucket's exact refill time.  Per-tenant contract, independent of
     fleet load.
  2. **Shed** — fleet pressure (bounded admission queue + batcher backlog,
     burn-rate alerts from the ``SLOMonitor``, the ``LoadSignal``
     cost correction) drives a ladder that *degrades eps fleet-wide*
     one rung at a time (``policy.eps_max`` scaled down): cheaper answers
     for everyone before refusing anyone.
  3. **Reject** — only with the ladder already at its deepest rung *and*
     the admission queue full does a submit get ``Overloaded(
     reason="overload")``.  Because the ladder moves one rung per
     evaluation and every submit evaluates it, the first rejection is
     structurally preceded by a full walk down the ladder — the
     shed-before-reject ordering the chaos benchmark asserts.

Every submitted rid gets exactly one terminal answer (``Response`` or
``Overloaded``); rejected submits never enter the batcher.

Two drive modes share all logic: ``start()``/``stop()`` runs a worker
thread (the async mode — ``submit`` returns immediately, ``wait(rid)``
blocks); ``pump()`` advances the same machinery synchronously for
deterministic tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable

from repro_torch.serve import request as request_mod
from repro_torch.serve.request import Overloaded, Request, Response
from repro_torch.serve.server import Server

# eps_max multiplier per ladder rung: rung 0 = healthy, deeper rungs trade
# accuracy for admission headroom fleet-wide.
SHED_FACTORS = (1.0, 0.5, 0.25, 0.125)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Admission contract for one tenant.

    ``rate``/``burst`` parameterize the token bucket (requests/s sustained,
    requests of headroom).  ``deadline_s`` is the tenant's default SLO when
    a submit doesn't carry one.
    """

    name: str
    rate: float = math.inf
    burst: float = 16.0
    deadline_s: float | None = None


class TokenBucket:
    """Classic token bucket; ``retry_after`` is the exact refill wait."""

    def __init__(self, rate: float, burst: float, clock: Callable[[], float]):
        self.rate = rate
        self.burst = burst
        self.clock = clock
        self.tokens = burst
        self.t_last = clock()

    def _refill(self, now: float) -> None:
        if math.isinf(self.rate):
            self.tokens = self.burst
        else:
            self.tokens = min(
                self.burst, self.tokens + (now - self.t_last) * self.rate
            )
        self.t_last = now

    def try_take(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after(self, now: float) -> float:
        self._refill(now)
        if self.tokens >= 1.0 or math.isinf(self.rate):
            return 0.0
        if self.rate <= 0.0:
            return math.inf
        return (1.0 - self.tokens) / self.rate


class LoadShedLadder:
    """Hysteretic, one-rung-at-a-time fleet-wide eps degradation.

    ``evaluate(pressure, now)`` moves at most one rung: down (deeper
    shedding) when pressure >= ``fire``, back up when pressure <=
    ``clear``.  The gap between the thresholds is the hysteresis band that
    keeps the ladder from flapping at a load edge.  ``transitions`` logs
    every move for post-hoc ordering assertions.
    """

    def __init__(
        self,
        factors: tuple[float, ...] = SHED_FACTORS,
        *,
        fire: float = 0.7,
        clear: float = 0.25,
    ):
        if not factors or factors[0] != 1.0:
            raise ValueError("factors must start at 1.0 (healthy rung)")
        if not clear < fire:
            raise ValueError("need clear < fire for hysteresis")
        self.factors = tuple(factors)
        self.fire = fire
        self.clear = clear
        self.level = 0
        self.transitions: list[dict] = []

    @property
    def max_level(self) -> int:
        return len(self.factors) - 1

    @property
    def factor(self) -> float:
        return self.factors[self.level]

    def evaluate(self, pressure: float, now: float) -> bool:
        """Move at most one rung; True when the level changed."""
        new = self.level
        if pressure >= self.fire and self.level < self.max_level:
            new = self.level + 1
        elif pressure <= self.clear and self.level > 0:
            new = self.level - 1
        if new == self.level:
            return False
        self.transitions.append(
            {"t": now, "from": self.level, "to": new, "pressure": pressure}
        )
        self.level = new
        return True


@dataclasses.dataclass
class _Pending:
    kind: str
    payload: tuple
    deadline_s: float
    tenant: str
    rid: int
    on_stage1: Callable[[int, Any], None] | None = None


class FrontDoor:
    """Admission-controlled serving loop over one ``Server``.

    All server mutation happens on the drive side (worker thread or
    ``pump`` caller); ``submit``/``wait``/``result`` are safe from any
    thread.
    """

    def __init__(
        self,
        server: Server,
        *,
        tenants: tuple[TenantSpec, ...] | list[TenantSpec] = (),
        default_deadline_s: float = 0.2,
        queue_limit: int = 64,
        ladder: LoadShedLadder | None = None,
        poll_s: float = 0.002,
        clock: Callable[[], float] | None = None,
    ):
        self.server = server
        self.clock = clock if clock is not None else server.clock
        self.default_deadline_s = default_deadline_s
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        self.queue_limit = queue_limit
        self.ladder = ladder if ladder is not None else LoadShedLadder()
        self.poll_s = poll_s
        self.tenants: dict[str, TenantSpec] = {t.name: t for t in tenants}
        self.tenants.setdefault("default", TenantSpec("default"))
        self._buckets = {
            name: TokenBucket(t.rate, t.burst, self.clock)
            for name, t in self.tenants.items()
        }
        # The healthy-rung eps ceiling the ladder degrades from.
        self._base_eps_max = server.controller.policy.eps_max

        self._lock = threading.RLock()
        self._queue: list[_Pending] = []
        self._results: dict[int, Response | Overloaded] = {}
        self._events: dict[int, threading.Event] = {}
        self._thread: threading.Thread | None = None
        self._running = False
        self.first_shed_t: float | None = None
        self.first_reject_t: float | None = None
        self._mean_batch_s = 0.01  # EMA seed for the retry-after hint

        r = server.metrics.registry
        self._admitted_c = r.counter(
            "frontdoor_admitted_total", "Submits admitted past the front door.",
            labels=("tenant",),
        )
        self._rejected_c = r.counter(
            "frontdoor_rejected_total",
            "Typed Overloaded refusals (reason=quota|overload).",
            labels=("reason",),
        )
        self._shed_level_g = r.gauge(
            "frontdoor_shed_level",
            "Current load-shed ladder rung (0 = healthy).",
        )
        self._shed_transitions_c = r.counter(
            "frontdoor_shed_transitions_total",
            "Ladder moves by direction (down = deeper shedding).",
            labels=("direction",),
        )

    # ------------------------------------------------------------------
    # pressure & shedding
    # ------------------------------------------------------------------
    def backlog(self) -> int:
        with self._lock:
            return len(self._queue) + len(self.server.batcher)

    def pressure(self) -> float:
        """Fleet pressure in [0, 1]: queue fill, burn-rate alerts, load
        correction — the max of the components (any one saturating is
        reason enough to shed)."""
        q = min(1.0, self.backlog() / self.queue_limit)
        alert = 0.0
        slo = self.server.slo
        if slo is not None and slo.active:
            # A firing burn-rate alert means the SLO budget is burning
            # faster than sustainable: shed even if the queue looks fine.
            alert = 1.0
        load = 0.0
        sig = self.server.controller.load_signal
        if sig is not None:
            corr = max(
                (sig.correction(k) for k in self.server.servables), default=1.0
            )
            # correction > 1: batches run slower than the cost model
            # predicts. Map [1, 2] -> [0, 1] so a 2x blowup saturates.
            load = max(0.0, min(1.0, corr - 1.0))
        return max(q, alert, load)

    def _evaluate_ladder(self, now: float) -> None:
        before = self.ladder.level
        if self.ladder.evaluate(self.pressure(), now):
            direction = "down" if self.ladder.level > before else "up"
            self._shed_transitions_c.labels(direction=direction).inc()
            self._shed_level_g.set(self.ladder.level)
            # Fleet-wide degradation: every grant on every kind now solves
            # under the scaled eps ceiling (cheaper stage 2 for everyone).
            self.server.controller.policy.eps_max = (
                self._base_eps_max * self.ladder.factor
            )
            if direction == "down" and self.first_shed_t is None:
                self.first_shed_t = now

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(
        self,
        kind: str,
        payload: tuple,
        *,
        deadline_s: float | None = None,
        tenant: str = "default",
        on_stage1: Callable[[int, Any], None] | None = None,
    ) -> int:
        """Admit-or-refuse one query; always returns a rid.

        The rid's terminal answer (``Response`` or ``Overloaded``) arrives
        via ``wait(rid)``; refusals resolve immediately and never enter
        the batcher.
        """
        if kind not in self.server.servables:
            raise KeyError(f"unknown workload kind: {kind!r}")
        spec = self.tenants.get(tenant)
        if spec is None:
            raise KeyError(f"unknown tenant: {tenant!r}")
        now = self.clock()
        rid = next(request_mod._rid_counter)
        if deadline_s is None:
            deadline_s = (
                spec.deadline_s if spec.deadline_s is not None
                else self.default_deadline_s
            )

        with self._lock:
            # 1) tenant quota — contract check, independent of fleet load.
            if not self._buckets[tenant].try_take(now):
                return self._refuse(
                    rid, kind, tenant, "quota",
                    self._buckets[tenant].retry_after(now), now,
                )
            # 2) shed before reject: the ladder gets its one-rung move on
            #    every submit, so rejection is unreachable until shedding
            #    is exhausted.
            self._evaluate_ladder(now)
            # 3) reject only at the deepest rung with a full queue.
            if (
                self.ladder.level >= self.ladder.max_level
                and len(self._queue) >= self.queue_limit
            ):
                retry = max(self.poll_s, self.backlog() * self._mean_batch_s)
                if self.first_reject_t is None:
                    self.first_reject_t = now
                return self._refuse(rid, kind, tenant, "overload", retry, now)
            self._queue.append(
                _Pending(kind, payload, deadline_s, tenant, rid, on_stage1)
            )
            self._events[rid] = threading.Event()
            self._admitted_c.labels(tenant=tenant).inc()
        return rid

    def _refuse(
        self, rid: int, kind: str, tenant: str, reason: str,
        retry_after_s: float, now: float,
    ) -> int:
        self._rejected_c.labels(reason=reason).inc()
        ev = threading.Event()
        self._results[rid] = Overloaded(
            rid=rid, kind=kind, tenant=tenant, reason=reason,
            retry_after_s=retry_after_s, shed_level=self.ladder.level,
        )
        self._events[rid] = ev
        ev.set()
        return rid

    # ------------------------------------------------------------------
    # drive (shared by thread and pump modes)
    # ------------------------------------------------------------------
    def _admit_queued(self) -> int:
        """Move pending submits into the batcher (server-side admission)."""
        with self._lock:
            pending, self._queue = self._queue, []
        for p in pending:
            req = Request(
                kind=p.kind, payload=p.payload, deadline_s=p.deadline_s,
                arrival_t=self.clock(), rid=p.rid, on_stage1=p.on_stage1,
            )
            self.server.batcher.submit(req)
        return len(pending)

    def _settle(self, responses: list[Response]) -> None:
        with self._lock:
            for resp in responses:
                # Re-execution answers overwrite the stage-1-only original:
                # latest answer wins, the event is already set.
                self._results[resp.rid] = resp
                ev = self._events.get(resp.rid)
                if ev is not None:
                    ev.set()

    def pump(self, max_batches: int = 1) -> list[Response]:
        """Advance the loop synchronously: admit, serve up to
        ``max_batches`` batches, re-evaluate the ladder.  Returns the
        responses produced (empty when idle)."""
        now = self.clock()
        self._admit_queued()
        out: list[Response] = []
        for _ in range(max_batches):
            t0 = self.clock()
            responses = self.server.step()
            if not responses:
                break
            self._mean_batch_s = (
                0.8 * self._mean_batch_s + 0.2 * (self.clock() - t0)
            )
            self._settle(responses)
            out.extend(responses)
        self._evaluate_ladder(now)
        return out

    def _worker(self) -> None:
        while self._running:
            if not self.pump(max_batches=4):
                time.sleep(self.poll_s)

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("front door already started")
        self._running = True
        self._thread = threading.Thread(
            target=self._worker, name="frontdoor", daemon=True
        )
        self._thread.start()

    def stop(self, *, drain: bool = True, timeout_s: float = 30.0) -> None:
        if self._thread is None:
            return
        if drain:
            deadline = time.monotonic() + timeout_s
            while self.backlog() and time.monotonic() < deadline:
                time.sleep(self.poll_s)
        self._running = False
        self._thread.join(timeout=timeout_s)
        self._thread = None

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------
    def wait(
        self, rid: int, timeout_s: float | None = None
    ) -> Response | Overloaded | None:
        """Block until rid's terminal answer (None on timeout)."""
        ev = self._events.get(rid)
        if ev is None:
            raise KeyError(f"unknown rid: {rid}")
        if not ev.wait(timeout_s):
            return None
        return self._results[rid]

    def result(self, rid: int) -> Response | Overloaded | None:
        return self._results.get(rid)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            rejected = {
                reason: int(self._rejected_c.labels(reason=reason).value)
                for reason in ("quota", "overload")
            }
            shed_before_reject = (
                self.first_reject_t is None
                or (
                    self.first_shed_t is not None
                    and self.first_shed_t <= self.first_reject_t
                )
            )
            return {
                "admitted": int(self._admitted_c.total()),
                "rejected": rejected,
                "shed_level": self.ladder.level,
                "shed_transitions": list(self.ladder.transitions),
                "first_shed_t": self.first_shed_t,
                "first_reject_t": self.first_reject_t,
                "shed_before_reject": shed_before_reject,
                "backlog": len(self._queue) + len(self.server.batcher),
                "pending_results": sum(
                    1 for ev in self._events.values() if not ev.is_set()
                ),
            }
