"""Declarative SLOs with multi-window burn-rate alerting, plus the two
first consumers of windowed telemetry: the deadline controller's load
signal and the runtime's straggler watch.

An ``Objective`` declares what fraction of events must be *good* (deadline
met, latency under a threshold, accuracy divergence under a floor).  The
monitor evaluates each objective's **burn rate** — observed error rate
divided by the error budget ``1 - target`` (burn 1.0 = spending the budget
exactly; burn 10 = burning it 10x too fast) — over two window spans:

  * the **short** span makes alerts fast to fire and fast to clear;
  * the **long** span keeps one noisy window from paging anyone.

An alert fires only when *both* spans burn above ``fire_burn`` and clears
only when both fall below ``clear_burn`` (< ``fire_burn``), so the state
machine has hysteresis instead of flapping at the threshold.  Transitions
are typed ``Alert`` records, counted in the registry
(``slo_alerts_total``), mirrored as gauges (``slo_alert_active``,
``slo_burn_rate``), and emitted as zero-duration ``slo.alert`` spans on
the context tracer so a flight-recorded batch shows the alert that fired
inside it.

``LoadSignal`` replaces the deadline controller's per-batch EMA correction
with a windowed quantile of observed/predicted ratios — the controller's
load input becomes "how slow have batches actually been lately" instead of
an instantaneous estimate one outlier can bend.  ``StragglerWatch`` turns
per-shard heartbeat step times into latency-skew gauges and straggler
alerts — the signals the async front door's load shedding consumes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Sequence

from repro_torch.obs.metrics import MetricsRegistry, default_registry, percentile
from repro_torch.obs.timeseries import WindowedRollup
from repro_torch.obs.trace import current_tracer


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Objective:
    """Base SLO declaration: a good-fraction target + burn-rate windows.

    Subclasses define ``good_total(rollup, windows)`` returning the
    (good, total) event counts over the last N windows; everything else —
    burn math, multi-window gating, hysteresis — is shared.
    """

    name: str
    target: float = 0.99      # required good fraction (error budget = 1-target)
    short_windows: int = 3    # fast-to-fire span
    long_windows: int = 30    # flap-resistant span
    fire_burn: float = 2.0    # fire when BOTH spans burn >= this
    clear_burn: float = 1.0   # clear when BOTH spans burn < this
    min_events: int = 1       # below this volume a span yields no signal

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.clear_burn >= self.fire_burn:
            raise ValueError("clear_burn must be below fire_burn (hysteresis)")

    def good_total(
        self, rollup: WindowedRollup, windows: int
    ) -> tuple[float, float]:
        raise NotImplementedError

    def burn(self, rollup: WindowedRollup, windows: int) -> float | None:
        """Error rate / error budget over the last N windows; None when the
        span holds fewer than ``min_events`` events (no signal, not zero)."""
        good, total = self.good_total(rollup, windows)
        if total < self.min_events:
            return None
        error_rate = (total - good) / total
        return error_rate / (1.0 - self.target)


@dataclasses.dataclass(frozen=True)
class DeadlineObjective(Objective):
    """Deadline-met rate, fleet-wide or for one SLO class label."""

    slo_class: str | None = None

    def good_total(self, rollup, windows):
        suffix = f"[{self.slo_class}]" if self.slo_class else ""
        return (
            rollup.total(f"deadline_met{suffix}", windows),
            rollup.total(f"requests{suffix}", windows),
        )


@dataclasses.dataclass(frozen=True)
class LatencyObjective(Objective):
    """Stage-1 latency under ``threshold_ms`` for ``target`` of requests.

    Framing a latency SLO as a good-fraction keeps the burn-rate math
    identical to the deadline objective; the windowed p99 itself is
    exported as a gauge for dashboards either way.
    """

    threshold_ms: float = 100.0
    slo_class: str | None = None

    def _samples(self, rollup, windows) -> list[float]:
        suffix = f"[{self.slo_class}]" if self.slo_class else ""
        return rollup.values(f"stage1_ms{suffix}", windows)

    def good_total(self, rollup, windows):
        xs = self._samples(rollup, windows)
        return (sum(1 for v in xs if v <= self.threshold_ms), len(xs))

    def p99(self, rollup, windows) -> float:
        return percentile(self._samples(rollup, windows), 99)


@dataclasses.dataclass(frozen=True)
class AccuracyObjective(Objective):
    """Accuracy-proxy floor: stage-1 vs refined divergence must stay under
    ``max_divergence`` for ``target`` of refined requests — the live side
    of the paper's accuracy-loss axis.

    With ``use_claimed_bound=True`` the objective instead reads the
    measured bound-vs-SLO verdicts (the ``bound_held`` / ``bound_checked``
    counters ``ServeMetrics`` rolls up per accuracy-SLO request): attainment
    of the *claimed* ``ErrorBound`` contract, so a drifting calibration
    (claims stop covering max_error) burns the same alert machinery as a
    latency SLO."""

    max_divergence: float = 0.5
    use_claimed_bound: bool = False

    def good_total(self, rollup, windows):
        if self.use_claimed_bound:
            return (
                rollup.total("bound_held", windows),
                rollup.total("bound_checked", windows),
            )
        xs = rollup.values("accuracy_proxy", windows)
        return (sum(1 for v in xs if v <= self.max_divergence), len(xs))


# ---------------------------------------------------------------------------
# alerts + monitor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Alert:
    """One alert state transition."""

    objective: str
    transition: str           # "fired" | "cleared"
    burn_short: float | None
    burn_long: float | None
    at: float                 # monitor clock at the transition


class SLOMonitor:
    """Evaluates objectives against a rollup; owns the alert state machine.

    ``evaluate()`` is called from the serving loop after each batch's
    metrics land (and may be called from any idle loop).  It updates the
    burn/active gauges every time and returns only the *transitions* —
    steady states are gauges, edges are events.
    """

    def __init__(
        self,
        rollup: WindowedRollup,
        objectives: Sequence[Objective],
        *,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.rollup = rollup
        self.objectives = tuple(objectives)
        self.registry = registry if registry is not None else default_registry()
        self.clock = clock
        self.active: dict[str, Alert] = {}
        self.history: list[Alert] = []
        r = self.registry
        self._burn = r.gauge(
            "slo_burn_rate",
            "Error-budget burn rate per objective and window span.",
            labels=("objective", "window"),
        )
        self._active = r.gauge(
            "slo_alert_active",
            "1 while the objective's burn-rate alert is firing.",
            labels=("objective",),
        )
        self._transitions = r.counter(
            "slo_alerts_total",
            "Burn-rate alert transitions (fired/cleared) per objective.",
            labels=("objective", "transition"),
        )

    # ------------------------------------------------------------------
    def evaluate(self) -> list[Alert]:
        """Recompute burns, update gauges, return this call's transitions."""
        transitions: list[Alert] = []
        now = self.clock()
        for obj in self.objectives:
            short = obj.burn(self.rollup, obj.short_windows)
            long = obj.burn(self.rollup, obj.long_windows)
            self._burn.labels(objective=obj.name, window="short").set(
                short if short is not None else 0.0
            )
            self._burn.labels(objective=obj.name, window="long").set(
                long if long is not None else 0.0
            )
            firing = obj.name in self.active
            if not firing:
                should_fire = (
                    short is not None and long is not None
                    and short >= obj.fire_burn and long >= obj.fire_burn
                )
                if should_fire:
                    alert = Alert(obj.name, "fired", short, long, now)
                    self.active[obj.name] = alert
                    transitions.append(alert)
            else:
                # Hysteresis: clear only when both spans are safely under
                # clear_burn; a missing signal (idle span) counts as calm.
                should_clear = (
                    (short is None or short < obj.clear_burn)
                    and (long is None or long < obj.clear_burn)
                )
                if should_clear:
                    alert = Alert(obj.name, "cleared", short, long, now)
                    del self.active[obj.name]
                    transitions.append(alert)
            self._active.labels(objective=obj.name).set(
                1.0 if obj.name in self.active else 0.0
            )
        for alert in transitions:
            self.history.append(alert)
            self._transitions.labels(
                objective=alert.objective, transition=alert.transition
            ).inc()
            current_tracer().event(
                "slo.alert",
                objective=alert.objective,
                transition=alert.transition,
                burn_short=alert.burn_short,
                burn_long=alert.burn_long,
            )
        return transitions


# ---------------------------------------------------------------------------
# consumer 1: the deadline controller's load signal
# ---------------------------------------------------------------------------

class LoadSignal:
    """Windowed observed/predicted ratio -> cost-model correction factor.

    ``DeadlineController.observe`` feeds every warmed batch's
    (predicted, observed) pair here; ``correction(kind)`` answers with a
    clamped quantile of the recent ratios.  Compared with the old per-batch
    EMA this is (a) windowed — a spike ages out instead of decaying through
    every later grant, and (b) a high quantile — the controller plans
    against how slow batches have *recently* been, which is the pessimism a
    deadline guard wants.
    """

    def __init__(
        self,
        *,
        window_s: float = 0.5,
        max_windows: int = 64,
        windows: int = 20,
        quantile: float = 90.0,
        clamp: tuple[float, float] = (0.25, 4.0),
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.rollup = WindowedRollup(
            window_s, max_windows=max_windows, clock=clock
        )
        self.windows = windows
        self.quantile = quantile
        self.clamp = clamp
        self._kinds: set[str] = set()

    def observe(self, kind: str, predicted_s: float, observed_s: float) -> None:
        if predicted_s <= 0.0 or observed_s <= 0.0:
            return
        lo, hi = self.clamp
        self._kinds.add(kind)
        self.rollup.observe(
            f"load_ratio[{kind}]", min(max(observed_s / predicted_s, lo), hi)
        )

    def correction(self, kind: str) -> float:
        xs = self.rollup.values(f"load_ratio[{kind}]", self.windows)
        if not xs:
            return 1.0
        lo, hi = self.clamp
        return min(max(percentile(xs, self.quantile), lo), hi)

    def summary(self) -> dict:
        return {k: self.correction(k) for k in sorted(self._kinds)}


# ---------------------------------------------------------------------------
# consumer 2: per-shard straggler watch (runtime heartbeats)
# ---------------------------------------------------------------------------

class StragglerWatch:
    """Per-shard step-latency skew gauges + straggler alerts.

    ``beat(shard, step, dt)`` is called from the runtime supervisor's
    heartbeat path with each shard's measured step time.  The watch keeps a
    windowed latency stream per shard, publishes

      * ``runtime_shard_step_latency_s{shard=}``  — last step time,
      * ``runtime_shard_latency_skew{shard=}``    — shard median / fleet
        median over the window span,

    and flags a shard as straggling when its skew crosses ``skew_fire``
    (clearing below ``skew_clear`` — same hysteresis discipline as the SLO
    monitor).  Transitions increment ``runtime_straggler_alerts_total`` and
    emit ``shard.straggling`` / ``shard.recovered`` spans on the context
    tracer — exactly the per-shard load signal fleet-wide eps degradation
    needs.
    """

    def __init__(
        self,
        *,
        window_s: float = 1.0,
        max_windows: int = 32,
        windows: int = 10,
        skew_fire: float = 2.0,
        skew_clear: float = 1.25,
        min_beats: int = 3,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if skew_clear >= skew_fire:
            raise ValueError("skew_clear must be below skew_fire (hysteresis)")
        self.rollup = WindowedRollup(
            window_s, max_windows=max_windows, clock=clock
        )
        self.windows = windows
        self.skew_fire = skew_fire
        self.skew_clear = skew_clear
        self.min_beats = min_beats
        self.registry = registry if registry is not None else default_registry()
        self.straggling: set[int] = set()
        self._shards: set[int] = set()
        r = self.registry
        self._latency = r.gauge(
            "runtime_shard_step_latency_s",
            "Most recent heartbeat step time per shard.",
            labels=("shard",),
        )
        self._skew = r.gauge(
            "runtime_shard_latency_skew",
            "Shard median step time / fleet median (windowed).",
            labels=("shard",),
        )
        self._alerts = r.counter(
            "runtime_straggler_alerts_total",
            "Straggler fire/clear transitions per shard.",
            labels=("shard", "transition"),
        )

    # ------------------------------------------------------------------
    def _median(self, shard: int) -> float:
        return percentile(
            self.rollup.values(f"shard_dt[{shard}]", self.windows), 50
        )

    def beat(self, shard: int, step: int, dt: float) -> float:
        """Record one heartbeat's step time; returns the shard's skew."""
        self._shards.add(shard)
        self.rollup.observe(f"shard_dt[{shard}]", dt)
        self._latency.labels(shard=shard).set(dt)
        medians = {}
        for s in self._shards:
            xs = self.rollup.values(f"shard_dt[{s}]", self.windows)
            if len(xs) >= self.min_beats:
                medians[s] = percentile(xs, 50)
        if shard not in medians:
            return 1.0
        fleet = percentile(list(medians.values()), 50)
        skew = medians[shard] / fleet if fleet > 0 else 1.0
        self._skew.labels(shard=shard).set(skew)
        if shard not in self.straggling and skew >= self.skew_fire:
            self.straggling.add(shard)
            self._alerts.labels(shard=shard, transition="fired").inc()
            current_tracer().event(
                "shard.straggling", shard=shard, step=step, skew=skew
            )
        elif shard in self.straggling and skew < self.skew_clear:
            self.straggling.discard(shard)
            self._alerts.labels(shard=shard, transition="cleared").inc()
            current_tracer().event(
                "shard.recovered", shard=shard, step=step, skew=skew
            )
        return skew

    def summary(self) -> dict:
        return {
            "shards": sorted(self._shards),
            "straggling": sorted(self.straggling),
        }


def default_objectives(
    *, deadline_target: float = 0.95, accuracy_floor: float = 0.5,
) -> list[Objective]:
    """A reasonable starting objective set for the demo server."""
    return [
        DeadlineObjective(name="deadline_met", target=deadline_target),
        AccuracyObjective(
            name="accuracy_floor", target=0.9, max_divergence=accuracy_floor,
        ),
    ]
