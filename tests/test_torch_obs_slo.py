"""The port's decision layer (``repro_torch.obs``: windowed rollups, SLO
burn-rate alerting, the load signal, straggler watch and flight recorder):
the scenarios of ``tests/test_obs_slo.py`` replayed on it, and parity with
the JAX package (the same alerts from the same feed under the same clock).

Not replayed here: the runtime supervisor's scenario (``repro.runtime`` is
not ported yet) and the benchmark gate's (``obs/regression.py`` comes with
the port's benchmarks)."""
from __future__ import annotations

import json
import math

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.obs import flight as jflight
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro.obs import timeseries as jtimeseries
from repro.obs import trace as jtrace
from repro.serve import metrics as jserve_metrics
from repro.serve import request as jrequest
from repro_torch.obs.flight import FlightRecorder, validate_flight_jsonl
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.probes import (
    KernelProbe, _pow2_bucket, dominant_shape_label,
)
from repro_torch.obs.slo import (
    AccuracyObjective, DeadlineObjective, LatencyObjective, LoadSignal,
    Objective, SLOMonitor, StragglerWatch, default_objectives,
)
from repro_torch.obs.timeseries import WindowedRollup
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.serve.deadline import DeadlineController
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import Response


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def make_response(
    *, rid=0, stage1_ms=5.0, deadline_s=0.1, deadline_met=True,
    reexecuted=False, escalated=False, accuracy_proxy=None,
) -> Response:
    return Response(
        rid=rid, kind="knn", stage1=None, refined=None,
        eps_granted=0.1, compression_ratio=20.0, deadline_s=deadline_s,
        queue_wait_s=0.0, stage1_latency_s=stage1_ms / 1e3,
        total_latency_s=stage1_ms / 1e3, deadline_met=deadline_met,
        escalated=escalated, reexecuted=reexecuted,
        accuracy_proxy=accuracy_proxy,
    )


# ---------------------------------------------------------------------------
# WindowedRollup
# ---------------------------------------------------------------------------

def test_window_alignment_on_injected_clock():
    clock = FakeClock(10.25)
    roll = WindowedRollup(1.0, clock=clock)
    assert roll.window_start(3.7) == 3.0
    assert roll.window_start(4.0) == 4.0
    roll.observe("x", 1.0)
    assert roll.window_starts() == [10.0]
    clock.t = 11.7
    roll.observe("x", 2.0)
    assert roll.window_starts() == [10.0, 11.0]
    # An idle gap produces no filler windows — just the next aligned start.
    clock.t = 15.1
    roll.count("ev")
    assert roll.window_starts() == [10.0, 11.0, 15.0]


def test_rollup_ring_is_bounded():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, max_windows=4, clock=clock)
    for i in range(20):
        clock.t = float(i)
        roll.count("ev")
    # closed ring holds max_windows, plus the one current window
    assert roll.n_windows <= 5


def test_rollup_rate_counts_idle_windows_as_zero():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, clock=clock)
    for _ in range(10):
        roll.count("req")
    clock.t = 9.5  # 9 idle windows later
    assert roll.total("req", 10) == 10
    assert roll.rate("req", 10) == pytest.approx(1.0)
    # The burst window has aged out of a shorter span.
    assert roll.total("req", 5) == 0


def test_rollup_quantiles_pool_recent_windows():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, clock=clock)
    for i in range(10):
        clock.t = float(i)
        roll.observe("lat", float(i))
    assert roll.quantile("lat", 50, windows=10) == pytest.approx(4.5)
    # Only the last 2 windows: samples {8, 9}.
    assert roll.quantile("lat", 0, windows=2) == pytest.approx(8.0)
    assert math.isnan(roll.quantile("missing", 50))


def test_rollup_stats_and_gauges():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, clock=clock)
    roll.observe("v", 1.0)
    roll.observe("v", 3.0)
    roll.set("g", 7.0)
    st = roll.stats("v")
    assert st["count"] == 2 and st["sum"] == 4.0
    assert st["min"] == 1.0 and st["max"] == 3.0
    assert roll.last("g") == 7.0
    clock.t = 100.0
    assert roll.last("g", windows=5) is None


def test_sample_registry_records_counter_deltas():
    clock = FakeClock(0.0)
    reg = MetricsRegistry()
    c = reg.counter("reqs_total", "d", labels=("kind",))
    roll = WindowedRollup(1.0, clock=clock)
    c.labels(kind="knn").inc(5)
    roll.sample_registry(reg)
    assert roll.total("reqs_total[knn]") == 5
    clock.t = 1.0
    c.labels(kind="knn").inc(3)
    roll.sample_registry(reg)
    # Delta (3), not the lifetime total (8), landed in the new window.
    assert roll.total("reqs_total[knn]", 1) == 3
    assert roll.total("reqs_total[knn]", 2) == 8


# ---------------------------------------------------------------------------
# SLO objectives + burn-rate monitor
# ---------------------------------------------------------------------------

def _feed_window(roll, clock, *, requests, met, stage1_ms=5.0):
    for _ in range(requests):
        roll.count("requests")
        roll.observe("stage1_ms", stage1_ms)
    for _ in range(met):
        roll.count("deadline_met")
    clock.advance(1.0)
    roll.tick()


def test_objective_validation():
    with pytest.raises(ValueError):
        DeadlineObjective(name="bad", target=1.0)
    with pytest.raises(ValueError):
        DeadlineObjective(name="bad", fire_burn=1.0, clear_burn=2.0)


def test_burn_rate_math_and_min_events():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, clock=clock)
    obj = DeadlineObjective(name="d", target=0.9, min_events=5)
    assert obj.burn(roll, 3) is None  # no traffic -> no signal
    _feed_window(roll, clock, requests=10, met=8)
    # error rate 0.2 over budget 0.1 -> burn 2.0
    assert obj.burn(roll, 3) == pytest.approx(2.0)
    roll2 = WindowedRollup(1.0, clock=clock)
    for _ in range(3):
        roll2.count("requests")
    assert obj.burn(roll2, 3) is None  # below min_events


def test_monitor_fires_and_clears_with_hysteresis():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, max_windows=16, clock=clock)
    reg = MetricsRegistry()
    obj = DeadlineObjective(
        name="deadline", target=0.9, short_windows=2, long_windows=5,
        fire_burn=2.0, clear_burn=1.0,
    )
    mon = SLOMonitor(roll, [obj], registry=reg, clock=clock)

    # Healthy traffic: no transition.
    _feed_window(roll, clock, requests=10, met=10)
    assert mon.evaluate() == []
    assert "deadline" not in mon.active

    # Sustained misses: both spans burn >= 2 -> exactly one "fired".
    for _ in range(5):
        _feed_window(roll, clock, requests=10, met=0)
    fired = mon.evaluate()
    assert [a.transition for a in fired] == ["fired"]
    assert "deadline" in mon.active
    assert mon.evaluate() == []  # steady state, no re-fire
    assert reg.get("slo_alert_active").labels(objective="deadline").value \
        == 1.0
    assert reg.get("slo_burn_rate").labels(
        objective="deadline", window="short"
    ).value >= 2.0

    # Recovery: good traffic until the bad windows age out of both spans.
    for _ in range(6):
        _feed_window(roll, clock, requests=10, met=10)
    cleared = mon.evaluate()
    assert [a.transition for a in cleared] == ["cleared"]
    assert mon.active == {}
    assert reg.get("slo_alerts_total").labels(
        objective="deadline", transition="fired"
    ).value == 1
    assert reg.get("slo_alerts_total").labels(
        objective="deadline", transition="cleared"
    ).value == 1
    assert [a.transition for a in mon.history] == ["fired", "cleared"]


def test_monitor_requires_both_spans_to_fire():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, max_windows=32, clock=clock)
    obj = DeadlineObjective(
        name="d", target=0.9, short_windows=2, long_windows=20,
        fire_burn=2.0, clear_burn=1.0,
    )
    mon = SLOMonitor(roll, [obj], registry=MetricsRegistry(), clock=clock)
    # Long healthy history dilutes the long span below fire_burn: one bad
    # window must NOT page.
    for _ in range(18):
        _feed_window(roll, clock, requests=10, met=10)
    _feed_window(roll, clock, requests=10, met=0)
    assert mon.evaluate() == []


def test_monitor_emits_alert_events_on_context_tracer():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, clock=clock)
    obj = DeadlineObjective(
        name="d", target=0.9, short_windows=2, long_windows=3,
        fire_burn=2.0, clear_burn=1.0,
    )
    mon = SLOMonitor(roll, [obj], registry=MetricsRegistry(), clock=clock)
    for _ in range(3):
        _feed_window(roll, clock, requests=10, met=0)
    tr = Tracer(clock=clock)
    with use_tracer(tr):
        with tr.span("serve.batch"):
            assert len(mon.evaluate()) == 1
    events = tr.traces()[0].find("slo.alert")
    assert len(events) == 1
    assert events[0].attrs["transition"] == "fired"
    assert events[0].attrs["objective"] == "d"


def test_latency_and_accuracy_objectives():
    clock = FakeClock(0.0)
    roll = WindowedRollup(1.0, clock=clock)
    lat = LatencyObjective(name="p_lat", target=0.5, threshold_ms=10.0)
    acc = AccuracyObjective(name="p_acc", target=0.5, max_divergence=0.3)
    for v in (5.0, 15.0, 25.0, 8.0):
        roll.observe("stage1_ms", v)
    for v in (0.1, 0.5, 0.2, 0.9):
        roll.observe("accuracy_proxy", v)
    good, total = lat.good_total(roll, 3)
    assert (good, total) == (2, 4)
    assert lat.p99(roll, 3) > 10.0
    good, total = acc.good_total(roll, 3)
    assert (good, total) == (2, 4)
    # Burn: error rate 0.5 / budget 0.5 -> 1.0 for both.
    assert lat.burn(roll, 3) == pytest.approx(1.0)
    assert acc.burn(roll, 3) == pytest.approx(1.0)


def test_duplicate_objective_names_rejected():
    roll = WindowedRollup(1.0, clock=FakeClock())
    objs = [DeadlineObjective(name="x"), LatencyObjective(name="x")]
    with pytest.raises(ValueError):
        SLOMonitor(roll, objs, registry=MetricsRegistry())


def test_default_objectives_cover_deadline_and_accuracy():
    names = {o.name for o in default_objectives()}
    assert names == {"deadline_met", "accuracy_floor"}


# ---------------------------------------------------------------------------
# LoadSignal + DeadlineController integration
# ---------------------------------------------------------------------------

def test_load_signal_windowed_quantile_and_aging():
    clock = FakeClock(0.0)
    sig = LoadSignal(window_s=1.0, windows=5, quantile=90.0, clock=clock)
    assert sig.correction("knn") == 1.0  # no data -> neutral
    sig.observe("knn", 1.0, 2.0)
    assert sig.correction("knn") == pytest.approx(2.0)
    # Ratios are clamped into [0.25, 4.0].
    sig.observe("knn", 1.0, 100.0)
    assert sig.correction("knn") <= 4.0
    # The spike ages out of the window span entirely.
    clock.t = 100.0
    assert sig.correction("knn") == 1.0


def test_load_signal_is_quantile_not_mean():
    clock = FakeClock(0.0)
    sig = LoadSignal(window_s=1.0, windows=10, quantile=90.0, clock=clock)
    for _ in range(8):
        sig.observe("knn", 1.0, 1.0)
    sig.observe("knn", 1.0, 3.0)
    sig.observe("knn", 1.0, 3.0)
    # p90 of eight 1.0s and two 3.0s is 3.0 — well above the mean (1.4).
    assert sig.correction("knn") == pytest.approx(3.0)


def test_controller_observe_feeds_load_signal():
    clock = FakeClock(0.0)
    sig = LoadSignal(window_s=1.0, windows=5, clock=clock)
    ctl = DeadlineController(load_signal=sig)
    ctl.observe("knn", 1.0, 2.0)
    assert ctl.correction("knn") == pytest.approx(2.0)
    # Windowed: the slow batch ages out and the correction relaxes, which
    # the EMA path never does without new observations.
    clock.t = 100.0
    ctl.observe("knn", 1.0, 1.0)
    assert ctl.correction("knn") == pytest.approx(1.0)


def test_controller_without_load_signal_keeps_ema_path():
    ctl = DeadlineController(ema=0.3)
    ctl.observe("knn", 1.0, 2.0)
    # old=1.0 -> 0.7*1.0 + 0.3*1.0*2.0
    assert ctl.correction("knn") == pytest.approx(1.3)
    assert ctl.load_signal is None


# ---------------------------------------------------------------------------
# StragglerWatch + supervisor wiring
# ---------------------------------------------------------------------------

def test_straggler_watch_fires_on_skew_and_clears():
    clock = FakeClock(0.0)
    reg = MetricsRegistry()
    watch = StragglerWatch(
        window_s=1.0, windows=5, min_beats=3, skew_fire=2.0,
        skew_clear=1.25, registry=reg, clock=clock,
    )
    tr = Tracer(clock=clock)
    with use_tracer(tr), tr.span("run"):
        # Three shards; shard 2 is 10x slower than the fleet.
        for step in range(3):
            watch.beat(0, step, 0.01)
            watch.beat(1, step, 0.01)
            skew = watch.beat(2, step, 0.10)
        assert skew == pytest.approx(10.0)
        assert watch.straggling == {2}
        assert reg.get("runtime_straggler_alerts_total").labels(
            shard=2, transition="fired"
        ).value == 1
        assert reg.get("runtime_shard_latency_skew").labels(
            shard=2
        ).value == pytest.approx(10.0)
        # Recovery: slow samples age out, fresh beats are fleet-speed.
        clock.t = 50.0
        for step in range(3, 6):
            watch.beat(0, step, 0.01)
            watch.beat(1, step, 0.01)
            skew = watch.beat(2, step, 0.01)
        assert skew == pytest.approx(1.0)
        assert watch.straggling == set()
        assert reg.get("runtime_straggler_alerts_total").labels(
            shard=2, transition="cleared"
        ).value == 1
    names = [sp.name for root in tr.traces() for sp in root.walk()]
    assert "shard.straggling" in names
    assert "shard.recovered" in names


def test_straggler_watch_needs_min_beats():
    watch = StragglerWatch(
        min_beats=3, registry=MetricsRegistry(), clock=FakeClock(),
    )
    assert watch.beat(0, 0, 5.0) == 1.0  # too few samples -> neutral skew
    assert watch.straggling == set()


# ---------------------------------------------------------------------------
# FlightRecorder
# ---------------------------------------------------------------------------

def _root(clock, dur_s: float, name="serve.batch"):
    tr = Tracer(clock=clock)
    with tr.span(name, kind="knn"):
        with tr.span("stage1"):
            clock.advance(dur_s)
    return tr.traces()[-1]


def test_flight_slo_missed_always_kept():
    clock = FakeClock(0.0)
    fr = FlightRecorder(capacity=8, tail_fraction=0.1)
    # Warm the duration history so later fast batches are not tail.
    for _ in range(20):
        fr.record(_root(clock, 0.010))
    reason = fr.record(
        _root(clock, 0.001),  # fast batch: NOT in the slow tail
        [make_response(rid=1, deadline_met=False)],
    )
    assert reason == "slo_missed"
    missed = fr.entries(["slo_missed"])
    assert len(missed) == 1
    assert missed[0].missed_rids == (1,)


def test_flight_reexecution_misses_do_not_count():
    fr = FlightRecorder(capacity=4, tail_fraction=0.0)
    reason = fr.record(
        _root(FakeClock(0.0), 0.01),
        [make_response(rid=1, deadline_met=False, reexecuted=True)],
    )
    assert reason is None  # relaxed re-exec deadline: not an SLO miss


def test_flight_escalated_kept():
    fr = FlightRecorder(capacity=4, tail_fraction=0.0)
    reason = fr.record(
        _root(FakeClock(0.0), 0.01),
        [make_response(rid=2, deadline_met=True, escalated=True)],
    )
    assert reason == "escalated"


def test_flight_tail_sampling_policy():
    clock = FakeClock(0.0)
    fr = FlightRecorder(capacity=64, tail_fraction=0.1)
    # 50 batches at 10ms build the history; a 5ms batch is dropped, a
    # 100ms batch is retained as tail.
    for _ in range(50):
        fr.record(_root(clock, 0.010))
    assert fr.record(_root(clock, 0.005)) is None
    assert fr.record(_root(clock, 0.100)) == "tail"
    assert fr.dropped_tail >= 1
    assert fr.summary()["by_reason"]["tail"] >= 1


def test_flight_tail_fraction_zero_keeps_only_bad_batches():
    clock = FakeClock(0.0)
    fr = FlightRecorder(capacity=8, tail_fraction=0.0)
    assert fr.record(_root(clock, 0.5)) is None
    assert fr.record(
        _root(clock, 0.001), [make_response(deadline_met=False)]
    ) == "slo_missed"
    assert len(fr) == 1


def test_flight_ring_evicts_tail_before_priority():
    clock = FakeClock(0.0)
    fr = FlightRecorder(capacity=3, tail_fraction=1.0)  # keep everything
    fr.record(_root(clock, 0.01), [make_response(rid=1, deadline_met=False)])
    fr.record(_root(clock, 0.01))  # tail
    fr.record(_root(clock, 0.01))  # tail
    fr.record(_root(clock, 0.01))  # tail -> evicts the OLDEST TAIL entry
    assert len(fr) == 3
    reasons = [e.reason for e in fr.entries()]
    assert reasons.count("slo_missed") == 1  # priority survived
    assert fr.evicted_tail == 1
    assert fr.evicted_priority == 0
    # All-priority ring: the oldest priority entry finally goes.
    for rid in range(2, 6):
        fr.record(
            _root(clock, 0.01),
            [make_response(rid=rid, deadline_met=False)],
        )
    assert len(fr) == 3
    assert all(e.reason == "slo_missed" for e in fr.entries())
    assert fr.evicted_priority >= 1


def test_flight_jsonl_roundtrip_and_schema(tmp_path):
    clock = FakeClock(0.0)
    fr = FlightRecorder(capacity=8, tail_fraction=1.0)
    fr.record(_root(clock, 0.02), [make_response(rid=7, deadline_met=False)])
    fr.record(_root(clock, 0.01))
    path = tmp_path / "flight.jsonl"
    fr.dump(path)
    text = path.read_text()
    assert validate_flight_jsonl(text) == []
    entries = [json.loads(line) for line in text.splitlines()]
    assert [e["reason"] for e in entries] == ["slo_missed", "tail"]
    assert entries[0]["missed_rids"] == [7]
    # Full span tree travels with the entry.
    assert {sp["name"] for sp in entries[0]["spans"]} \
        == {"serve.batch", "stage1"}
    # A corrupted line is caught.
    assert validate_flight_jsonl('{"schema": 1}\n') != []


# ---------------------------------------------------------------------------
# ServeMetrics windowed view + disabled-path pin
# ---------------------------------------------------------------------------

def test_serve_metrics_windowed_view():
    clock = FakeClock(0.0)
    m = ServeMetrics(window_s=1.0, clock=clock)
    for i in range(10):
        m.record(make_response(rid=i, stage1_ms=4.0, deadline_met=(i < 8)))
    m.record(make_response(rid=99, stage1_ms=50.0, reexecuted=True))
    w = m.windowed(windows=10)
    assert w["requests"] == 10           # re-execution excluded
    assert w["deadline_met_rate"] == pytest.approx(0.8)
    assert w["stage1_latency_ms"]["p50"] == pytest.approx(4.0)
    assert m.summary()["windowed"]["requests"] == 10
    # The window forgets; the lifetime reservoirs don't.
    clock.t = 1000.0
    assert m.windowed(windows=10)["requests"] == 0
    assert m.summary()["n_requests"] == 10


def test_serve_metrics_rollup_feeds_slo_monitor():
    clock = FakeClock(0.0)
    m = ServeMetrics(window_s=1.0, clock=clock)
    obj = DeadlineObjective(
        name="d", target=0.9, short_windows=2, long_windows=4,
        fire_burn=2.0, clear_burn=1.0,
    )
    mon = SLOMonitor(m.rollup, [obj], registry=MetricsRegistry(),
                     clock=clock)
    for w in range(4):
        for i in range(5):
            m.record(make_response(rid=w * 10 + i, deadline_met=False))
        clock.advance(1.0)
    assert [a.transition for a in mon.evaluate()] == ["fired"]


def test_serve_metrics_disabled_path_is_noop():
    m = ServeMetrics()  # no window_s: the decision layer costs nothing
    assert m.rollup is None
    m.record(make_response())
    assert "windowed" not in m.summary()
    with pytest.raises(RuntimeError):
        m.windowed()


def test_serve_metrics_reset_clears_rollup():
    clock = FakeClock(0.0)
    m = ServeMetrics(window_s=1.0, clock=clock)
    m.record(make_response())
    m.reset()
    assert m.windowed()["requests"] == 0
    assert m.rollup.window_s == 1.0


# ---------------------------------------------------------------------------
# kernel probe shape labels
# ---------------------------------------------------------------------------

def test_pow2_bucketing():
    assert _pow2_bucket(0) == 0
    assert _pow2_bucket(1) == 1
    assert _pow2_bucket(2) == 2
    assert _pow2_bucket(3) == 4
    assert _pow2_bucket(1000) == 1024
    assert _pow2_bucket(1024) == 1024


def test_dominant_shape_label_picks_largest_input():
    args = (
        torch.zeros((100, 48), dtype=torch.float32),
        torch.zeros((3000,), dtype=torch.int32),   # fewer bytes than the matrix
        2.5,
    )
    assert dominant_shape_label(args) == "128x64"
    assert dominant_shape_label((1.0, 2)) == "scalar"
    assert dominant_shape_label((torch.zeros(()),)) == "scalar"


def test_probe_summary_merges_shapes_by_default():
    reg = MetricsRegistry()
    probe = KernelProbe(reg)

    def fn(x):
        return x * 2.0

    probe.timed("myop", fn, (torch.ones((100, 8), dtype=torch.float32),), {})
    probe.timed("myop", fn, (torch.ones((1000, 8), dtype=torch.float32),), {})
    merged = probe.summary()
    (key,) = merged.keys()
    assert key.startswith("myop[") and key.count("[") == 1
    assert merged[key]["count"] == 2
    by_shape = probe.summary(by_shape=True)
    assert len(by_shape) == 2
    assert {k.rsplit("[", 1)[1].rstrip("]") for k in by_shape} \
        == {"128x8", "1024x8"}
    assert sum(v["count"] for v in by_shape.values()) == 2


# ---------------------------------------------------------------------------
# parity with the JAX package: the same feed under the same clock
# ---------------------------------------------------------------------------

def _feed(pkg, seed: int):
    """Drive ServeMetrics + SLOMonitor + FlightRecorder of one package
    (``pkg``: the modules to take them from) through 60 windows of traffic
    whose deadline-met share and accuracy proxy drift from a seed, with a
    bad stretch in the middle; returns what each layer reports."""
    import numpy as np

    r = np.random.default_rng(seed)
    clock = FakeClock(0.0)
    m = pkg["ServeMetrics"](window_s=1.0, clock=clock)
    objectives = pkg["default_objectives"]() + [
        pkg["DeadlineObjective"](name="tight", target=0.99, short_windows=2,
                                 long_windows=6, fire_burn=3.0,
                                 clear_burn=1.5),
        pkg["LatencyObjective"](name="lat", target=0.9, threshold_ms=12.0),
    ]
    reg = pkg["MetricsRegistry"]()
    mon = pkg["SLOMonitor"](m.rollup, objectives, registry=reg, clock=clock)
    fr = pkg["FlightRecorder"](capacity=16, tail_fraction=0.1)
    alerts, rid = [], 0
    for w in range(60):
        bad = 20 <= w < 32
        tr = pkg["Tracer"](clock=clock)
        with tr.span("serve.batch", kind="knn", window=w):
            resps = []
            for _ in range(int(r.integers(3, 9))):
                met = bool(r.random() < (0.5 if bad else 0.995))
                resp = pkg["Response"](
                    rid=rid, kind="knn", stage1=None, refined=None,
                    eps_granted=float(r.choice([0.0, 0.01, 0.32])),
                    compression_ratio=20.0, deadline_s=0.05,
                    queue_wait_s=0.0,
                    stage1_latency_s=float(r.uniform(1, 30 if bad else 10))
                    / 1e3,
                    total_latency_s=float(r.uniform(10, 40)) / 1e3,
                    deadline_met=met, escalated=bool(r.random() < 0.05),
                    reexecuted=False,
                    accuracy_proxy=float(r.uniform(0, 0.9 if bad else 0.3)),
                )
                m.record(resp)
                resps.append(resp)
                rid += 1
            clock.advance(0.25)
            alerts += [(a.objective, a.transition, a.burn_short, a.burn_long,
                        a.at) for a in mon.evaluate()]
        fr.record(tr.traces()[-1], resps)
        clock.advance(0.75)
    return {"alerts": alerts, "windowed": m.windowed(windows=10),
            "summary": m.summary(), "flight": fr.to_jsonl(),
            "snapshot": reg.snapshot(), "active": sorted(mon.active)}


def _pkg_port():
    return {"ServeMetrics": ServeMetrics, "default_objectives":
            default_objectives, "DeadlineObjective": DeadlineObjective,
            "LatencyObjective": LatencyObjective,
            "MetricsRegistry": MetricsRegistry, "SLOMonitor": SLOMonitor,
            "FlightRecorder": FlightRecorder, "Tracer": Tracer,
            "Response": Response}


def _pkg_reference():
    return {"ServeMetrics": jserve_metrics.ServeMetrics,
            "default_objectives": jslo.default_objectives,
            "DeadlineObjective": jslo.DeadlineObjective,
            "LatencyObjective": jslo.LatencyObjective,
            "MetricsRegistry": jmetrics.MetricsRegistry,
            "SLOMonitor": jslo.SLOMonitor,
            "FlightRecorder": jflight.FlightRecorder,
            "Tracer": jtrace.Tracer, "Response": jrequest.Response}


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_monitor_raises_the_reference_alerts(seed):
    got, want = _feed(_pkg_port(), seed), _feed(_pkg_reference(), seed)
    assert got["alerts"], "the bad stretch must fire something"
    assert {t for _, t, *_ in got["alerts"]} == {"fired", "cleared"}
    assert got["alerts"] == want["alerts"]
    assert got["active"] == want["active"]
    assert json.dumps(got["snapshot"], sort_keys=True) == json.dumps(
        want["snapshot"], sort_keys=True)


@pytest.mark.parametrize("seed", [2])
def test_serve_metrics_and_flight_equal_the_reference(seed):
    got, want = _feed(_pkg_port(), seed), _feed(_pkg_reference(), seed)
    assert json.dumps(got["windowed"], sort_keys=True) == json.dumps(
        want["windowed"], sort_keys=True)
    assert json.dumps(got["summary"], sort_keys=True, default=str) == \
        json.dumps(want["summary"], sort_keys=True, default=str)
    assert got["flight"] == want["flight"]
    assert validate_flight_jsonl(got["flight"]) == []
    assert jflight.validate_flight_jsonl(got["flight"]) == []


def test_rollup_and_load_signal_equal_the_reference():
    clock = FakeClock(3.5)
    ours = WindowedRollup(0.5, max_windows=8, clock=clock)
    theirs = jtimeseries.WindowedRollup(0.5, max_windows=8, clock=clock)
    sig = LoadSignal(window_s=0.5, windows=4, clock=clock)
    jsig = jslo.LoadSignal(window_s=0.5, windows=4, clock=clock)
    for i in range(200):
        for roll in (ours, theirs):
            roll.observe("x", (i * 13 % 17) / 3.0)
            roll.count("n", i % 3)
        for s in (sig, jsig):
            s.observe("knn", 0.01, 0.01 * (1 + (i * 7 % 11) / 5.0))
        clock.advance(0.07)
        if i % 9 == 0:
            assert ours.quantile("x", 90, windows=4) == theirs.quantile(
                "x", 90, windows=4)
            assert ours.rate("n", 4) == theirs.rate("n", 4)
            assert ours.values("x", 3) == theirs.values("x", 3)
            assert ours.window_starts() == theirs.window_starts()
            assert sig.correction("knn") == jsig.correction("knn")
