"""The port's BENCH regression gate (``repro_torch.obs.regression``) against
the JAX package's, on the CPU.

The gate scenarios of ``tests/test_obs_slo.py`` (the tolerance edges in
both directions, slack, missing paths, a self-comparison, an injected p50
regression, the non-gating watch channel) run on both packages: each
asserts what the reference test asserts, and the two packages' findings,
statuses, limits and rendered reports are equal.  The CLI scenario is not
replayed: it drives ``benchmarks/compare.py``, whose port waits for the
port's benchmarks.
"""
import json

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.obs import regression as jreg
from repro_torch import obs as tobs
from repro_torch.obs import regression as treg

PACKAGES = {"jax": jreg, "torch": treg}

COMBINED = {
    "serve_latency": {
        "stage1_latency_ms": {"p50": 3.0, "p99": 8.0},
        "total_latency_ms": {"p50": 5.0, "p99": 12.0},
        "deadline_met_rate": 0.97,
        "cache": {"hit_rate": 0.99},
    },
    "kernel_bench": {
        "stage1_bytes_reduction": 2.9,
        "stage2_bytes_reduction": 2.9,
    },
    "store_reuse": {"merge_speedup": 3.0},
}

WATCHED = {
    "kernel_bench": {
        "sizes": [
            {"n": 2000, "stage1": {"speedup": 0.9},
             "stage2": {"speedup": 0.5}},
        ],
        "measured": {"knn_distance[ref]": {"p50_s": 0.002}},
    }
}


def _edges_lower(reg):
    spec = reg.MetricSpec("m", "lower", tolerance=0.1, absolute=0.0)
    base = {"m": 100.0}
    return [reg.compare_metric(spec, base, {"m": v})
            for v in (110.0, 110.0001, 89.0, 95.0)]


def _edges_higher(reg):
    spec = reg.MetricSpec("m", "higher", tolerance=0.0, absolute=0.1)
    base = {"m": 0.9}
    return [reg.compare_metric(spec, base, {"m": v})
            for v in (0.8, 0.79, 1.0, 1.01)]


def _slack(reg):
    spec = reg.MetricSpec("m", "lower", tolerance=0.1)
    base = {"m": 100.0}
    return [reg.compare_metric(spec, base, {"m": 115.0}),
            reg.compare_metric(spec, base, {"m": 115.0}, slack=2.0)]


def _missing(reg):
    spec = reg.MetricSpec("a.b.c", "lower")
    return [reg.compare_metric(spec, {}, {"a": {"b": {"c": 1.0}}})]


def _injected(reg):
    baseline = {
        "serve_latency": {"stage1_latency_ms": {"p50": 10.0, "p99": 20.0}}
    }
    current = json.loads(json.dumps(baseline))
    current["serve_latency"]["stage1_latency_ms"]["p50"] *= 1.5  # +50%
    return reg.compare(baseline, current)


def _watched(reg):
    worse = json.loads(json.dumps(WATCHED))
    worse["kernel_bench"]["sizes"][0]["stage1"]["speedup"] = 0.1
    return reg.compare(WATCHED, worse)


SCENARIOS = {"edges_lower": _edges_lower, "edges_higher": _edges_higher,
             "slack": _slack, "missing": _missing}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compare_metric_tolerance_edges(pkg):
    lower = [f.status for f in _edges_lower(PACKAGES[pkg])]
    assert lower == ["ok", "regression", "improved", "ok"]
    higher = [f.status for f in _edges_higher(PACKAGES[pkg])]
    assert higher == ["ok", "regression", "ok", "improved"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compare_metric_slack_scales_band(pkg):
    reg = PACKAGES[pkg]
    assert [f.status for f in _slack(reg)] == ["regression", "ok"]
    with pytest.raises(ValueError):
        reg.compare({}, {}, [reg.MetricSpec("m", "lower", tolerance=0.1)],
                    slack=0.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compare_missing_paths_never_gate(pkg):
    reg = PACKAGES[pkg]
    assert _missing(reg)[0].status == "missing"
    assert reg.compare({}, {}, [reg.MetricSpec("a.b.c", "lower")]).ok
    assert reg.get_path({"a": {"b": 2}}, "a.b") == 2
    assert reg.get_path({"a": 1}, "a.b") is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_self_comparison_always_passes(pkg):
    report = PACKAGES[pkg].compare(COMBINED, COMBINED)
    assert report.ok
    assert report.render().endswith("PASS")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_injected_p50_regression_fails_the_gate(pkg):
    reg = PACKAGES[pkg]
    report = _injected(reg)
    assert not report.ok
    assert [f.path for f in report.regressions] == [
        "serve_latency.stage1_latency_ms.p50"]
    assert "FAIL" in report.render()
    spec = next(s for s in reg.DEFAULT_SPECS
                if s.path == "serve_latency.stage1_latency_ms.p50")
    assert spec.tolerance < 0.20


@pytest.mark.parametrize("pkg", PACKAGES)
def test_watch_channel_reports_kernel_speedups_without_gating(pkg):
    report = _watched(PACKAGES[pkg])
    assert report.ok  # watch never gates
    names = {w.name for w in report.watch}
    assert "kernel_bench.stage1_speedup_n2000" in names
    assert "kernel_bench.measured.knn_distance[ref].p50_s" in names
    assert "watch" in report.render()


@pytest.mark.parametrize("name", SCENARIOS)
def test_findings_equal_the_reference(name):
    want, got = (SCENARIOS[name](reg) for reg in (jreg, treg))
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    assert [(f.delta, f.ratio) for f in got] == \
        [(f.delta, f.ratio) for f in want]


@pytest.mark.parametrize("scenario", [
    lambda reg: reg.compare(COMBINED, COMBINED),
    _injected, _watched,
    lambda reg: reg.compare(COMBINED, {}, slack=1.5),
], ids=["self", "injected", "watched", "absent"])
def test_reports_equal_the_reference(scenario):
    want, got = (scenario(reg) for reg in (jreg, treg))
    assert got.to_dict() == want.to_dict()
    assert got.render() == want.render()
    assert [f.path for f in got.regressions] == \
        [f.path for f in want.regressions]


def test_default_specs_equal_the_reference():
    assert [vars(s) for s in treg.DEFAULT_SPECS] == \
        [vars(s) for s in jreg.DEFAULT_SPECS]
    with pytest.raises(ValueError):
        treg.MetricSpec("m", "sideways")
    with pytest.raises(ValueError):
        treg.MetricSpec("m", tolerance=-0.1)


def test_exported_from_obs_as_the_reference_does():
    for name in ("DEFAULT_SPECS", "Finding", "MetricSpec", "Report",
                 "WatchEntry", "compare"):
        assert getattr(tobs, name) is getattr(treg, name)
        assert name in tobs.__all__
