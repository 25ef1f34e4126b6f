"""The port's observability (``repro_torch.obs``): the scenarios of
``tests/test_obs.py`` replayed on it, and parity with the JAX package: the
golden exports byte for byte, the port's exports through the reference's
schema checks, and the kernel probe's op labels."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import normal, rng, th
from repro.kernels import ops as jops
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.apps.knn import KNNServable
from repro_torch.core import engine as engine_lib
from repro_torch.core.budget import BudgetPolicy, CostModel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, Reservoir, percentile,
    validate_snapshot,
)
from repro_torch.obs.probes import (
    KernelProbe, install_kernel_probe, uninstall_kernel_probe,
)
from repro_torch.obs.trace import (
    NULL_TRACER, Tracer, current_tracer, use_tracer, validate_trace_jsonl,
)
from repro_torch.serve import ContinuousBatcher, DeadlineController, Server
from repro_torch.serve.metrics import ServeMetrics, slo_class
from repro_torch.serve.request import Response

GOLDEN = Path(__file__).parent / "golden"

# The JAX package's op labels: the first argument of each ``@_probed`` in
# src/repro/kernels/ops.py, by public function.
REFERENCE_OPS = (
    "knn_distance", "distance_topk", "candidate_topk", "refine_distances",
    "lsh_hash", "cf_weights", "cf_refine", "agg_refine_attention",
    "aggregated_attention_decode",
)


# ---------------------------------------------------------------------------
# percentile
# ---------------------------------------------------------------------------

def test_percentile_edge_cases():
    assert math.isnan(percentile([], 50))
    assert percentile([7.0], 0) == 7.0
    assert percentile([7.0], 100) == 7.0
    xs = [3.0, 1.0, 2.0]
    assert percentile(xs, 0) == 1.0
    assert percentile(xs, 100) == 3.0          # exactly max, no overshoot
    assert percentile(xs, 50) == 2.0
    assert percentile(xs, 150) == 3.0          # clamped
    assert percentile(xs, -10) == 1.0          # clamped


def test_percentile_matches_numpy_linear():
    r = np.random.default_rng(0)
    xs = r.normal(size=37).tolist()
    for p in (0, 1, 25, 50, 75, 99, 100):
        assert percentile(xs, p) == pytest.approx(
            float(np.percentile(xs, p)), rel=1e-12
        )


# ---------------------------------------------------------------------------
# series types
# ---------------------------------------------------------------------------

def test_counter_is_monotonic():
    c = Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_moves_both_ways():
    g = Gauge()
    g.set(5)
    g.inc(2)
    g.dec(3)
    assert g.value == 4.0


def test_histogram_cumulative_buckets():
    h = Histogram(buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(5.555)
    assert h.cumulative() == [(0.01, 1), (0.1, 2), (1.0, 3), (math.inf, 4)]


def test_reservoir_memory_stays_flat_with_exact_stats():
    r = Reservoir(capacity=64)
    for i in range(10_000):
        r.observe(float(i))
    assert len(r.samples) == 64
    assert r.count == 10_000
    assert r.sum == sum(range(10_000))
    assert r.min == 0.0 and r.max == 9_999.0
    assert 2_000 < r.percentile(50) < 8_000


def test_reservoir_is_deterministic():
    a, b = Reservoir(capacity=16), Reservoir(capacity=16)
    for i in range(1_000):
        a.observe(float(i))
        b.observe(float(i))
    assert a.samples == b.samples


# ---------------------------------------------------------------------------
# registry + families
# ---------------------------------------------------------------------------

def test_registry_declarations_are_idempotent():
    r = MetricsRegistry()
    a = r.counter("x_total", "help", labels=("kind",))
    b = r.counter("x_total", labels=("kind",))
    assert a is b


def test_registry_rejects_kind_and_label_mismatch():
    r = MetricsRegistry()
    r.counter("x_total", labels=("kind",))
    with pytest.raises(ValueError):
        r.gauge("x_total", labels=("kind",))
    with pytest.raises(ValueError):
        r.counter("x_total", labels=("other",))


def test_labeled_series_and_label_validation():
    r = MetricsRegistry()
    fam = r.counter("req_total", labels=("kind", "slo"))
    fam.labels(kind="knn", slo="tight").inc(2)
    fam.labels(kind="cf", slo="tight").inc()
    assert fam.total() == 3
    assert len(list(fam.series())) == 2
    with pytest.raises(ValueError):
        fam.labels(kind="knn")
    with pytest.raises(ValueError):
        fam.inc()


def test_labelless_family_proxies_series_api():
    r = MetricsRegistry()
    r.counter("a_total").inc(3)
    r.gauge("b").set(7)
    r.reservoir("c").observe(1.5)
    assert r.get("a_total").value == 3
    assert r.get("b").value == 7
    assert r.get("c").merged_stats()["count"] == 1


def test_registry_reset_zeroes_but_keeps_families():
    r = MetricsRegistry()
    fam = r.counter("x_total", labels=("kind",))
    fam.labels(kind="knn").inc(5)
    r.reset()
    assert fam.labels(kind="knn").value == 0
    assert r.get("x_total") is fam


# ---------------------------------------------------------------------------
# exports: golden files, and the JAX package's schema checks
# ---------------------------------------------------------------------------

def _golden_registry(registry_cls=MetricsRegistry):
    """Filled as tests/test_obs.py fills the JAX package's registry."""
    r = registry_cls()
    c = r.counter("requests_total", "Requests by kind.", labels=("kind",))
    c.labels(kind="knn").inc(3)
    c.labels(kind="cf").inc(2)
    r.gauge("queue_depth", "Current queue depth.").set(5)
    h = r.histogram("latency_s", "Request latency.", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    res = r.reservoir("eps_granted", "Granted eps.", capacity=8)
    for v in (0.1, 0.2, 0.3, 0.4):
        res.observe(v)
    return r


def test_snapshot_schema_is_valid():
    snap = _golden_registry().snapshot()
    assert validate_snapshot(snap) == []
    assert jmetrics.validate_snapshot(snap) == []
    json.dumps(snap)


def test_snapshot_matches_golden():
    got = json.dumps(
        _golden_registry().snapshot(), indent=2, sort_keys=True
    ) + "\n"
    assert got == (GOLDEN / "metrics_snapshot.json").read_text()


def test_prometheus_matches_golden():
    got = _golden_registry().to_prometheus()
    assert got == (GOLDEN / "metrics.prom").read_text()


def test_exports_equal_the_reference_registry():
    """A busier registry than the golden one (labels, empty and many-sample
    reservoirs): the same snapshot and exposition as the JAX package's."""
    def fill(cls):
        r = _golden_registry(cls)
        fam = r.reservoir("lat_ms", "latency", labels=("kind", "slo"),
                          capacity=32)
        for i in range(500):
            fam.labels(kind=("knn", "cf")[i % 2],
                       slo=("tight", "relaxed")[i % 3 == 0]).observe(
                (i * 37 % 101) / 7.0)
        r.reservoir("empty_ms", "never observed")
        g = r.gauge("g", labels=("shard",))
        g.labels(shard=3).inc(2.5)
        g.labels(shard=3).dec(1)
        return r
    got, want = fill(MetricsRegistry), fill(jmetrics.MetricsRegistry)
    assert json.dumps(got.snapshot(), sort_keys=True) == json.dumps(
        want.snapshot(), sort_keys=True)
    assert got.to_prometheus() == want.to_prometheus()


def test_validate_snapshot_flags_drift():
    snap = _golden_registry().snapshot()
    snap["counters"][0].pop("help")
    assert validate_snapshot(snap)
    assert validate_snapshot({"schema": 1}) != []


# ---------------------------------------------------------------------------
# ServeMetrics on the registry
# ---------------------------------------------------------------------------

def _response(i: int, *, kind="knn", reexecuted=False, refined=1,
              escalated=False, proxy=None) -> Response:
    return Response(
        rid=i, kind=kind, stage1=0, refined=refined, eps_granted=0.1,
        compression_ratio=20.0, deadline_s=1.0, queue_wait_s=0.0,
        stage1_latency_s=0.001 * (i % 100 + 1),
        total_latency_s=0.002 * (i % 100 + 1),
        deadline_met=True, escalated=escalated, reexecuted=reexecuted,
        accuracy_proxy=proxy,
    )


def test_serve_metrics_memory_flat_over_10k_records():
    m = ServeMetrics(capacity=128)
    for i in range(10_000):
        m.record(_response(i, proxy=0.1))
    for fam_name in ("serve_stage1_latency_ms", "serve_total_latency_ms",
                     "serve_eps_granted", "serve_accuracy_proxy"):
        for _, series in m.registry.get(fam_name).series():
            assert len(series.samples) <= 128
            assert series.count == 10_000
    s = m.summary()
    assert s["n_requests"] == 10_000
    assert s["eps_granted"] == {"mean": pytest.approx(0.1),
                                "min": 0.1, "max": 0.1}
    assert s["accuracy_proxy"]["n"] == 10_000


def test_serve_metrics_summary_compat_keys_and_rates():
    m = ServeMetrics()
    m.record(_response(0, refined=None, escalated=True))
    m.record(_response(0, reexecuted=True))
    m.record_batch(100, occupancy=1, cache_source="built")
    m.record_batch(50, occupancy=1, cache_source="hit")
    s = m.summary(cache_stats={"hits": 1, "misses": 1, "coarsened_hits": 0})
    assert s["n_requests"] == 1 and s["n_reexecutions"] == 1
    assert s["n_batches"] == 2
    assert s["shuffle_bytes_total"] == 150
    assert s["mean_batch_occupancy"] == 1.0
    assert s["escalated_rate"] == 1.0
    assert s["refined_rate"] == 0.5
    assert s["deadline_met_rate"] == 1.0
    assert s["cache"]["coarsened_hit_rate"] == 0.0
    src = m.registry.get("serve_cache_source_total")
    assert {lbl["source"]: c.value for lbl, c in src.series()} == {
        "built": 1.0, "hit": 1.0,
    }


def test_serve_metrics_empty_summary_is_nan():
    s = ServeMetrics().summary()
    assert math.isnan(s["stage1_latency_ms"]["p50"])
    assert math.isnan(s["eps_granted"]["mean"])
    assert math.isnan(s["deadline_met_rate"])
    assert "accuracy_proxy" not in s


def test_serve_metrics_snapshot_and_reset():
    m = ServeMetrics()
    m.record(_response(1))
    assert validate_snapshot(m.snapshot()) == []
    m.reset()
    assert m.summary()["n_requests"] == 0
    assert m.n_batches == 0


def test_slo_class_buckets():
    assert slo_class(0.005) == "lt10ms"
    assert slo_class(0.05) == "lt100ms"
    assert slo_class(0.5) == "lt1s"
    assert slo_class(10.0) == "ge1s"


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def test_span_nesting_and_walk():
    tr = Tracer(clock=_fake_clock())
    with tr.span("root", kind="knn") as root:
        with tr.span("child_a"):
            with tr.span("leaf"):
                pass
        with tr.span("child_b") as b:
            b.set(x=1)
    (got,) = tr.traces()
    assert got is root
    assert [s.name for s in got.walk()] == [
        "root", "child_a", "leaf", "child_b",
    ]
    assert got.find("leaf")[0].parent_id == got.find("child_a")[0].span_id
    assert got.attrs == {"kind": "knn"}
    assert got.find("child_b")[0].attrs == {"x": 1}
    assert all(s.duration_s >= 0 for s in got.walk())
    assert got.duration_s > got.find("child_a")[0].duration_s


def test_add_span_and_event_record_explicit_times():
    tr = Tracer(clock=_fake_clock())
    with tr.span("root"):
        tr.add_span("queued", 0.25, 0.75, rid=7)
        tr.event("marker", shard=3)
    (root,) = tr.traces()
    queued = root.find("queued")[0]
    assert (queued.t_start, queued.t_end) == (0.25, 0.75)
    assert queued.attrs == {"rid": 7}
    marker = root.find("marker")[0]
    assert marker.duration_s == 0.0 and marker.attrs == {"shard": 3}


def test_tracer_jsonl_schema_and_render():
    tr = Tracer(clock=_fake_clock())
    with tr.span("root"):
        with tr.span("inner", bytes=128):
            pass
    text = tr.to_jsonl()
    assert validate_trace_jsonl(text) == []
    lines = [json.loads(l) for l in text.splitlines()]
    assert [l["name"] for l in lines] == ["root", "inner"]
    assert lines[1]["parent"] == lines[0]["span"]
    dump = tr.render()
    assert "root" in dump and "inner" in dump and "bytes=128" in dump


def test_trace_exports_equal_the_reference():
    """The same spans under the same clock: the JAX package's JSON lines
    and tree dump, and its schema check passes the port's lines."""
    def record(tracer_cls):
        tr = tracer_cls(clock=_fake_clock())
        with tr.span("serve.batch", kind="knn", n=3):
            tr.add_span("batcher.wait", 0.5, 1.5, rid=1)
            with tr.span("stage1", shuffle_bytes=4096):
                tr.event("store.get", source="built", ratio=20.0)
            with tr.span("stage2.refine", refine_budget=12, eps=0.0312345):
                pass
        with tr.span("serve.batch", kind="cf", n=1):
            pass
        return tr
    got, want = record(Tracer), record(jtrace.Tracer)
    assert got.to_jsonl() == want.to_jsonl()
    assert got.render() == want.render()
    assert jtrace.validate_trace_jsonl(got.to_jsonl()) == []
    bad = got.to_jsonl().replace('"attrs"', '"attributes"', 1)
    assert validate_trace_jsonl(bad) == jtrace.validate_trace_jsonl(bad) != []


def test_tracer_bounds_finished_traces():
    tr = Tracer(clock=_fake_clock(), max_traces=3)
    for i in range(5):
        with tr.span(f"t{i}"):
            pass
    assert [t.name for t in tr.traces()] == ["t2", "t3", "t4"]
    assert tr.dropped_traces == 2


def test_use_tracer_propagation():
    assert current_tracer() is NULL_TRACER
    tr = Tracer(clock=_fake_clock())
    with use_tracer(tr):
        assert current_tracer() is tr
        with current_tracer().span("via_context"):
            pass
    assert current_tracer() is NULL_TRACER
    assert tr.traces()[0].name == "via_context"


def test_null_tracer_is_a_noop():
    sp = NULL_TRACER.span("x", a=1)
    with sp as s:
        s.set(b=2)
    assert NULL_TRACER.traces() == []
    assert not NULL_TRACER.enabled


# ---------------------------------------------------------------------------
# engine tracing
# ---------------------------------------------------------------------------

def test_engine_records_map_and_reduce_spans():
    eng = engine_lib.MapReduce(mesh=None)
    x = torch.ones((16, 4))
    tr = Tracer()
    with use_tracer(tr):
        eng.run(
            lambda a: a * 2,
            engine_lib.CombineSpec(mode="psum", reduce_fn=lambda o: o + 1),
            x,
        )
    (root,) = tr.traces()
    assert root.name == "mapreduce"
    assert root.attrs["shards"] == 1
    assert root.attrs["shuffle_bytes"] == 16 * 4 * 4
    names = [s.name for s in root.walk()]
    assert "map.shard" in names and "reduce" in names
    assert root.find("map.shard")[0].attrs["shuffle_bytes"] == 16 * 4 * 4


def test_engine_untraced_path_records_nothing():
    eng = engine_lib.MapReduce(mesh=None)
    x = torch.ones((4, 4))
    out = eng.run(lambda a: a * 2, engine_lib.CombineSpec(mode="psum"), x)
    assert current_tracer() is NULL_TRACER
    np.testing.assert_array_equal(out.numpy(), x.numpy() * 2)


# ---------------------------------------------------------------------------
# kernel probe
# ---------------------------------------------------------------------------

def test_kernel_probe_records_host_level_calls():
    reg = MetricsRegistry()
    probe = install_kernel_probe(reg)
    try:
        a = torch.ones((4, 8))
        b = torch.ones((16, 8))
        kernel_ops.knn_distance(a, b)
        kernel_ops.knn_distance(a, b)
    finally:
        uninstall_kernel_probe()
    s = probe.summary()
    assert "knn_distance[ref]" in s
    row = s["knn_distance[ref]"]
    assert row["count"] == 2
    assert row["p50_s"] >= 0 and row["bytes"] == 2 * 4 * (32 + 128 + 64)
    assert probe.calls() == {"knn_distance": 2}


def test_kernel_probe_skips_calls_inside_a_graph_capture(monkeypatch):
    """The port's counterpart of skipping calls inside a jit trace: under
    a CUDA graph capture the call passes through untimed and uncounted
    (synchronising there is an error)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    reg = MetricsRegistry()
    probe = install_kernel_probe(reg)
    try:
        out = kernel_ops.knn_distance(torch.ones((4, 8)), torch.ones((16, 8)))
        assert out.shape == (4, 16)
        assert probe.summary() == {}
    finally:
        uninstall_kernel_probe()


def test_kernel_probe_uninstall_restores_lean_path():
    uninstall_kernel_probe()
    assert kernel_ops.get_probe() is None
    d = kernel_ops.knn_distance(torch.ones((2, 4)), torch.ones((8, 4)))
    assert d.shape == (2, 8)


def test_kernel_probe_preserves_op_results():
    reg = MetricsRegistry()
    r = rng(0)
    a, b = th(normal(r, 4, 8)), th(normal(r, 16, 8))
    bare = kernel_ops.knn_distance(a, b)
    install_kernel_probe(reg)
    try:
        probed = kernel_ops.knn_distance(a, b)
    finally:
        uninstall_kernel_probe()
    assert torch.equal(bare, probed)


class _Labels:
    """A probe that records each op label and runs nothing."""

    def __init__(self):
        self.ops = []

    def timed(self, op, fn, args, kwargs):
        self.ops.append(op)


@pytest.mark.parametrize("name", REFERENCE_OPS)
def test_probe_labels_equal_the_reference(name):
    """Each public op of the port reports the JAX package's label for the
    same function (the probe is called before the op runs, so the
    arguments are never read)."""
    got, want = _Labels(), _Labels()
    kernel_ops.set_probe(got)
    jops.set_probe(want)
    try:
        getattr(kernel_ops, name)(None)
        getattr(jops, name)(None)
    finally:
        kernel_ops.set_probe(None)
        jops.set_probe(None)
    assert got.ops == want.ops == [name]


def test_kernel_probe_labels_the_ops_it_times_as_the_reference():
    """Through ``KernelProbe`` itself, on real CPU calls of the kNN, LSH and
    CF ops: its ``op`` labels are the reference's names, ``path`` is
    ``ref`` for CPU tensors."""
    r = rng(3)
    qs, ps = th(normal(r, 4, 8)), th(normal(r, 10, 8))
    labs = th(np.arange(10, dtype=np.int32))
    reg = MetricsRegistry()
    probe = install_kernel_probe(reg)
    try:
        kernel_ops.knn_distance(qs, ps)
        kernel_ops.distance_topk(qs, ps, labs, k=3)
        d = th(normal(r, 4, 10))
        kernel_ops.candidate_topk(d, labs[None].expand(4, 10).contiguous(),
                                  k=3)
        kernel_ops.lsh_hash(qs, th(normal(r, 8, 3)), th(np.zeros(3,
                                                                 np.float32)),
                            4.0)
        kernel_ops.lsh_bucket_ids(qs, th(normal(r, 8, 3)),
                                  th(np.zeros(3, np.float32)), 4.0, base=64)
    finally:
        uninstall_kernel_probe()
    labels = {lbl["op"]: lbl["path"]
              for lbl, _ in reg.get("kernel_calls_total").series()}
    assert labels == dict.fromkeys(
        ("knn_distance", "distance_topk", "candidate_topk", "lsh_hash"),
        "ref")
    assert set(labels) <= set(REFERENCE_OPS)
    assert probe.calls()["lsh_hash"] == 2


def test_dispatch_path_names_the_device():
    assert kernel_ops.dispatch_path(torch.ones(2)) == "ref"
    with pytest.raises(ValueError):
        kernel_ops.dispatch_path(torch.ones(2, device="meta"))


# ---------------------------------------------------------------------------
# serving-path span tree end to end
# ---------------------------------------------------------------------------

N_KNN, D_KNN, N_CLASSES = 256, 8, 5


@pytest.fixture(scope="module")
def knn_servable():
    r = rng(0)
    x = normal(r, N_KNN, D_KNN)
    y = r.integers(0, N_CLASSES, N_KNN).astype(np.int32)
    return KNNServable(x, y, n_classes=N_CLASSES, k=3,
                       lsh_generator=torch.Generator().manual_seed(7),
                       device="cpu")


def _traced_server(knn_servable):
    policy = BudgetPolicy(
        compression_ratio=20.0, eps_max=0.32, degrade_floor=0.004
    )
    ctl = DeadlineController(policy, ema=0.0)
    ctl.set_model(
        "knn", CostModel(c_fixed=0.0, c_stage1=0.0, c_stage2=1.0 / N_KNN)
    )
    return Server(
        [knn_servable],
        controller=ctl,
        batcher=ContinuousBatcher(max_batch=4, pad_sizes=(4,)),
        tracer=Tracer(),
    )


def test_server_submit_drain_produces_full_span_tree(knn_servable):
    knn_servable.store.invalidate(knn_servable)
    server = _traced_server(knn_servable)
    rid = server.submit("knn", (knn_servable.train_x[0],), deadline_s=10.0)
    server.submit("knn", (knn_servable.train_x[1],), deadline_s=10.0)
    responses = server.drain()
    assert {r.rid for r in responses} >= {rid}

    (root,) = server.tracer.traces()
    assert root.name == "serve.batch"
    assert root.attrs["kind"] == "knn" and root.attrs["n"] == 2
    assert root.attrs["shuffle_bytes"] > 0

    assert len(root.find("batcher.wait")) == 2
    grant = root.find("deadline.grant")[0]
    assert grant.attrs["eps"] == 0.32 and grant.attrs["refine_budget"] > 0
    lookup = root.find("cache.lookup")[0]
    assert lookup.attrs == {"hit": False, "source": "built"}
    assert root.find("store.get")[0].parent_id == lookup.span_id
    stage1 = root.find("stage1")[0]
    mr = root.find("mapreduce")
    assert len(mr) == 2
    assert mr[0].parent_id == stage1.span_id
    shard = root.find("map.shard")[0]
    assert shard.attrs["shuffle_bytes"] > 0
    assert shard.duration_s >= 0
    refine = root.find("stage2.refine")[0]
    assert refine.attrs["refine_budget"] == grant.attrs["refine_budget"]
    assert root.find("reduce")

    # The port's schemas, and the JAX package's, accept the exports.
    assert validate_trace_jsonl(server.tracer.to_jsonl()) == []
    assert jtrace.validate_trace_jsonl(server.tracer.to_jsonl()) == []
    assert validate_snapshot(server.metrics.snapshot()) == []
    assert jmetrics.validate_snapshot(server.metrics.snapshot()) == []


def test_server_second_batch_traces_cache_hit(knn_servable):
    server = _traced_server(knn_servable)
    for _ in range(2):
        server.submit("knn", (knn_servable.train_x[0],), deadline_s=10.0)
        server.drain()
    first, second = server.tracer.traces()
    assert first.find("cache.lookup")[0].attrs["hit"] is False
    assert second.find("cache.lookup")[0].attrs["hit"] is True
    assert second.find("store.get") == []


def test_server_records_accuracy_proxy_end_to_end(knn_servable):
    server = _traced_server(knn_servable)
    server.submit("knn", (knn_servable.train_x[0],), deadline_s=10.0)
    (resp,) = server.drain()
    assert resp.refined is not None
    assert resp.accuracy_proxy is not None
    assert 0.0 <= resp.accuracy_proxy <= 1.0
    s = server.summary()
    assert s["accuracy_proxy"]["n"] == 1
    assert s["accuracy_proxy"]["mean"] == pytest.approx(resp.accuracy_proxy)


def test_untraced_server_stays_lean(knn_servable):
    server = Server(
        [knn_servable],
        controller=DeadlineController(
            BudgetPolicy(compression_ratio=20.0, eps_max=0.32), ema=0.0
        ),
        batcher=ContinuousBatcher(max_batch=4, pad_sizes=(4,)),
    )
    assert server.tracer is NULL_TRACER
    server.submit("knn", (knn_servable.train_x[0],), deadline_s=10.0)
    (resp,) = [r for r in server.drain() if not r.reexecuted]
    assert resp.stage1 is not None
    assert NULL_TRACER.traces() == []


def test_knn_accuracy_proxy_is_zero_for_identical_outputs(knn_servable):
    q = knn_servable.train_x[:2]
    out = knn_servable.run(
        knn_servable.build(20.0), (q,), refine_budget=0
    )
    proxies = knn_servable.accuracy_proxy(out, out, 2)
    assert proxies == [0.0, 0.0]


def test_probe_counts_equal_the_calls_a_server_makes(knn_servable):
    """A probe installed around served batches counts each op once a call
    (what the card phase holds against the kernels' launch counts)."""
    server = _traced_server(knn_servable)
    server.prewarm("knn")
    seen = []

    class Counting(KernelProbe):
        def timed(self, op, fn, args, kwargs):
            seen.append(op)
            return super().timed(op, fn, args, kwargs)

    reg = MetricsRegistry()
    kernel_ops.set_probe(Counting(reg))
    try:
        for i in range(3):
            server.submit("knn", (knn_servable.train_x[i],), deadline_s=10.0)
        server.drain()
    finally:
        uninstall_kernel_probe()
    counted = {}
    for lbl, c in reg.get("kernel_calls_total").series():
        counted[lbl["op"]] = counted.get(lbl["op"], 0) + int(c.value)
    assert counted == {op: seen.count(op) for op in set(seen)}
    assert set(counted) <= set(REFERENCE_OPS)
    assert counted["distance_topk"] >= 1
