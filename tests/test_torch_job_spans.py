"""The stage spans of the port's AccurateML jobs (``apps.knn`` and
``apps.cf`` ``run_accurateml``): their tree under ``torch.profiler`` and
under a live ``Tracer``, every torch op of a job inside one stage, nothing
recorded and nothing allocated with neither, and the same answers to the
bit either way.  CPU only, tiny sizes, no JAX."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.apps import cf, knn
from repro_torch.obs import trace as trace_lib
from repro_torch.obs.trace import (
    NULL_TRACER, SPAN_PREFIX, Tracer, current_tracer, use_tracer,
)

SHARDS = 2
STAGES = ("map.lsh", "map.aggregate", "map.stage1", "map.select",
          "map.refine", "reduce")
CASES = [("knn", 0.0), ("knn", 0.05), ("cf", 0.0), ("cf", 0.05)]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _job(app: str, eps: float):
    """A tiny job of ``app`` at ``eps``; returns a call running it."""
    g = torch.Generator().manual_seed(11)
    if app == "knn":
        x = torch.randn(600, 8, generator=g)
        y = torch.randint(0, 3, (600,), generator=g, dtype=torch.int32)
        q = torch.randn(24, 8, generator=g)
        return lambda: knn.run_accurateml(
            x, y, q, k=3, n_classes=3, compression_ratio=16.0, eps_max=eps,
            lsh_generator=torch.Generator().manual_seed(5), n_shards=SHARDS,
            device="cpu")
    mask = (torch.rand(316, 40, generator=g) < 0.25).float()
    ratings = torch.randint(1, 6, (316, 40), generator=g).float() * mask
    return lambda: cf.run_accurateml(
        ratings[16:], mask[16:], ratings[:16], mask[:16],
        compression_ratio=10.0, eps_max=eps,
        lsh_generator=torch.Generator().manual_seed(5), n_shards=SHARDS,
        device="cpu")


def _expected(app: str, eps: float) -> dict:
    """How often each stage opens in a job."""
    refined = SHARDS if eps > 0 else 0
    return {"map.lsh": SHARDS, "map.aggregate": SHARDS,
            "map.stage1": SHARDS, "map.select": refined,
            "map.refine": refined,
            "reduce": 1 if app == "knn" else SHARDS + 1}


def _profiled(run):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    return out, prof.events()


def _spans_above(event) -> list[str]:
    """The ``span:`` ranges holding ``event``, innermost first."""
    out, parent = [], event.cpu_parent
    while parent is not None:
        if parent.name.startswith(SPAN_PREFIX):
            out.append(parent.name[len(SPAN_PREFIX):])
        parent = parent.cpu_parent
    return out


@pytest.mark.parametrize("app,eps", CASES)
def test_profiler_sees_the_stages_of_a_job(app, eps):
    _, events = _profiled(_job(app, eps))
    spans = [e for e in events if e.name.startswith(SPAN_PREFIX)]
    names = [e.name[len(SPAN_PREFIX):] for e in spans]
    assert names.count("job") == 1
    want = _expected(app, eps)
    assert {s: names.count(s) for s in STAGES} == want
    assert set(names) == {"job"} | {s for s, n in want.items() if n}
    # Each stage sits directly under the job.
    for e in spans:
        if e.name != SPAN_PREFIX + "job":
            assert _spans_above(e) == ["job"], e.name
    # Every torch op inside the job lies inside exactly one stage.
    in_job = [e for e in events if e.name.startswith("aten::")
              and "job" in _spans_above(e)]
    assert in_job
    for e in in_job:
        above = _spans_above(e)
        assert len(above) == 2 and above[0] in STAGES, (e.name, above)


@pytest.mark.parametrize("app,eps", CASES)
def test_a_live_tracer_records_the_same_tree(app, eps):
    tracer = Tracer()
    with use_tracer(tracer):
        _job(app, eps)()
    (root,) = tracer.traces()
    assert root.name == "job"
    assert root.attrs == {"app": app, "shards": SHARDS,
                          "queries": 24 if app == "knn" else 16,
                          "eps_max": eps}
    names = [c.name for c in root.children]
    refined = ["map.select", "map.refine"] if eps > 0 else []
    task = ["map.lsh", "map.aggregate", "map.stage1"] + refined
    if app == "knn":
        assert names == task * SHARDS + ["reduce"]
    else:
        assert names == (task + ["reduce"]) * SHARDS + ["reduce"]
    assert all(not c.children for c in root.children)
    n_buckets = {c.attrs["n_buckets"] for c in root.find("map.aggregate")}
    assert n_buckets and all(n > 1 for n in n_buckets)
    for sel in root.find("map.select"):
        assert sel.attrs["refine_budget"] > 0
    assert trace_lib.validate_trace_jsonl(tracer.to_jsonl()) == []


def test_a_live_tracer_is_mirrored_into_the_profiler():
    tracer = Tracer()
    with use_tracer(tracer):
        _, events = _profiled(_job("knn", 0.05))
    spans = [e.name for e in events if e.name.startswith(SPAN_PREFIX)]
    (root,) = tracer.traces()
    assert sorted(spans) == sorted(SPAN_PREFIX + s.name
                                   for s in root.walk())


def test_with_neither_nothing_is_recorded():
    assert current_tracer() is NULL_TRACER
    assert current_tracer().span("x") is trace_lib._NULL_SPAN
    assert current_tracer().span("x", a=1).set(b=2) is trace_lib._NULL_SPAN
    _job("knn", 0.05)()
    assert NULL_TRACER.traces() == []
    # While the profiler records, the null tracer's spans reach it alone.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with NULL_TRACER.span("outer") as sp:
            assert sp is not trace_lib._NULL_SPAN and sp.set(a=1) is sp
            torch.ones(2).add_(1)
    assert NULL_TRACER.traces() == []
    (outer,) = [e for e in prof.events() if e.name == "span:outer"]
    assert any(e.cpu_parent is outer for e in prof.events())


@pytest.mark.parametrize("app,eps", CASES)
def test_answers_are_the_same_with_and_without_tracing(app, eps):
    run = _job(app, eps)
    plain = run()
    with use_tracer(Tracer()):
        traced = run()
    profiled, _ = _profiled(run)
    assert plain.dtype == traced.dtype == profiled.dtype
    assert torch.equal(plain, traced) and torch.equal(plain, profiled)
