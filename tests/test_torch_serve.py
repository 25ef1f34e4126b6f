"""The port's serving stack (``repro_torch.serve``): the scenarios of
``tests/test_serve.py`` replayed on it, the front door's and the LM
servable's scenarios of ``tests/test_chaos.py`` and ``tests/test_decode.py``
that need no runtime, and parity with the JAX package: a reference
``Server`` and a port ``Server`` fed the same data, draws, cost model, clock
and traffic give the same grants, decisions, cache sources, shuffle bytes
and answers; ``LMServable`` gives the reference's tokens and logits.

Tolerances: kNN labels equal (the test checks that no row of the data lies
on a bucket border, so both packages build the same buckets); CF
predictions and bounds within 2e-4 (the reference's CF kernel tolerance);
LM logits within 2e-5 (its attention tolerance), tokens equal.
"""
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import assert_close, normal, rng, th
from repro.apps import cf as jcf
from repro.apps import knn as jknn
from repro.configs import get_config as jax_config
from repro.core import budget as jbudget
from repro.core import lsh as jlsh
from repro.models import init_params as jax_init_params
from repro.obs.trace import Tracer as JTracer
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import DeadlineController as JController
from repro.serve import Server as JServer
from repro.serve.lm import DecodeEngine as JaxDecodeEngine
from repro.serve.lm import LMServable as JLMServable
from repro_torch.apps.cf import CFServable
from repro_torch.apps.knn import KNNServable, accurateml_map, majority_vote
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_lsh_from_numpy, lm_params_from_numpy
from repro_torch.core import engine as engine_lib
from repro_torch.core.budget import BudgetPolicy, CostModel
from repro_torch.core.refine import eps_to_budget
from repro_torch.models import model as model_lib
from repro_torch.obs.trace import Tracer
from repro_torch.serve import (
    AggregateCache, ContinuousBatcher, DeadlineController, FrontDoor,
    LoadShedLadder, Overloaded, Request, Response, Server, TenantSpec,
)
from repro_torch.serve import server as server_mod
from repro_torch.serve.demo import build_demo_server, prepare_demo_server
from repro_torch.serve.lm import DecodeEngine, LMServable, lm_pad_sizes
from repro_torch.serve.metrics import percentile
from repro_torch.serve.scheduler import pad_size, slo_class
from repro_torch.store import AggregateStore

CF_TOL = 2e-4
LM_TOL = 2e-5
jx = jnp.asarray

# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

N_KNN, D_KNN, N_CLASSES = 256, 8, 5
N_CF, I_CF = 96, 24


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _knn(x, y, seed=7, **kw):
    return KNNServable(x, y, n_classes=N_CLASSES, k=3,
                       lsh_generator=_gen(seed), device="cpu", **kw)


def _cf(r, m, seed=8, **kw):
    return CFServable(r, m, lsh_generator=_gen(seed), device="cpu", **kw)


@pytest.fixture(scope="module")
def knn_servable():
    r = rng(0)
    x = normal(r, N_KNN, D_KNN)
    y = r.integers(0, N_CLASSES, N_KNN).astype(np.int32)
    return _knn(x, y)


@pytest.fixture(scope="module")
def cf_servable():
    r = rng(2)
    ratings = (r.random((N_CF, I_CF)) * 4 + 1).astype(np.float32)
    m = (r.random((N_CF, I_CF)) < 0.3).astype(np.float32)
    return _cf(ratings * m, m)


def _controller(floor=0.004, eps_max=0.32, n_points=N_KNN):
    """Deterministic controller: 1 second of budget buys 1.0 of eps (before
    the 0.9 safety factor), stage 1 is free."""
    policy = BudgetPolicy(
        compression_ratio=20.0, eps_max=eps_max, degrade_floor=floor
    )
    ctl = DeadlineController(policy, ema=0.0)
    ctl.set_model(
        "knn", CostModel(c_fixed=0.0, c_stage1=0.0, c_stage2=1.0 / n_points)
    )
    return ctl


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _req(kind, deadline, arrival=0.0, reexec=False):
    return Request(kind=kind, payload=(), deadline_s=deadline,
                   arrival_t=arrival, reexecution=reexec)


def test_pad_size_quantization():
    assert pad_size(1) == 1
    assert pad_size(3) == 4
    assert pad_size(9) == 16
    assert pad_size(1000) == 64


def test_batches_are_kind_homogeneous_and_edf():
    b = ContinuousBatcher(max_batch=8, slo_aware=False)
    for kind, dl in [
        ("knn", 5.0), ("cf", 4.0), ("knn", 1.0), ("cf", 2.0), ("knn", 3.0),
    ]:
        b.submit(_req(kind, dl))
    first = b.next_batch(now=0.0)
    assert first.kind == "knn"
    assert [r.deadline_s for r in first.requests] == [1.0, 3.0, 5.0]
    second = b.next_batch(now=0.0)
    assert second.kind == "cf"
    assert [r.deadline_s for r in second.requests] == [2.0, 4.0]
    assert b.next_batch(now=0.0) is None


def test_packing_respects_max_batch_and_pad():
    b = ContinuousBatcher(max_batch=3, slo_aware=False)
    for _ in range(5):
        b.submit(_req("knn", 1.0))
    batch = b.next_batch(now=0.0)
    assert batch.n == 3
    assert batch.padded_size == 4
    assert len(b) == 2


def test_slo_classes_do_not_mix():
    b = ContinuousBatcher(max_batch=8)
    b.submit(_req("knn", 0.010))
    b.submit(_req("knn", 1.0))
    b.submit(_req("knn", 0.012))
    urgent = b.next_batch(now=0.0)
    assert [r.deadline_s for r in urgent.requests] == [0.010, 0.012]
    relaxed = b.next_batch(now=0.0)
    assert [r.deadline_s for r in relaxed.requests] == [1.0]
    assert slo_class(0.010) != slo_class(1.0)


def test_reexecution_never_mixes_with_granted_traffic():
    b = ContinuousBatcher(max_batch=8, slo_aware=False)
    b.submit(_req("knn", 1.0))
    b.submit(_req("knn", 1.0, reexec=True))
    b.submit(_req("knn", 1.1))
    first = b.next_batch(now=0.0)
    assert all(not r.reexecution for r in first.requests)
    assert first.n == 2
    second = b.next_batch(now=0.0)
    assert second.n == 1 and second.requests[0].reexecution


# ---------------------------------------------------------------------------
# aggregate cache
# ---------------------------------------------------------------------------

def _fresh_knn(knn_servable, seed=7, **kw):
    return _knn(knn_servable.train_x, knn_servable.train_y, seed=seed, **kw)


def test_cache_hit_miss_and_reuse(knn_servable):
    cache = AggregateCache(capacity=4)
    a1, hit1 = cache.get_or_build(knn_servable, 20.0)
    a2, hit2 = cache.get_or_build(knn_servable, 20.0)
    assert not hit1 and hit2
    assert a1 is a2
    _, hit3 = cache.get_or_build(knn_servable, 8.0)
    assert not hit3
    s = cache.stats()
    assert s["hits"] == 1 and s["misses"] == 2
    assert 0 < s["hit_rate"] < 1


def test_cache_key_is_permutation_sensitive(knn_servable):
    perm = torch.arange(N_KNN - 1, -1, -1)
    shuffled = _knn(knn_servable.train_x[perm], knn_servable.train_y[perm])
    assert shuffled.cache_key(20.0) != knn_servable.cache_key(20.0)


def test_cache_key_includes_lsh_key(knn_servable):
    other = _fresh_knn(knn_servable, seed=99)
    assert other.cache_key(20.0) != knn_servable.cache_key(20.0)


def test_cache_keys_differ_across_servables(knn_servable, cf_servable):
    assert (("knn", knn_servable.cache_key(20.0))
            != ("cf", cf_servable.cache_key(20.0)))


def test_cache_lru_eviction_and_invalidate(knn_servable):
    cache = AggregateCache(capacity=2)
    cache.get_or_build(knn_servable, 32.0)
    cache.get_or_build(knn_servable, 16.0)
    cache.get_or_build(knn_servable, 64.0)
    assert cache.evictions == 1 and len(cache) == 2
    _, hit = cache.get_or_build(knn_servable, 32.0)
    assert not hit
    assert cache.invalidate(knn_servable) == 2
    assert len(cache) == 0


def test_cache_eviction_order_is_lru_not_fifo(knn_servable):
    cache = AggregateCache(capacity=2)
    cache.get_or_build(knn_servable, 32.0)
    cache.get_or_build(knn_servable, 16.0)
    _, hit = cache.get_or_build(knn_servable, 32.0)
    assert hit
    cache.get_or_build(knn_servable, 64.0)
    _, hit32 = cache.get_or_build(knn_servable, 32.0)
    assert hit32
    _, hit16 = cache.get_or_build(knn_servable, 16.0)
    assert not hit16
    assert cache.evictions == 2


def test_cache_key_quantizes_ratio_drift(knn_servable):
    assert knn_servable.cache_key(20.0) == knn_servable.cache_key(20.0 + 1e-7)
    r_q = knn_servable.quantized_ratio(20.0)
    assert knn_servable.cache_key(20.0) == knn_servable.cache_key(r_q)
    cache = AggregateCache()
    cache.get_or_build(knn_servable, 20.0)
    _, hit = cache.get_or_build(knn_servable, 20.0 * (1 + 1e-9))
    assert hit


def test_cache_miss_coarsens_instead_of_rebuilding(knn_servable):
    servable = _fresh_knn(knn_servable)
    cache = AggregateCache()
    fine, hit = cache.get_or_build(servable, 8.0)
    assert not hit and cache.coarsened_hits == 0
    coarse, hit = cache.get_or_build(servable, 32.0)
    assert not hit and cache.coarsened_hits == 1
    assert servable.store.builds == 1 and servable.store.merges == 1
    f = coarse.agg.n_buckets
    assert fine.agg.n_buckets % f == 0
    factor = fine.agg.n_buckets // f
    merged_counts = fine.agg.counts.reshape(f, factor).sum(1)
    assert torch.equal(coarse.agg.counts, merged_counts.to(
        coarse.agg.counts.dtype))


def test_cache_invalidate_after_shard_update(knn_servable):
    servable = _fresh_knn(knn_servable)
    cache = AggregateCache()
    cache.get_or_build(servable, 20.0)
    assert servable.store.stats()["pyramids"] == 1
    assert cache.invalidate(servable) == 1
    assert servable.store.stats()["pyramids"] == 0
    builds_before = servable.store.builds
    _, hit = cache.get_or_build(servable, 20.0)
    assert not hit
    assert servable.store.builds == builds_before + 1


# ---------------------------------------------------------------------------
# deadline controller
# ---------------------------------------------------------------------------

def test_grant_degrades_eps_with_deadline():
    ctl = _controller()
    g_relaxed = ctl.grant("knn", N_KNN, 10.0)
    g_mid = ctl.grant("knn", N_KNN, 0.1)
    g_tight = ctl.grant("knn", N_KNN, 0.01)
    assert g_relaxed.eps == ctl.policy.eps_max
    assert 0.0 < g_mid.eps < g_relaxed.eps
    assert g_tight.eps <= g_mid.eps
    assert g_relaxed.refine_budget == eps_to_budget(N_KNN, g_relaxed.eps)


def test_grant_escalates_below_floor():
    ctl = _controller(floor=0.01)
    g = ctl.grant("knn", N_KNN, 0.001)
    assert g.escalate and g.eps == 0.0 and g.refine_budget == 0
    g2 = ctl.grant("knn", N_KNN, -1.0)
    assert g2.escalate


def test_grant_escalates_when_snap_lands_below_floor():
    ctl = _controller(floor=0.004)
    g = ctl.grant("knn", N_KNN, 0.005)
    assert g.eps == 0.0 and g.refine_budget == 0
    assert g.escalate


def test_grant_snaps_to_grid():
    ctl = _controller()
    g = ctl.grant("knn", N_KNN, 0.1)
    assert g.eps in ctl.eps_grid
    assert g.eps <= 0.09
    assert ctl.snap_eps(0.009) == 0.005
    assert ctl.snap_eps(1e-9) == 0.0


def test_uncalibrated_kind_gets_full_eps():
    ctl = DeadlineController(BudgetPolicy(eps_max=0.1), ema=0.0)
    g = ctl.grant("unknown", 1000, 0.5)
    assert g.eps == 0.1 and not g.escalate


def test_deadline_for_inverts_grant():
    ctl = _controller()
    for eps in (0.01, 0.08, ctl.policy.eps_max):
        d = ctl.deadline_for("knn", N_KNN, eps)
        g = ctl.grant("knn", N_KNN, d * 1.001)
        assert g.eps >= ctl.snap_eps(eps) - 1e-12, (eps, g.eps)


def test_observe_correction_is_clamped():
    ctl = _controller()
    ctl.ema = 0.5
    ctl.observe("knn", predicted_s=0.01, observed_s=10.0)
    assert ctl.correction("knn") <= 1.0 + 0.5 * 3.0


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_percentile():
    xs = [float(i) for i in range(1, 101)]
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile(xs, 99) == pytest.approx(99.01)
    assert percentile([7.0], 99) == 7.0
    assert math.isnan(percentile([], 50))


def test_metrics_slo_class_boundaries():
    from repro_torch.serve.metrics import slo_class as metrics_slo_class

    assert metrics_slo_class(0.0099) == "lt10ms"
    assert metrics_slo_class(0.01) == "lt100ms"
    assert metrics_slo_class(0.0999) == "lt100ms"
    assert metrics_slo_class(0.1) == "lt1s"
    assert metrics_slo_class(0.9999) == "lt1s"
    assert metrics_slo_class(1.0) == "ge1s"


def test_identity_combine_reports_zero_shuffle():
    eng = engine_lib.MapReduce(mesh=None)
    x = torch.ones((16, 4))
    eng.run(lambda a: a * 2, engine_lib.CombineSpec(mode="identity"), x)
    assert eng.last_shuffle_bytes == 0
    eng.run(lambda a: a * 2, engine_lib.CombineSpec(mode="psum"), x)
    assert eng.last_shuffle_bytes == 16 * 4 * 4


# ---------------------------------------------------------------------------
# server end-to-end
# ---------------------------------------------------------------------------

def _server(knn_servable, **ctl_kw):
    return Server(
        [knn_servable],
        controller=_controller(**ctl_kw),
        batcher=ContinuousBatcher(max_batch=4, pad_sizes=(4,)),
    )


def test_server_deadline_degradation_end_to_end(knn_servable):
    server = _server(knn_servable)
    q = knn_servable.train_x[:1]
    relaxed = server.submit("knn", (q[0],), deadline_s=10.0)
    r_relaxed = server.drain()
    tight = server.submit("knn", (q[0],), deadline_s=0.05)
    r_tight = server.drain()
    (relaxed_resp,) = [r for r in r_relaxed if r.rid == relaxed]
    (tight_resp,) = [r for r in r_tight if r.rid == tight]
    assert relaxed_resp.eps_granted == server.controller.policy.eps_max
    assert relaxed_resp.refined is not None
    assert tight_resp.eps_granted < relaxed_resp.eps_granted
    assert tight_resp.stage1 is not None
    assert 0 <= tight_resp.stage1 < N_CLASSES


def test_server_escalation_reexecutes(knn_servable):
    server = _server(knn_servable, floor=0.01)
    rid = server.submit("knn", (knn_servable.train_x[0],), deadline_s=1e-4)
    responses = server.drain()
    by_path = {r.reexecuted: r for r in responses}
    first, reexec = by_path[False], by_path[True]
    assert first.rid == rid and reexec.rid == rid
    assert first.escalated and first.refined is None
    assert reexec.refined is not None
    assert reexec.eps_granted == server.controller.policy.eps_max
    s = server.summary()
    assert s["n_requests"] == 1 and s["n_reexecutions"] == 1


def test_server_answers_match_direct_computation(knn_servable):
    server = _server(knn_servable)
    queries = knn_servable.train_x[10:14]
    rids = [server.submit("knn", (q,), deadline_s=10.0) for q in queries]
    responses = {r.rid: r for r in server.drain()}
    r = server.controller.policy.compression_ratio
    eps = server.controller.policy.eps_max
    agg = knn_servable.build(r)
    d, lab = accurateml_map(
        knn_servable.train_x, knn_servable.train_y, agg, queries,
        k=knn_servable.k, refine_budget=eps_to_budget(N_KNN, eps),
    )
    expected = majority_vote(d, lab, N_CLASSES).tolist()
    for i, rid in enumerate(rids):
        assert responses[rid].eps_granted == eps
        assert responses[rid].refined == int(expected[i])


def test_server_cache_and_metrics(knn_servable):
    server = _server(_fresh_knn(knn_servable))
    servable = server.servables["knn"]
    for _ in range(2):
        for i in range(3):
            server.submit("knn", (servable.train_x[i],), deadline_s=10.0)
        server.drain()
    summary = server.summary()
    assert summary["n_requests"] == 6
    assert summary["n_batches"] == 2
    assert summary["cache"] == {
        "hits": 1, "misses": 1, "hit_rate": 0.5, "size": 1, "evictions": 0,
        "coarsened_hits": 0, "restored_hits": 0, "coarsened_hit_rate": 0.0,
    }
    assert summary["shuffle_bytes_total"] > 0
    assert summary["eps_granted"]["max"] == server.controller.policy.eps_max
    assert 0.0 <= summary["deadline_met_rate"] <= 1.0
    assert summary["stage1_latency_ms"]["p99"] >= \
        summary["stage1_latency_ms"]["p50"]
    assert summary["mean_batch_occupancy"] == 3.0


def test_server_snapshot_then_warm_start(knn_servable, tmp_path):
    server_a = _server(_fresh_knn(knn_servable))
    server_a.submit("knn", (knn_servable.train_x[0],), deadline_s=10.0)
    first_a = server_a.drain()[0]
    assert server_a.save_aggregates(tmp_path / "agg") == 1

    fresh = _fresh_knn(knn_servable)
    server_b = _server(fresh)
    assert server_b.warm_start(tmp_path / "agg") == {
        "restored": 1, "warmed": 1,
    }
    assert fresh.store.restores >= 1
    server_b.submit("knn", (knn_servable.train_x[0],), deadline_s=10.0)
    (resp,) = [r for r in server_b.drain() if not r.reexecuted]
    assert resp.cache_hit
    assert (resp.stage1, resp.refined) == (first_a.stage1, first_a.refined)
    summary = server_b.summary()
    assert summary["cache"]["hits"] >= 1
    assert summary["cache"]["restored_hits"] == 1

    other = _fresh_knn(knn_servable, seed=321)
    server_c = _server(other)
    out = server_c.warm_start(tmp_path / "agg")
    assert out["restored"] == 0 and out["warmed"] == 1


def test_server_warm_start_across_store_topologies(
    knn_servable, cf_servable, tmp_path
):
    ctl = _controller()
    ctl.set_model(
        "cf", CostModel(c_fixed=0.0, c_stage1=0.0, c_stage2=1.0 / N_CF)
    )

    def knn_of(store):
        return _fresh_knn(knn_servable, store=store)

    def cf_of(store):
        return _cf(cf_servable.ratings, cf_servable.mask, store=store)

    saver = Server([knn_of(None), cf_of(None)], controller=ctl,
                   batcher=ContinuousBatcher(max_batch=4, pad_sizes=(4,)))
    for s in saver.servables.values():
        s.build(ctl.policy.compression_ratio)
    assert saver.save_aggregates(tmp_path / "agg") == 2

    shared = AggregateStore()
    restorer = Server([knn_of(shared), cf_of(shared)], controller=ctl,
                      batcher=ContinuousBatcher(max_batch=4, pad_sizes=(4,)))
    assert restorer.warm_start(tmp_path / "agg") == {
        "restored": 2, "warmed": 2,
    }
    assert shared.restores == 2
    assert restorer.save_aggregates(tmp_path / "agg2") == 2
    private = Server([knn_of(None), cf_of(None)], controller=ctl,
                     batcher=ContinuousBatcher(max_batch=4, pad_sizes=(4,)))
    assert private.warm_start(tmp_path / "agg2") == {
        "restored": 2, "warmed": 2,
    }


def test_server_heterogeneous_kinds(knn_servable, cf_servable):
    ctl = _controller()
    ctl.set_model(
        "cf", CostModel(c_fixed=0.0, c_stage1=0.0, c_stage2=1.0 / N_CF)
    )
    server = Server(
        [knn_servable, cf_servable],
        controller=ctl,
        batcher=ContinuousBatcher(max_batch=4, pad_sizes=(4,)),
    )
    server.submit("knn", (knn_servable.train_x[0],), deadline_s=10.0)
    server.submit(
        "cf", (cf_servable.ratings[0], cf_servable.mask[0]), deadline_s=10.0
    )
    responses = server.drain()
    kinds = {r.kind for r in responses}
    assert kinds == {"knn", "cf"}
    cf_resp = next(r for r in responses if r.kind == "cf")
    assert cf_resp.answer.shape == (I_CF,)
    with pytest.raises(KeyError):
        server.submit("nope", (), deadline_s=1.0)


def test_calibrate_times_finished_runs(knn_servable, monkeypatch):
    """``calibrate`` waits for every timed run's tensors before reading the
    clock: each timed run is followed by one synchronise per device of its
    output (here the CPU has none, so a fake CUDA tensor stands in)."""
    from repro_torch import device

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))

    class FakeCuda:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(device, "tensors", lambda out: iter([FakeCuda()]))
    server = _server(_fresh_knn(knn_servable))
    server.calibrate("knn", batch=4)
    # two probes, each a warm-up and CALIBRATE_RUNS timed runs; the host
    # term (spans, grant, cache lookup, accuracy proxy) waits for nothing
    assert synced == [torch.device("cuda", 1)] * (
        2 * (1 + server_mod.CALIBRATE_RUNS))
    model = server.controller.models["knn"]
    assert model.c_stage1 >= 0 and model.c_fixed > 0.0


@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_calibrate_probes_a_full_batch_of_real_rows(knn_servable,
                                                    cf_servable, kind):
    """Every row of ``calibrate``'s probe batch is the probe payload, none
    zero padding (the CF kernels skip unrated entries, so a zero row would
    cost nothing), at the pad size asked for; each pass is unpacked, as a
    served pass is, inside its timing."""
    fresh = (_fresh_knn(knn_servable) if kind == "knn" else
             _cf(cf_servable.ratings, cf_servable.mask))
    seen, run, unpack = [], fresh.run, fresh.unpack

    def recording(prepared, batch, *, refine_budget):
        seen.append(batch)
        return run(prepared, batch, refine_budget=refine_budget)

    def unpacking(outputs, n):
        seen.append(n)
        return unpack(outputs, n)

    fresh.run, fresh.unpack = recording, unpacking
    Server([fresh], controller=_controller()).calibrate(kind, batch=4)
    want = fresh.probe_payload()
    runs = 2 * (1 + server_mod.CALIBRATE_RUNS)     # two probes
    assert seen[1::2] == [4] * runs        # every run followed by its unpack
    seen = seen[::2]
    assert len(seen) == runs
    for batch in seen:
        for col, w in zip(batch, want):
            assert col.shape[0] == 4
            assert all(torch.equal(row, torch.as_tensor(w)) for row in col)


@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_calibrate_holds_every_pass_answers_until_the_fit(
        knn_servable, cf_servable, kind, monkeypatch):
    """Each of ``calibrate``'s passes keeps its unpacked answers until the
    fit, as a served batch's responses keep theirs, so that no pass copies
    its answers into memory the pass before it has just freed; they are
    let go once the model is fitted."""
    import gc
    import weakref

    fresh = (_fresh_knn(knn_servable) if kind == "knn" else
             _cf(cf_servable.ratings, cf_servable.mask))
    unpack, answers = fresh.unpack, []

    class Answers(list):
        pass

    def unpacking(outputs, n):
        got = Answers(unpack(outputs, n))
        answers.append(weakref.ref(got))
        return got

    fresh.unpack = unpacking
    server = Server([fresh], controller=_controller())
    alive_at_fit = []
    fit = server.controller.fit_from_probes

    def fitting(*args, **kwargs):
        gc.collect()
        alive_at_fit.append([a() is not None for a in answers])
        return fit(*args, **kwargs)

    monkeypatch.setattr(server.controller, "fit_from_probes", fitting)
    server.calibrate(kind, batch=4)
    assert alive_at_fit == [[True] * 2 * (1 + server_mod.CALIBRATE_RUNS)]
    gc.collect()
    assert all(a() is None for a in answers)


def test_knn_accuracy_proxy_is_the_reference_label_overlap(knn_servable):
    """kNN's accuracy proxy, counted on the outputs' device, equals the JAX
    package's label-multiset overlap per query, padding slots (distance at
    BIG) on neither side."""
    from types import SimpleNamespace

    from repro_torch.kernels.topk_stream import BIG

    r = rng(6)
    outs = []
    for _ in range(2):
        d = normal(r, 8, 3)
        d[r.random((8, 3)) < 0.25] = BIG
        labels = r.integers(0, N_CLASSES, (8, 3)).astype(np.int32)
        outs.append((d, labels))
    got = knn_servable.accuracy_proxy(*((th(d), th(lab)) for d, lab in outs),
                                      6)
    want = jknn.KNNServable.accuracy_proxy(SimpleNamespace(k=3), *outs, 6)
    assert got == want and len(set(got)) > 1


def test_cf_accuracy_proxy_is_the_reference_mean_absolute_delta(
        cf_servable):
    """CF's accuracy proxy, computed on the predictions' device, equals the
    JAX package's numpy mean absolute delta per user, in float64."""
    r = rng(5)
    s1 = th(normal(r, 6, I_CF))
    s2 = th(normal(r, 6, I_CF))
    got = cf_servable.accuracy_proxy((s1,), (s2,), 4)
    want = jcf.CFServable.accuracy_proxy(None, (s1.numpy(),), (s2.numpy(),),
                                         4)
    assert got == want


# ---------------------------------------------------------------------------
# front door (the test_chaos.py scenarios, on a plain kNN servable)
# ---------------------------------------------------------------------------

def _front_door(knn_servable, **kwargs):
    server = Server([_fresh_knn(knn_servable)], controller=_controller())
    return FrontDoor(server, default_deadline_s=5.0, **kwargs), server


def _query(knn_servable, i):
    return (knn_servable.train_x[i],)


def test_quota_rejected_submits_never_enter_the_batcher(knn_servable):
    fd, server = _front_door(
        knn_servable, tenants=[TenantSpec("metered", rate=0.0, burst=2.0)],
        queue_limit=16,
    )
    r1 = fd.submit("knn", _query(knn_servable, 0), tenant="metered")
    r2 = fd.submit("knn", _query(knn_servable, 1), tenant="metered")
    r3 = fd.submit("knn", _query(knn_servable, 2), tenant="metered")
    assert len(server.batcher) == 0
    assert fd.backlog() == 2
    refusal = fd.result(r3)
    assert isinstance(refusal, Overloaded)
    assert refusal.reason == "quota" and refusal.tenant == "metered"
    assert refusal.answer is None
    fd.pump(max_batches=10)
    assert isinstance(fd.result(r1), Response)
    assert isinstance(fd.result(r2), Response)
    assert isinstance(fd.result(r3), Overloaded)
    assert fd.stats()["admitted"] == 2
    assert fd.stats()["rejected"]["quota"] == 1


def test_load_shed_ladder_steps_down_before_first_rejection(knn_servable):
    fd, server = _front_door(knn_servable, queue_limit=4)
    base_eps = server.controller.policy.eps_max
    rids = [fd.submit("knn", _query(knn_servable, i)) for i in range(24)]
    stats = fd.stats()
    assert stats["rejected"]["overload"] > 0
    assert stats["shed_before_reject"]
    assert stats["first_shed_t"] < stats["first_reject_t"]
    downs = [t for t in stats["shed_transitions"] if t["to"] > t["from"]]
    assert [t["to"] for t in downs[:3]] == [1, 2, 3]
    assert all(t["t"] <= stats["first_reject_t"] for t in downs[:3])
    assert server.controller.policy.eps_max == pytest.approx(
        base_eps * fd.ladder.factor
    )
    while fd.backlog():
        fd.pump(max_batches=4)
    results = [fd.result(rid) for rid in rids]
    assert all(r is not None for r in results)
    assert {type(r) for r in results} == {Response, Overloaded}
    refused = [r for r in results if isinstance(r, Overloaded)]
    assert all(r.reason == "overload" and r.retry_after_s > 0
               for r in refused)
    assert all(r.shed_level == fd.ladder.max_level for r in refused)
    for _ in range(10):
        fd.pump()
    assert fd.ladder.level == 0
    assert server.controller.policy.eps_max == pytest.approx(base_eps)


def test_ladder_hysteresis_band():
    ladder = LoadShedLadder(fire=0.7, clear=0.25)
    assert ladder.evaluate(0.9, now=0.0) and ladder.level == 1
    assert not ladder.evaluate(0.5, now=1.0)
    assert ladder.level == 1
    assert ladder.evaluate(0.1, now=2.0) and ladder.level == 0
    with pytest.raises(ValueError):
        LoadShedLadder(fire=0.3, clear=0.5)


def test_front_door_thread_mode_answers_all(knn_servable):
    fd, _ = _front_door(knn_servable, queue_limit=32, poll_s=0.001)
    fd.start()
    try:
        rids = [fd.submit("knn", _query(knn_servable, i)) for i in range(6)]
        results = [fd.wait(rid, timeout_s=60.0) for rid in rids]
        workers = [t for t in threading.enumerate()
                   if t is not threading.main_thread() and t.is_alive()]
        assert workers
    finally:
        fd.stop()
    assert all(isinstance(r, Response) for r in results)
    with pytest.raises(KeyError):
        fd.wait(10**9)


# ---------------------------------------------------------------------------
# the demo fixture
# ---------------------------------------------------------------------------

def test_demo_server_serves_every_slo_class():
    server, queries, active, active_mask = build_demo_server(
        knn_points=2048, cf_users=256, batch=4, device="cpu")
    slos = prepare_demo_server(server, batch=4)
    assert set(slos) == {"knn", "cf"}
    for kind, classes in slos.items():
        assert classes["hopeless"] < classes["tight"] < classes["relaxed"]
    assert server.summary()["n_requests"] == 0
    for i in range(4):
        server.submit("knn", (queries[i],), slos["knn"]["relaxed"])
        server.submit("cf", (active[i], active_mask[i]), slos["cf"]["relaxed"])
    responses = server.drain()
    assert {r.kind for r in responses} == {"knn", "cf"}
    assert all(r.stage1 is not None for r in responses)
    assert server.cache.stats()["misses"] == 0   # prewarm built everything


# ---------------------------------------------------------------------------
# parity with the JAX package: two servers, the same traffic
# ---------------------------------------------------------------------------

class _StepClock:
    """A clock that moves 1 ms a read: both servers read it in the same
    order, so they see the same times."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _draws(seed, n_features, width):
    cfg = jlsh.LSHConfig(n_hashes=4, bucket_width=width)
    p = jlsh.init_lsh(jax.random.PRNGKey(seed), n_features, cfg)
    return np.asarray(p.a), np.asarray(p.b)


def _server_pair(kind):
    """(reference server, port server, requests) over the same data, draws
    and cost model, ema 0 and a step clock each."""
    r = rng(31 if kind == "knn" else 32)
    if kind == "knn":
        x = normal(r, 600, D_KNN)
        y = r.integers(0, N_CLASSES, 600).astype(np.int32)
        js = jknn.KNNServable(jx(x), jx(y), n_classes=N_CLASSES, k=3,
                              lsh_key=jax.random.PRNGKey(7))
        ts = KNNServable(x, y, n_classes=N_CLASSES, k=3,
                         lsh_params=_draws(7, D_KNN, 4.0), device="cpu")
        queries = [(q,) for q in normal(r, 24, D_KNN)]
        loose, n = 1.0, 600
    else:
        ratings = (r.random((300, 30)) * 4 + 1).astype(np.float32)
        m = (r.random((300, 30)) < 0.3).astype(np.float32)
        js = jcf.CFServable(jx(ratings * m), jx(m),
                            lsh_key=jax.random.PRNGKey(5))
        ts = CFServable(ratings * m, m, lsh_params=_draws(5, 30, 8.0),
                        device="cpu")
        qa = (r.random((24, 30)) * 4 + 1).astype(np.float32)
        qm = (r.random((24, 30)) < 0.3).astype(np.float32)
        queries = list(zip(qa * qm, qm))
        loose, n = 100.0, 300
    base = js.pyramid_spec.base_buckets
    # No row on a bucket border: both packages build the same buckets.
    np.testing.assert_array_equal(
        np.asarray(ts.fine_ids(base)), np.asarray(js.fine_ids(base)))

    model = dict(c_fixed=1e-3, c_stage1=2e-5, c_stage2=0.5 / n)
    policy = dict(compression_ratio=20.0, eps_max=0.32, degrade_floor=0.01)
    jctl = JController(jbudget.BudgetPolicy(**policy), ema=0.0)
    jctl.set_model(kind, jbudget.CostModel(**model))
    tctl = DeadlineController(BudgetPolicy(**policy), ema=0.0)
    tctl.set_model(kind, CostModel(**model))
    jserver = JServer([js], controller=jctl, clock=_StepClock(),
                      batcher=JBatcher(max_batch=4, pad_sizes=(1, 2, 4)),
                      tracer=JTracer())
    tserver = Server([ts], controller=tctl, clock=_StepClock(),
                     batcher=ContinuousBatcher(max_batch=4,
                                               pad_sizes=(1, 2, 4)),
                     tracer=Tracer())
    # relaxed, tight, hopeless (escalates), a loose max_error (skips stage
    # 2) and one never met (asks for a boost), each in an SLO class of its
    # own, in waves of 4
    deadlines = [10.0, 0.2, 0.06, 0.012, 3.0, 0.7]
    max_errors = [None, None, None, None, loose, -1.0]
    reqs = [(queries[i], deadlines[i % 6], max_errors[i % 6])
            for i in range(len(queries))]
    return jserver, tserver, reqs


def _decisions(server):
    """Per served batch: the grant, the cache lookup, the accuracy-SLO
    decisions and the shuffle bytes, from the batch's span tree."""
    out = []
    for root in server.tracer.traces():
        grant = root.find("deadline.grant")[0].attrs
        lookup = root.find("cache.lookup")[0].attrs
        refine = root.find("stage2.refine")
        out.append({
            **{k: root.attrs[k] for k in ("kind", "n", "padded",
                                          "reexecution", "eps",
                                          "shuffle_bytes", "refined",
                                          "refine_skipped", "boosted")},
            "grant": dict(grant), "cache": dict(lookup),
            "stage1_bytes": root.find("stage1")[0].attrs["shuffle_bytes"],
            "refine_budget": refine[0].attrs["refine_budget"]
            if refine else 0,
        })
    return out


@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_servers_give_the_reference_grants_and_answers(kind):
    jserver, tserver, reqs = _server_pair(kind)
    jresps, tresps = [], []
    for lo in range(0, len(reqs), 4):
        for (payload, dl, me) in reqs[lo:lo + 4]:
            jserver.submit(kind, tuple(jx(p) for p in payload), dl,
                           max_error=me)
            tserver.submit(kind, tuple(th(p) for p in payload), dl,
                           max_error=me)
        jresps += jserver.drain()
        tresps += tserver.drain()
    got, want = _decisions(tserver), _decisions(jserver)
    assert got == want
    # the traffic reached every path that a decision can take
    assert {d["cache"]["source"] for d in got} == {"built", "hit"}
    assert any(d["grant"]["escalate"] for d in got)
    assert any(d["reexecution"] for d in got)
    assert any(d["refine_skipped"] for d in got)
    assert any(d["refined"] and not d["refine_skipped"] for d in got)
    assert len(tresps) == len(jresps)
    # rids come from each package's own counter: compare them relatively
    t0, j0 = min(r.rid for r in tresps), min(r.rid for r in jresps)
    assert [r.rid - t0 for r in tresps] == [r.rid - j0 for r in jresps]
    for t, j in zip(tresps, jresps):
        for field in ("kind", "eps_granted", "compression_ratio",
                      "deadline_s", "queue_wait_s", "stage1_latency_s",
                      "total_latency_s", "deadline_met", "escalated",
                      "reexecuted", "cache_hit", "batch_size",
                      "partial_shards", "accuracy_met", "refine_skipped"):
            assert getattr(t, field) == getattr(j, field), field
        if kind == "knn":
            assert t.stage1 == j.stage1
            assert t.refined == j.refined
        else:
            assert_close(t.stage1, np.asarray(j.stage1), rtol=CF_TOL,
                         atol=CF_TOL)
            assert (t.refined is None) == (j.refined is None)
            if t.refined is not None:
                assert_close(t.refined, np.asarray(j.refined), rtol=CF_TOL,
                             atol=CF_TOL)
        assert t.error_bound.value == pytest.approx(
            j.error_bound.value, rel=CF_TOL, abs=CF_TOL)
        assert (t.accuracy_proxy is None) == (j.accuracy_proxy is None)
        if t.accuracy_proxy is not None:
            assert t.accuracy_proxy == pytest.approx(
                j.accuracy_proxy, rel=CF_TOL, abs=CF_TOL)
    gs, ws = tserver.summary(), jserver.summary()
    assert gs["cache"] == ws["cache"]
    assert gs["shuffle_bytes_total"] == ws["shuffle_bytes_total"]
    assert gs["eps_granted"] == ws["eps_granted"]


# ---------------------------------------------------------------------------
# LM servable
# ---------------------------------------------------------------------------

def _lm_pair(layout="flat", max_slots=2, s_max=16):
    jcfg = jax_config("qwen3-8b", smoke=True).with_(
        agg_kv=True, agg_layout=layout, agg_compression=4)
    tcfg = get_config("qwen3-8b", smoke=True).with_(
        agg_kv=True, agg_layout=layout, agg_compression=4)
    jp = jax_init_params(jax.random.PRNGKey(1), jcfg)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, device="cpu")
    jeng = JaxDecodeEngine(jp, jcfg, max_slots=max_slots, s_max=s_max,
                           key=jax.random.PRNGKey(7), n_shards=2)
    teng = DecodeEngine(
        model, tcfg, max_slots=max_slots, s_max=s_max, n_shards=2,
        lsh=lm_cache_lsh_from_numpy(
            jax.tree_util.tree_map(np.asarray, jeng.state), tcfg,
            device="cpu"))
    return jeng, teng


@pytest.fixture(scope="module")
def lm_pair():
    return _lm_pair()


@pytest.mark.parametrize("budget", ["stage1", "full"])
def test_lm_servable_gives_the_reference_tokens(lm_pair, budget):
    jeng, teng = lm_pair
    js = JLMServable(jeng, prompt_len=5, max_new_tokens=4)
    ts = LMServable(teng, prompt_len=5, max_new_tokens=4)
    assert ts.n_points == js.n_points == teng.n_buckets
    b = 0 if budget == "stage1" else ts.n_points
    prompts = [(p,) for p in rng(12).integers(
        0, teng.cfg.vocab_size, (2, 5)).astype(np.int32)]
    want = js.run(js.build(20.0), js.pad_batch(prompts, 2), refine_budget=b)
    got = ts.run(ts.build(20.0), ts.pad_batch(prompts, 2), refine_budget=b)
    assert isinstance(got["tokens"], np.ndarray)
    assert got["tokens"].dtype == np.int32 and got["tokens"].shape == (2, 4)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]),
                               rtol=LM_TOL, atol=LM_TOL)
    assert ts.last_shuffle_bytes == js.last_shuffle_bytes
    assert ts.accuracy_proxy(got, got, 2) == [0.0, 0.0]


def test_lm_pad_sizes():
    assert lm_pad_sizes(1) == (1,)
    assert lm_pad_sizes(2) == (1, 2)
    assert lm_pad_sizes(6) == (1, 2, 4)
    with pytest.raises(ValueError):
        lm_pad_sizes(0)


def _tiny_lm_server(max_new_tokens):
    cfg = get_config("qwen3-8b", smoke=True).with_(
        agg_kv=True, agg_layout="bucket_major", agg_compression=4)
    model = model_lib.init_params(cfg, _gen(1), device="cpu")
    eng = DecodeEngine(model, cfg, max_slots=2, s_max=16, generator=_gen(7),
                       n_shards=2)
    srv = LMServable(eng, prompt_len=4, max_new_tokens=max_new_tokens)
    server = Server(
        [srv], policy=BudgetPolicy(eps_max=1.0),
        batcher=ContinuousBatcher(max_batch=2,
                                  pad_sizes=lm_pad_sizes(eng.max_slots),
                                  slo_aware=False),
    )
    server.calibrate("lm")
    return eng, server


def test_lmservable_anytime_contract_through_server():
    eng, server = _tiny_lm_server(3)
    rid = server.submit(
        "lm", (np.asarray([1, 2, 3, 4], np.int32),), deadline_s=30.0
    )
    resps = server.drain()
    assert resps and all(r.rid == rid for r in resps)
    assert all(r.stage1 is not None for r in resps)
    final = resps[-1]
    assert final.refined is not None
    assert final.eps_granted > 0.0 or final.reexecuted
    s1, ref = final.stage1["tokens"], final.refined["tokens"]
    assert s1.shape == (3,) and ref.shape == (3,)
    assert s1[0] == ref[0]
    assert final.accuracy_proxy is not None
    assert final.partial_shards == ()

    eng.kill_shard(0)
    server.submit(
        "lm", (np.asarray([4, 3, 2, 1], np.int32),), deadline_s=30.0
    )
    resps2 = server.drain()
    assert resps2
    for r in resps2:
        assert r.partial_shards == (0,)
        assert r.stage1 is not None
        assert np.isfinite(r.stage1["logits"]).all()


def test_lm_frontdoor_shed_coarsens_refine_frac():
    _, server = _tiny_lm_server(2)
    door = FrontDoor(server, queue_limit=1, ladder=LoadShedLadder())
    base_eps = server.controller.policy.eps_max
    rids = [
        door.submit(
            "lm", (np.asarray([i, 2, 3, 4], np.int32),), deadline_s=30.0
        )
        for i in range(3)
    ]
    assert server.controller.policy.eps_max < base_eps
    for _ in range(8):
        door.pump(max_batches=2)
    answers = [door.result(r) for r in rids]
    assert all(a is not None for a in answers)
    got = [a for a in answers if isinstance(a, Response)]
    assert got and all(a.stage1 is not None for a in got)


# ---------------------------------------------------------------------------
# chip_smoke.py's serve phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

class _CountingPlain:
    """Stands in for a kernel's wrapper: counts its calls, runs the plain
    version."""

    def __init__(self, fn):
        self.fn, self.launches = fn, 0

    def __call__(self, *args, **kwargs):
        self.launches += 1
        return self.fn(*args, **kwargs)


class _HostEvent:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        import time
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_chip_smoke_serve_phase_runs_on_the_cpu(monkeypatch):
    """The card phase's code at a small size: every server, check and
    export of it but the one that needs the card's timings, with the
    kernels' wrappers replaced by counting plain versions and the card's
    clocks by the host's."""
    import sys
    from pathlib import Path

    from repro_torch.apps import cf, knn
    from repro_torch.data.synthetic import make_mfeat_like, make_netflix_like
    from repro_torch.kernels import ops, ref

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    plain = {
        "knn_distance": lambda q, p: ref.knn_distance(q, p),
        "distance_topk": lambda q, p, lab, v=None, *, k, metric="l2":
            ref.distance_topk(q, p, lab, v, k=k, metric=metric),
        "candidate_topk": lambda d, lab, i=None, j=None, *, k:
            ref.candidate_topk(d, lab, i, j, k=k),
        "refine_distances": lambda q, x, i, v, b=None, *, n_buckets=0:
            ref.refine_distances(q, x, i, v),
        "lsh_hash": ref.lsh_hash,
        "cf_weights": ref.cf_weights,
        "cf_refine": ref.cf_refine,
        "cf_aggregate": ref.cf_aggregate,
        "agg_refine_attention": ref.agg_refine_attention,
        "aggregated_attention_decode":
            lambda q, k, v, bo, mk, mv, c, r, vl, *, scale:
            ref.aggregated_attention_decode(q, k, v, bo, mk, mv, c, r,
                                            scale=scale, valid_len=vl),
    }
    wrappers = {name: _CountingPlain(fn) for name, fn in plain.items()}
    for name, w in wrappers.items():
        # the module attribute ``ops`` calls is the wrapper KERNELS holds
        attr = next(a for a, v in vars(ops).items()
                    if a.endswith("_cuda") and v is ops.KERNELS[name])
        monkeypatch.setitem(ops.KERNELS, name, w)
        monkeypatch.setattr(ops, attr, w)

    def bucket_ids(d, a, b, w, *, base, factor=1):
        wrappers["lsh_hash"].launches += 1
        return ref.lsh_bucket_ids(d, a, b, w, base=base, factor=factor)

    monkeypatch.setattr(ops, "lsh_bucket_ids_cuda", bucket_ids)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    x, y = make_mfeat_like(_gen(0), n_points=8192 + 1024, n_features=16,
                           n_classes=10, device="cpu")
    r, m = make_netflix_like(_gen(1), n_users=2048 + 256, n_items=200,
                             density=0.05, device="cpu")
    r = r * m
    cfg = get_config("qwen3-8b", smoke=True).with_(
        agg_kv=True, agg_compression=cs.LM_COMPRESSION)
    model = model_lib.init_params(cfg, _gen(0), device="cpu")
    probe = cs.CaptureProbe(torch)
    summary, counts = cs.serve_phase(
        torch, knn, cf, ops, probe, (x[1024:], y[1024:], x[:1024], y[:1024]),
        (r[256:], m[256:], r[:256], m[:256]), model, cfg,
        # the host's times of plain versions at this size are no card's:
        # whether the relaxed class keeps eps_max is checked on the card
        card_grants=False)
    cs.print_serve(summary)
    cs.check_launched("serve", counts, cs.SERVE_KERNELS)
    assert counts["agg_refine_attention"] == 0
    assert set(probe.calls) == {"distance_topk", "knn_distance",
                                "refine_distances", "candidate_topk",
                                "cf_weights", "cf_refine",
                                "aggregated_attention_decode"}
    # the LM server's relaxed wave: its selections at B 2 and its attention
    # at both passes (stage 1 and refined, each captured) are held too
    assert any(key[0].startswith("serve lm") and key[1][0] == 2
               for key in probe.calls["distance_topk"])
    assert sorted(key[0] for key in probe.calls["aggregated_attention_decode"]
                  if key[1][0] == 2) == ["serve lm budget 0",
                                         "serve lm budget 16"]
    assert summary["warm_start"]["cache"]["restored_hits"] == 1
    assert summary["front_door"]["rejected"]["quota"] >= 27
    assert summary["knn"]["classes"]["hopeless"]["escalated"] == 256


def test_batches_with_a_full_collection_stay_out_of_the_correction(
        knn_servable):
    """A warm batch feeds the load correction its observed time; one
    during which the garbage collector ran a full collection does not (its
    window holds the pause, not the serving cost)."""
    import gc

    fresh = _fresh_knn(knn_servable)
    server = _server(fresh)
    server.prewarm("knn", batch=4)
    observed, observe = [], server.controller.observe

    def observing(kind, predicted_s, observed_s):
        observed.append(kind)
        observe(kind, predicted_s, observed_s)

    server.controller.observe = observing
    q = fresh.train_x[0]
    server.submit("knn", (q,), deadline_s=10.0)
    server.drain()
    assert observed == ["knn"]
    run = fresh.run

    def collecting(prepared, batch, *, refine_budget):
        gc.collect()
        return run(prepared, batch, refine_budget=refine_budget)

    fresh.run = collecting
    server.submit("knn", (q,), deadline_s=10.0)
    (resp,) = server.drain()
    assert resp.refined is not None
    assert observed == ["knn"]
    fresh.run = run
    server.submit("knn", (q,), deadline_s=10.0)
    server.drain()
    assert observed == ["knn", "knn"]


@pytest.mark.parametrize("power", [-12, -9, -1, 3])
def test_chip_smoke_slo_deadlines_stay_in_one_batcher_class(power):
    """``chip_smoke.one_slo_class`` raises a deadline that lies less than
    SLO_CLASS_MARGIN above a power of two to that margin above it, and
    leaves every other one as it is.  A wave of requests with one such
    deadline, submitted over less than the margin, forms one batch; with
    the deadline just above the power of two the batcher splits it, the
    earlier requests in the class below (a behaviour of the reference's
    batcher that the phase steers clear of)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    edge = 2.0 ** power
    margin = cs.SLO_CLASS_MARGIN
    for d in (edge, edge * 1.01, edge * (1 + margin / 2)):
        assert cs.one_slo_class(d) == pytest.approx(edge * (1 + margin),
                                                    rel=1e-12)
    for d in (edge * (1 + margin), edge * 1.5, edge * 1.99):
        assert cs.one_slo_class(d) == d

    def batches(deadline_s):
        batcher = ContinuousBatcher(max_batch=64, pad_sizes=(64,))
        spread = edge * margin * 0.9        # the wave's submission time
        for i in range(8):
            batcher.submit(Request(kind="knn", payload=(),
                                   deadline_s=deadline_s,
                                   arrival_t=spread * i / 7))
        sizes, now = [], spread
        while (b := batcher.next_batch(now)) is not None:
            sizes.append(b.n)
        return sizes

    assert batches(edge * 1.01) != [8]
    assert batches(cs.one_slo_class(edge * 1.01)) == [8]


@pytest.mark.parametrize("variant", ["as-is", "no-host-term", "no-turns",
                                     "no-gc-guard", "no-class-margin",
                                     "no-held-answers"])
def test_serve_relaxed_tool_serves_each_variant_on_the_cpu(monkeypatch,
                                                             variant):
    """``tools/torch_serve_relaxed.py``'s serving at a small size, with
    counting plain versions in place of the kernels: each variant serves
    the waves with its part of the calibration taken out, and its patches
    are undone after."""
    import importlib.util
    import sys
    from pathlib import Path

    from _torch_parity import plain_kernels
    from repro_torch.apps import knn
    from repro_torch.data.synthetic import make_mfeat_like

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    spec = importlib.util.spec_from_file_location(
        "torch_serve_relaxed", root / "tools" / "torch_serve_relaxed.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert set(tool.VARIANTS) == {
        "as-is", "no-host-term", "no-turns", "no-gc-guard",
        "no-class-margin", "no-held-answers"}
    plain_kernels(monkeypatch)
    x, y = make_mfeat_like(_gen(0), n_points=8192 + 256, n_features=16,
                           n_classes=10, device="cpu")

    def owner(name):
        module, _, cls = name.partition(":")
        mod = sys.modules[module]
        return getattr(mod, cls) if cls else mod

    fitted = []
    monkeypatch.setattr(server_mod.Server, "calibrate", (
        lambda calibrate: lambda self, kind, **kw: (
            calibrate(self, kind, **kw),
            fitted.append(self.controller.models[kind]))[0])(
        server_mod.Server.calibrate))
    before = {(m, a): getattr(owner(m), a)
              for m, a, _ in sum(tool.VARIANTS.values(), [])
              if m.partition(":")[0] in sys.modules}
    restore = tool.patched(variant)
    try:
        r = tool.serving(torch, cs, knn, (x[256:], y[256:], x[:256]),
                         [(q,) for q in x[:256]])
    finally:
        restore()
    for (m, a), v in before.items():
        assert getattr(owner(m), a) is v
    assert set(r) >= {"ok", "eps", "escalated", "correction", "model", "gc",
                      "batches", "wait", "cut"}
    assert r["batches"] >= cs.SERVE_WAVES
    (model,) = fitted
    assert (model.c_fixed == 0.0) == (variant == "no-host-term")


def test_serve_relaxed_tool_serves_cf_on_the_cpu(monkeypatch):
    """``tools/torch_serve_relaxed.py --kind cf --keep``'s serving at a small
    size, with counting plain versions in place of the kernels: the check
    is CF's (no relaxed escalation), every batch after calibration is
    listed with its class and its window in parts, the first serving's
    pass and copy times are there, and ``keep`` holds the responses."""
    import importlib.util
    import sys
    from pathlib import Path

    from _torch_parity import plain_kernels
    from repro_torch.apps import cf
    from repro_torch.data.synthetic import make_netflix_like

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    spec = importlib.util.spec_from_file_location(
        "torch_serve_relaxed", root / "tools" / "torch_serve_relaxed.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    plain_kernels(monkeypatch)
    r, m = make_netflix_like(_gen(1), n_users=1024 + 256, n_items=200,
                             density=0.05, device="cpu")
    data = (r[256:], m[256:], r[:256], m[:256])
    kept = []
    out = tool.serving(torch, cs, cf, data,
                       [(r[i], m[i]) for i in range(256)], "cf", costs=True,
                       keep=kept)
    assert out["ok"] == (out["escalated"] == 0)
    classes = [c for c, *_ in out["seq"]]
    assert set(classes) == set(cs.SERVE_CLASSES["cf"])
    assert len(classes) >= 2 * cs.SERVE_WAVES
    for _, corr, eps, ratio, parts in out["seq"]:
        assert corr > 0 and 0.0 <= eps <= 0.05 and len(parts) == 5
        assert (ratio is None) == (parts[3] is None)
    assert {k.split(" eps ")[0] for k in out["rows"]} == {"probe", "real"}
    assert set(out["unpack"]) == {"unpack dropped", "unpack held",
                                  "pinned dropped", "pinned held"}
    (responses,) = kept
    assert len(responses) >= 2 * cs.SERVE_WAVES * cs.SERVE_BATCH
