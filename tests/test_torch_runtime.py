"""The port's runtime (``repro_torch.runtime``): the chaos injector, the
supervisor and the sharded failure domains, held against the JAX package.

Each scenario of ``tests/test_chaos.py`` (the 14 runtime and front-door
ones), the two supervisor scenarios of ``tests/test_substrate.py`` and
the supervisor scenarios of ``tests/test_obs.py`` and
``tests/test_obs_slo.py`` is written once against a ``Side`` (the JAX
package or the port), run on both, and the two records compared: the
answers, partial shards and ``summary()`` of the fleets, the front
door's statistics, the supervisor's reports.  The port's fleet gets the
reference's per-domain LSH draws (``jax.random.fold_in(key, s)``) through
numpy, so both build the same buckets.

Tolerances: answers, labels and summaries equal; merged top-k distances
and bounds within 1e-4 (the reference's distance tolerance).  Where a
scenario's outcome depends on a measured time (the slowed and hedged
shards), the record holds what the injected stall decides, not every
shard's timing.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import np_of
from repro.core import lsh as jlsh

N, D, C = 256, 8, 5
TOL = 1e-4


def _reference_data():
    key = jax.random.PRNGKey(0)
    x = np.asarray(jax.random.normal(key, (N, D)))
    y = np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (N,), 0, C))
    q = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(3), i), (D,)))
        for i in range(24)])
    return x, y, q


X, Y, QUERIES = _reference_data()


def _folded_draws(n_shards: int) -> list:
    """The JAX package's per-domain draws: ``init_lsh`` under
    ``fold_in(PRNGKey(7), s)``."""
    cfg = jlsh.LSHConfig(n_hashes=4, bucket_width=4.0)
    out = []
    for s in range(n_shards):
        p = jlsh.init_lsh(jax.random.fold_in(jax.random.PRNGKey(7), s), D,
                          cfg)
        out.append((np.asarray(p.a), np.asarray(p.b)))
    return out


class Side:
    """One package's runtime, serving and observability modules, and how it
    takes the scenario's inputs."""

    def __init__(self, port: bool):
        root = "repro_torch" if port else "repro"
        self.port = port
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.rt = mod("runtime")
        self.chaos = mod("runtime.chaos")
        self.serve = mod("serve")
        self.budget = mod("core.budget")
        self.metrics = mod("obs.metrics")
        self.trace = mod("obs.trace")
        self.slo = mod("obs.slo")
        self.ckpt = mod("checkpoint")

    def fleet(self, chaos=None, n_shards=4, **kwargs):
        if self.port:
            return self.rt.sharded_knn(
                X, Y, n_shards=n_shards, n_classes=C, k=3,
                lsh_params=_folded_draws(n_shards), chaos=chaos,
                device="cpu", **kwargs)
        return self.rt.sharded_knn(
            jnp.asarray(X), jnp.asarray(Y), n_shards=n_shards, n_classes=C,
            k=3, lsh_key=jax.random.PRNGKey(7), chaos=chaos, **kwargs)

    def query(self, i):
        return (QUERIES[i] if self.port else jnp.asarray(QUERIES[i]),)

    def scalar(self, v: float):
        return torch.tensor(v) if self.port else jnp.asarray(v)

    def controller(self, eps_max=0.32, floor=0.004):
        policy = self.budget.BudgetPolicy(
            compression_ratio=8.0, eps_max=eps_max, degrade_floor=floor)
        ctl = self.serve.DeadlineController(policy, ema=0.0)
        ctl.set_model("knn", self.budget.CostModel(
            c_fixed=0.0, c_stage1=0.0, c_stage2=1.0 / N))
        return ctl

    def checkpointer(self, d):
        if self.port:
            return self.ckpt.Checkpointer(str(d), device="cpu")
        return self.ckpt.Checkpointer(str(d))

    def counter(self, name, labels):
        return self.metrics.default_registry().counter(name, labels=labels)


REF, PORT = Side(False), Side(True)


def _both(scenario, *args):
    """Run ``scenario`` on the JAX package and on the port; their records
    must be equal."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _out(out) -> dict:
    """A fleet output's comparable parts: labels and votes exact, the
    distances and bounds rounded at the tolerance."""
    d, labels, vote, bound = (np_of(t) for t in out)
    return {"labels": labels.tolist(), "vote": vote.tolist(),
            "d": np.round(d / TOL).astype(np.int64).tolist(),
            "bound": np.round(bound / TOL).astype(np.int64).tolist()}


def _summary(fleet) -> dict:
    """``summary()`` without what the clock decides: the hedges (the JAX
    package's first runs compile, and take long enough to be hedged) and
    the eps scales."""
    return {k: v for k, v in fleet.summary().items()
            if k not in ("hedges", "hedge_wins", "eps_scale")}


def _responses(responses, rids) -> list:
    by_rid = {}
    for r in responses:
        by_rid.setdefault(r.rid, []).append(
            (r.reexecuted, r.answer, r.partial_shards, r.escalated))
    return [sorted(by_rid.get(rid, [])) for rid in rids]


# ---------------------------------------------------------------------------
# the fleet against the reference's, and its merge
# ---------------------------------------------------------------------------

def _fleet_run(side):
    fleet = side.fleet(hedge=False)
    prepared = fleet.build(8.0)
    padded = fleet.pad_batch([side.query(i) for i in range(5)], 8)
    return [_out(fleet.run(prepared, padded, refine_budget=b))
            for b in (0, 8, 64)] + [fleet.summary()]


def test_fleet_answers_equal_the_reference():
    _both(_fleet_run)


def test_fleet_merge_is_one_candidate_topk_launch(monkeypatch):
    from repro_torch.apps import knn as knn_lib

    fleet = PORT.fleet(n_shards=4)
    prepared = fleet.build(8.0)
    padded = fleet.pad_batch([PORT.query(i) for i in range(3)], 4)
    outs = [s.run(p, padded, refine_budget=8)
            for s, p in zip(fleet.shards, prepared)]
    calls = []
    real = knn_lib.kernel_ops.candidate_topk

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(knn_lib.kernel_ops, "candidate_topk", counting)
    merged = fleet.merge_fn(outs)
    assert calls == [torch.Size([3, 4, 3])]     # shards 1..3 in one stack
    assert torch.equal(merged[3], torch.stack([o[3] for o in outs]).amax(0))


def test_sharded_knn_takes_exactly_one_kind_of_draw():
    with pytest.raises(ValueError, match="exactly one"):
        PORT.rt.sharded_knn(X, Y, n_shards=2, n_classes=C, device="cpu")
    with pytest.raises(ValueError, match="2 shards"):
        PORT.rt.sharded_knn(X, Y, n_shards=2, n_classes=C, device="cpu",
                            lsh_params=_folded_draws(3))
    gens = [torch.Generator().manual_seed(s) for s in range(2)]
    fleet = PORT.rt.sharded_knn(X, Y, n_shards=2, n_classes=C, k=3,
                                lsh_generators=gens, device="cpu")
    assert len(fleet.shards) == 2 and fleet.n_points == N // 2


# ---------------------------------------------------------------------------
# injector determinism
# ---------------------------------------------------------------------------

def _collect(side, inj, steps=30, shards=4, order=None):
    keys = [(s, sh, kind) for s in range(steps) for sh in range(shards)
            for kind in side.chaos.EVENT_KINDS]
    if order is not None:
        keys = order(keys)
    return {k for k in keys if inj.fires(k[0], k[1], k[2]) is not None}


def _injector_determinism(side):
    kwargs = dict(p_kill=0.1, p_slow=0.2, p_drop_heartbeat=0.15,
                  p_corrupt_snapshot=0.1)
    a = _collect(side, side.rt.ChaosInjector(seed=42, **kwargs))
    b = _collect(side, side.rt.ChaosInjector(seed=42, **kwargs))
    assert a == b and a
    assert {k[2] for k in a} == set(side.chaos.EVENT_KINDS)
    c = _collect(side, side.rt.ChaosInjector(seed=42, **kwargs),
                 order=lambda ks: list(reversed(ks)))
    assert c == a
    d = _collect(side, side.rt.ChaosInjector(seed=43, **kwargs))
    assert d != a
    return sorted(a), sorted(d)


def test_injector_deterministic_under_fixed_seed():
    _both(_injector_determinism)


def _decisions(side, with_schedule):
    inj = side.rt.ChaosInjector(seed=9, p_kill=0.05, p_slow=0.1,
                                slow_factor=5.0, p_drop_heartbeat=0.1,
                                p_corrupt_snapshot=0.05)
    if with_schedule:
        inj.kill(1, 3)
        inj.slow(2, 4, factor=3.0)
        inj.corrupt_snapshot(0, 7)
    out = []
    for seed_step in range(12):
        for shard in range(5):
            for kind in side.chaos.EVENT_KINDS:
                for attempt in (0, 1):
                    ev = inj.fires(seed_step, shard, kind, attempt=attempt)
                    out.append(None if ev is None else
                               (ev.kind, ev.shard, ev.step, ev.factor))
    return out, inj.summary()


@pytest.mark.parametrize("with_schedule", [False, True])
def test_injector_decisions_equal_the_reference(with_schedule):
    out, summary = _both(_decisions, with_schedule)
    assert summary["fired"] > 0


def _schedule_and_attempt(side):
    kill, slow = side.chaos.KILL, side.chaos.SLOW
    inj = side.rt.ChaosInjector(seed=0)
    inj.kill(2, 5)
    inj.slow(1, 3, factor=6.0)
    assert inj.fires(5, 2, kill) is not None
    assert inj.fires(5, 1, kill) is None
    assert inj.fires(4, 2, kill) is None
    ev = inj.fires(3, 1, slow)
    assert ev is not None and ev.factor == 6.0
    assert inj.fires(3, 1, slow, attempt=1) is None
    assert inj.summary()["fired"] == 2
    return inj.summary(), [(e.kind, e.shard, e.step, e.factor)
                           for e in inj.fired]


def test_injector_schedule_and_attempt_semantics():
    _both(_schedule_and_attempt)


# ---------------------------------------------------------------------------
# fault-domain serving: kill -> partial -> recovery
# ---------------------------------------------------------------------------

def _kill_mid_batch(side):
    chaos = side.rt.ChaosInjector(seed=1)
    fleet = side.fleet(chaos, recovery_batches=2)
    server = side.serve.Server([fleet], controller=side.controller())
    record = []
    rids = [server.submit("knn", side.query(i), 5.0) for i in range(3)]
    healthy = server.drain()
    assert {r.rid for r in healthy} == set(rids)
    assert all(r.partial_shards == () for r in healthy)
    record.append(_responses(healthy, rids))

    chaos.kill(1, fleet.step)
    rids2 = [server.submit("knn", side.query(i), 5.0) for i in range(3)]
    degraded = server.drain()
    assert {r.rid for r in degraded} >= set(rids2)
    for r in degraded:
        assert r.partial_shards == (1,)
        assert r.degraded
        assert r.stage1 is not None
    assert fleet.summary()["kills"] == 1
    record.append(_responses(degraded, rids2))

    for i in range(4):
        server.submit("knn", side.query(i), 5.0)
        record.append([(r.reexecuted, r.answer, r.partial_shards)
                       for r in server.drain()])
    assert fleet.summary()["state"] == ["healthy"] * 4
    assert fleet.summary()["recoveries"] == 1
    server.submit("knn", side.query(9), 5.0)
    (back,) = [r for r in server.drain() if not r.reexecuted]
    assert back.partial_shards == ()
    fam = server.metrics.registry.counter("serve_partial_total",
                                          labels=("kind",))
    assert fam.labels(kind="knn").value >= len(rids2)
    return record, back.answer, _summary(fleet)


def test_shard_kill_mid_batch_answers_every_rid_flagged_partial():
    _both(_kill_mid_batch)


def _never_kill_last(side):
    chaos = side.rt.ChaosInjector(seed=5, p_kill=1.0)
    fleet = side.fleet(chaos, n_shards=3)
    prepared = fleet.build(8.0)
    padded = fleet.pad_batch([side.query(0)], 1)
    outs = []
    for _ in range(5):
        out = fleet.run(prepared, padded, refine_budget=0)
        assert out is not None
        outs.append((_out(out), fleet.last_partial_shards))
    assert fleet.summary()["state"].count("dead") <= 2
    assert len(fleet.last_partial_shards) <= 2
    return outs, _summary(fleet)


def test_never_kills_last_surviving_shard():
    _both(_never_kill_last)


def _recoveries(side, outcome):
    return side.counter("runtime_shard_recoveries_total",
                        ("outcome",)).labels(outcome=outcome).value


def _corrupt_snapshot(side, tmp_path):
    d = tmp_path / ("port" if side.port else "ref")
    chaos = side.rt.ChaosInjector(seed=2)
    fleet = side.fleet(chaos, recovery_batches=1, snapshot_dir=d)
    prepared = fleet.build(8.0)
    assert fleet.save_snapshot(d) > 0
    padded = fleet.pad_batch([side.query(0)], 1)
    outs = [_out(fleet.run(prepared, padded, refine_budget=0))]
    before = _recoveries(side, "rebuilt")
    assert side.chaos.corrupt_snapshot_dir(d) > 0
    chaos.kill(0, fleet.step)
    outs.append(_out(fleet.run(prepared, padded, refine_budget=0)))
    assert fleet.last_partial_shards == (0,)
    outs.append(_out(fleet.run(prepared, padded, refine_budget=0)))
    assert fleet.summary()["recoveries"] == 1
    assert fleet.summary()["state"][0] == "healthy"
    assert _recoveries(side, "rebuilt") == before + 1
    out = fleet.run(prepared, padded, refine_budget=0)
    assert fleet.last_partial_shards == () and out is not None
    return outs + [_out(out)], _summary(fleet)


def test_recovery_from_corrupt_snapshot_falls_back_to_rebuild(tmp_path):
    _both(_corrupt_snapshot, tmp_path)


def _snapshot_restore(side, tmp_path):
    d = tmp_path / ("port" if side.port else "ref")
    chaos = side.rt.ChaosInjector(seed=3)
    fleet = side.fleet(chaos, recovery_batches=1, snapshot_dir=d)
    prepared = fleet.build(8.0)
    fleet.save_snapshot(d)
    padded = fleet.pad_batch([side.query(0)], 1)
    before = _recoveries(side, "restored")
    chaos.kill(2, fleet.step)
    outs = [_out(fleet.run(prepared, padded, refine_budget=0))
            for _ in range(2)]
    assert _recoveries(side, "restored") == before + 1
    outs.append(_out(fleet.run(prepared, padded, refine_budget=0)))
    return outs, _summary(fleet)


def test_snapshot_restore_recovery(tmp_path):
    _both(_snapshot_restore, tmp_path)


# ---------------------------------------------------------------------------
# straggler eps-shrink + hedging
# ---------------------------------------------------------------------------

def _slow_shard(side):
    chaos = side.rt.ChaosInjector(seed=4, slow_factor=1000.0)
    fleet = side.fleet(chaos, hedge=False, max_slow_sleep_s=0.05)
    prepared = fleet.build(8.0)
    padded = fleet.pad_batch([side.query(0)], 1)
    fleet.run(prepared, padded, refine_budget=8)  # warm
    chaos.slow(2, fleet.step)
    fleet.on_batch_deadline(0.05)  # timeout = 0.35 * 0.05 < the stall
    out = _out(fleet.run(prepared, padded, refine_budget=8))
    assert fleet.summary()["eps_scale"][2] == 0.5
    assert any(ev.kind == side.chaos.SLOW and ev.shard == 2
               for ev in chaos.fired)
    fleet.on_batch_deadline(10.0)
    fleet.run(prepared, padded, refine_budget=8)
    assert fleet.summary()["eps_scale"][2] == 1.0
    return out["vote"], [(e.kind, e.shard, e.step) for e in chaos.fired]


def test_slow_shard_timeout_shrinks_then_restores_eps_scale():
    _both(_slow_shard)


def _hedge(side):
    chaos = side.rt.ChaosInjector(seed=6, slow_factor=1000.0)
    fleet = side.fleet(chaos, hedge=True, hedge_skew=3.0, min_hedge_s=0.01,
                       max_slow_sleep_s=0.08)
    prepared = fleet.build(8.0)
    padded = fleet.pad_batch([side.query(0)], 1)
    fleet.run(prepared, padded, refine_budget=0)  # warm
    chaos.slow(3, fleet.step)
    fleet.on_batch_deadline(10.0)
    out = _out(fleet.run(prepared, padded, refine_budget=0))
    s = fleet.summary()
    assert s["hedges"] >= 1
    assert s["hedge_wins"] >= 1
    assert any(r["status"] == "hedged" for r in fleet.last_reports)
    hedged = [r["shard"] for r in fleet.last_reports
              if r["status"] == "hedged"]
    return out, hedged, s["kills"], s["state"]


def test_hedged_redispatch_escapes_injected_slowdown():
    _both(_hedge)


# ---------------------------------------------------------------------------
# front door: quotas and the load-shed ladder, on the sharded fleet
# ---------------------------------------------------------------------------

def _front_door(side, **kwargs):
    server = side.serve.Server([side.fleet()], controller=side.controller())
    return side.serve.FrontDoor(server, default_deadline_s=5.0,
                                **kwargs), server


def _result(side, r):
    if isinstance(r, side.serve.Overloaded):
        return ("overloaded", r.reason, r.shed_level)
    return ("response", r.answer, r.partial_shards)


def _quota(side):
    fd, server = _front_door(
        side, tenants=[side.serve.TenantSpec("metered", rate=0.0,
                                             burst=2.0)],
        queue_limit=16)
    r1 = fd.submit("knn", side.query(0), tenant="metered")
    r2 = fd.submit("knn", side.query(1), tenant="metered")
    r3 = fd.submit("knn", side.query(2), tenant="metered")
    assert len(server.batcher) == 0
    assert fd.backlog() == 2
    refusal = fd.result(r3)
    assert isinstance(refusal, side.serve.Overloaded)
    assert refusal.reason == "quota" and refusal.tenant == "metered"
    assert refusal.answer is None
    fd.pump(max_batches=10)
    assert isinstance(fd.result(r1), side.serve.Response)
    assert isinstance(fd.result(r2), side.serve.Response)
    assert isinstance(fd.result(r3), side.serve.Overloaded)
    assert fd.stats()["admitted"] == 2
    assert fd.stats()["rejected"]["quota"] == 1
    return [_result(side, fd.result(r)) for r in (r1, r2, r3)], \
        fd.stats()["rejected"]


def test_quota_rejected_submits_never_enter_the_batcher():
    _both(_quota)


def _ladder(side):
    fd, server = _front_door(side, queue_limit=4)
    base_eps = server.controller.policy.eps_max
    rids = [fd.submit("knn", side.query(i)) for i in range(24)]
    stats = fd.stats()
    assert stats["rejected"]["overload"] > 0
    assert stats["shed_before_reject"]
    assert stats["first_shed_t"] < stats["first_reject_t"]
    downs = [t for t in stats["shed_transitions"] if t["to"] > t["from"]]
    assert [t["to"] for t in downs[:3]] == [1, 2, 3]
    assert all(t["t"] <= stats["first_reject_t"] for t in downs[:3])
    assert server.controller.policy.eps_max == pytest.approx(
        base_eps * fd.ladder.factor)
    while fd.backlog():
        fd.pump(max_batches=4)
    results = [fd.result(rid) for rid in rids]
    assert all(r is not None for r in results)
    assert {type(r) for r in results} == {side.serve.Response,
                                          side.serve.Overloaded}
    refused = [r for r in results if isinstance(r, side.serve.Overloaded)]
    assert all(r.reason == "overload" and r.retry_after_s > 0
               for r in refused)
    assert all(r.shed_level == fd.ladder.max_level for r in refused)
    for _ in range(10):
        fd.pump()
    assert fd.ladder.level == 0
    assert server.controller.policy.eps_max == pytest.approx(base_eps)
    return ([_result(side, r) for r in results], stats["admitted"],
            stats["rejected"], [(t["from"], t["to"]) for t in downs])


def test_load_shed_ladder_steps_down_before_first_rejection():
    _both(_ladder)


def _hysteresis(side):
    ladder = side.serve.LoadShedLadder(fire=0.7, clear=0.25)
    seen = [ladder.evaluate(0.9, now=0.0), ladder.level]
    assert seen == [True, 1]
    seen += [ladder.evaluate(0.5, now=1.0), ladder.level]
    seen += [ladder.evaluate(0.1, now=2.0), ladder.level]
    assert seen[2:] == [False, 1, True, 0]
    with pytest.raises(ValueError):
        side.serve.LoadShedLadder(fire=0.3, clear=0.5)
    return seen


def test_ladder_hysteresis_band():
    _both(_hysteresis)


def _thread_mode(side):
    fd, _ = _front_door(side, queue_limit=32, poll_s=0.001)
    fd.start()
    try:
        rids = [fd.submit("knn", side.query(i)) for i in range(6)]
        results = [fd.wait(rid, timeout_s=60.0) for rid in rids]
    finally:
        fd.stop()
    assert all(isinstance(r, side.serve.Response) for r in results)
    with pytest.raises(KeyError):
        fd.wait(10**9)
    return [r.answer for r in results]


def test_front_door_thread_mode_answers_all():
    _both(_thread_mode)


# ---------------------------------------------------------------------------
# drain guard + re-execution can't re-escalate
# ---------------------------------------------------------------------------

def _drain_guard(side):
    server = side.serve.Server([side.fleet()],
                               controller=side.controller(eps_max=0.32,
                                                          floor=0.5))
    server.submit("knn", side.query(0), 1e-9)
    responses = server.drain()
    assert [r.reexecuted for r in responses] == [False, True]
    assert responses[0].escalated
    assert len(server.batcher) == 0
    server.submit("knn", side.query(1), 5.0)
    server.submit("knn", side.query(2), 1e-9)
    with pytest.raises(RuntimeError, match="max_steps"):
        server.drain(max_steps=1)
    rest = server.drain()
    # rids come from each package's process-wide counter, which the tests
    # run before this one in the same process advance unequally: compare
    # them from the scenario's first
    first = responses[0].rid
    return ([(r.reexecuted, r.escalated, r.answer) for r in responses],
            sorted((r.rid - first, r.reexecuted, r.answer) for r in rest))


def test_drain_bounded_and_reexecution_never_reescalates():
    _both(_drain_guard)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def _shard_identity(side, tmp_path):
    d = tmp_path / ("port" if side.port else "ref")
    sup = side.rt.Supervisor(
        side.checkpointer(d), save_every=100,
        injector=side.rt.FailureInjector({2: "straggler"}))
    state, report = sup.run(side.scalar(0.0), lambda s, i: s + 1,
                            num_steps=4, shard=3)
    assert list(sup.heartbeats) == [3]
    assert sup.heartbeats[3].shard == 3
    assert len(report["stragglers"]) == 1
    gauge = side.metrics.default_registry().gauge(
        "runtime_straggler_eps", labels=("shard",))
    assert gauge.labels(shard=3).value > 0.0
    assert sup.dead_shards(timeout_s=0.0) == [3]
    assert not sup.heartbeats[3].alive
    assert sup.dead_shards(timeout_s=1e9) == []
    return float(state), report, gauge.labels(shard=3).value


def test_supervisor_shard_identity_parameterized(tmp_path):
    _both(_shard_identity, tmp_path)


def _node_failure(side, tmp_path):
    d = tmp_path / ("port" if side.port else "ref")
    sup = side.rt.Supervisor(
        side.checkpointer(d), save_every=5,
        injector=side.rt.FailureInjector({12: "node_failure"}))
    final, report = sup.run({"x": side.scalar(0.0)},
                            lambda s, i: {"x": s["x"] + 1.0}, num_steps=20)
    assert report["restarts"] == 1
    assert report["final_step"] == 20
    assert float(final["x"]) == 20.0
    assert sorted(p.name for p in d.iterdir() if p.name.startswith(
        "step_")) == ["step_10", "step_15", "step_20", "step_5"]
    return report


def test_supervisor_recovers_from_node_failure(tmp_path):
    _both(_node_failure, tmp_path)


def _straggler_eps(side, tmp_path):
    d = tmp_path / ("port" if side.port else "ref")
    sup = side.rt.Supervisor(
        side.checkpointer(d), save_every=100,
        injector=side.rt.FailureInjector({3: "straggler"}),
        budget_policy=side.budget.BudgetPolicy(eps_max=0.1))
    _, report = sup.run({"x": side.scalar(0.0)}, lambda s, i: s,
                        num_steps=5)
    assert len(report["stragglers"]) == 1
    step, eps = report["stragglers"][0]
    assert 0.0 <= eps <= 0.1
    return report


def test_supervisor_straggler_degrades_eps(tmp_path):
    _both(_straggler_eps, tmp_path)


def _lifecycle(side, tmp_path):
    d = tmp_path / ("port" if side.port else "ref")
    fam = side.counter("runtime_shard_events_total", ("event", "shard"))
    events = ("started", "straggling", "finished")
    before = {e: fam.labels(event=e, shard=0).value for e in events}
    tr = side.trace.Tracer()
    with side.trace.use_tracer(tr):
        sup = side.rt.Supervisor(
            side.checkpointer(d), save_every=100,
            injector=side.rt.FailureInjector({2: "straggler"}))
        state, info = sup.run(side.scalar(0.0), lambda s, step: s + 1,
                              num_steps=5)
    assert float(state) == 5.0
    assert len(info["stragglers"]) == 1
    for e in events:
        assert fam.labels(event=e, shard=0).value == before[e] + 1, e
    names = [sp.name for root in tr.traces() for sp in root.walk()]
    assert {"shard.started", "shard.straggling", "shard.finished"} <= \
        set(names)
    straggle = next(sp for root in tr.traces() for sp in root.walk()
                    if sp.name == "shard.straggling")
    assert straggle.attrs["eps"] > 0
    return names, straggle.attrs


def test_supervisor_emits_shard_lifecycle_events(tmp_path):
    _both(_lifecycle, tmp_path)


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _watch_feed(side, tmp_path):
    d = tmp_path / ("port" if side.port else "ref")
    clock = _FakeClock()
    watch = side.slo.StragglerWatch(
        min_beats=1, registry=side.metrics.MetricsRegistry(), clock=clock)
    sup = side.rt.Supervisor(
        side.checkpointer(d), save_every=100,
        injector=side.rt.FailureInjector({2: "straggler"}),
        watch=watch, clock=clock)

    def step_fn(state, step):
        clock.advance(0.01)
        return state + 1

    state, info = sup.run(side.scalar(0.0), step_fn, num_steps=5)
    assert float(state) == 5.0
    assert len(info["stragglers"]) == 1
    _, eps = info["stragglers"][0]
    gauge = side.metrics.default_registry().get("runtime_straggler_eps")
    assert gauge.labels(shard=0).value == pytest.approx(eps)
    assert watch.rollup.stats("shard_dt[0]")["count"] == 5
    return info, watch.rollup.stats("shard_dt[0]")


def test_supervisor_straggler_eps_gauge_and_watch_feed(tmp_path):
    _both(_watch_feed, tmp_path)


def test_chip_smoke_fleet_phase_runs_on_the_cpu(monkeypatch):
    """The card's fleet phase at a small size, with counting plain versions
    in place of the kernels: every check of it holds.  On one thread: the
    phase holds every run to the bits of a later direct run, and MKL's
    threaded products need not repeat their bits."""
    from _torch_parity import chip_smoke, plain_kernels
    from repro_torch.data.synthetic import make_mfeat_like
    from repro_torch.kernels import ops

    cs = chip_smoke()
    plain_kernels(monkeypatch)
    # The hedge rule re-dispatches the slowest domain when it ran at least
    # 4x the median.  A domain's run here takes a few ms, and on a host
    # shared with other jobs the eight domains' times spread that far
    # apart on their own (9 hedges in 24 runs of one such run), so an 8x
    # slowdown need not make the slowed domain the one hedged: the CPU
    # run slows it 100x (its stall still under FLEET_MAX_STALL_S).
    monkeypatch.setattr(cs, "FLEET_SLOW_FACTOR", 100.0)
    x, y = make_mfeat_like(torch.Generator().manual_seed(0),
                           n_points=8192 + 16, n_features=16, n_classes=10,
                           device="cpu")
    probe = cs.CaptureProbe(torch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        summary, counts = cs.fleet_phase(torch, ops, probe,
                                         (x[16:], y[16:], x[:16], y[:16]),
                                         batch=16)
    finally:
        torch.set_num_threads(threads)
    cs.print_fleet(summary, "cpu")
    cs.check_launched("fleet", counts, cs.FLEET_KERNELS)
    # the healthy and the partial wave's kernel calls are captured, for
    # the kernels' rows: each domain's stages, and the merge of all eight
    # domains' [16, 5] answers and of the seven live ones'
    assert set(probe.calls) == {"distance_topk", "candidate_topk",
                                "knn_distance", "refine_distances"}
    assert all(key[0] == "fleet" for calls in probe.calls.values()
               for key in calls)
    merged = {key[1] for key in probe.calls["candidate_topk"]
              if len(key[1]) == 3}
    # (the merge seeds its selection with the first domain's answer and
    # streams the others: [7, 16, 5] and [6, 16, 5])
    assert {(cs.N_SHARDS - 1, 16, cs.K), (cs.N_SHARDS - 2, 16, cs.K)} <= merged
    assert summary["recoveries"] == {"restored": 1, "rebuilt": 1}
    assert summary["kills"] == 2 and summary["hedge_wins"] >= 1
    assert summary["merges"] == 2 * len(cs.FLEET_PLAN)   # one a run
