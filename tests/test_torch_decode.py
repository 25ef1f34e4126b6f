"""The port's aggregated-KV LM decode against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; the JAX package draws the model
weights and the LSH projections, and ``repro_torch.convert`` carries them
across.  Both sides then run the same decode: ``aggregated_kv`` in both
cache layouts, ``serve_step``, and ``DecodeEngine`` prefill -> insert ->
generate_step at refine_frac 0, 0.05, 0.25 and 1.0, with a shard killed.
Tolerance: 2e-5 on attention outputs and logits (the reference's attention
tolerance, tests/test_decode.py:255: float32 sums in another order);
tokens, bucket ids, counts and selections are equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import assert_close, normal, np_of, rng, th
from repro.configs import get_config as jax_config
from repro.models import aggregated_kv as jakv
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import serve_step as jax_serve_step
from repro.serve.lm import DecodeEngine as JaxDecodeEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_lsh_from_numpy, lm_params_from_numpy
from repro_torch.kernels.topk_stream import MAX_K
from repro_torch.models import aggregated_kv as akv
from repro_torch.models import model as model_lib
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.serve.lm.engine import DecodeEngine
from repro_torch.serve.lm.sharded import BucketShardPlan

TOL = 2e-5
RFS = (0.0, 0.05, 0.25, 1.0)
LAYOUTS = ("flat", "bucket_major")
jx = jnp.asarray


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lsh(cache):
    return (th(np.asarray(cache.lsh_a)), th(np.asarray(cache.lsh_b)))


def _same_cache(got, want, *, exact=("counts", "bucket_of")):
    """Every field of a port cache against the JAX cache's."""
    for name in ("k", "v", "bucket_of", "mean_k", "mean_v", "over_k",
                 "over_v", "counts"):
        if not hasattr(want, name):
            continue
        g, w = np_of(getattr(got, name)), np.asarray(getattr(want, name))
        if name in exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# aggregated_kv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac,k", [(0.0, 8), (0.05, 8), (0.25, 8), (1.0, 8),
                                    (0.05, 64), (3 / 7, 7), (2.0, 5)])
def test_refine_count_matches_reference(frac, k):
    assert akv.refine_count(frac, k) == jakv.refine_count(frac, k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bucket_ids_match_reference_with_negative_hashes(layout):
    init = jakv.init_cache if layout == "flat" else jakv.init_bucket_major
    jcache = init(jax.random.PRNGKey(3), batch=64, s_max=64, n_kv=2, dk=8,
                  compression=4, dtype=jnp.float32)
    keys = normal(rng(3), 64, 2, 8) * 3
    h = np.floor((keys.reshape(64, -1) @ np.asarray(jcache.lsh_a)
                  + np.asarray(jcache.lsh_b)) / akv.LSH_WIDTH)
    assert (h < 0).mean() > 0.3            # the uint32 wrap is exercised
    tinit = akv.init_cache if layout == "flat" else akv.init_bucket_major
    tcache = tinit(_lsh(jcache), batch=64, s_max=64, n_kv=2, dk=8,
                   compression=4, dtype=torch.float32)
    np.testing.assert_array_equal(np_of(akv._bucket_id(tcache, th(keys))),
                                  np.asarray(jakv._bucket_id(jcache,
                                                             jx(keys))))


def _flat_pair(seed, *, batch=2, s=10, s_max=16, n_kv=2, dk=8, compression=2):
    """A flat cache filled token by token on both sides, as
    tests/test_decode.py:_filled_flat_cache fills it."""
    jcache = jakv.init_cache(jax.random.PRNGKey(seed), batch=batch,
                             s_max=s_max, n_kv=n_kv, dk=dk,
                             compression=compression, dtype=jnp.float32)
    tcache = akv.init_cache(_lsh(jcache), batch=batch, s_max=s_max,
                            n_kv=n_kv, dk=dk, compression=compression,
                            dtype=torch.float32)
    x = rng(seed)
    ks, vs = normal(x, batch, s, n_kv, dk), normal(x, batch, s, n_kv, dk)
    for t in range(s):
        pos = np.full((batch,), t, np.int32)
        jcache = jakv.insert(jcache, jx(ks[:, t]), jx(vs[:, t]), jx(pos))
        assert akv.insert(tcache, th(ks[:, t]), th(vs[:, t]),
                          th(pos)) is tcache
    return jcache, tcache, ks, vs


def _bucket_major_pair(seed, *, batch=2, s=14, s_max=8, n_kv=2, dk=8,
                       compression=2, slack=1):
    """A bucket-major cache of capacity 2 filled with 14 tokens a sequence
    into 4 buckets: buckets overflow."""
    jcache = jakv.init_bucket_major(
        jax.random.PRNGKey(seed), batch=batch, s_max=s_max, n_kv=n_kv, dk=dk,
        compression=compression, dtype=jnp.float32, slack=slack)
    tcache = akv.init_bucket_major(
        _lsh(jcache), batch=batch, s_max=s_max, n_kv=n_kv, dk=dk,
        compression=compression, dtype=torch.float32, slack=slack)
    x = rng(seed)
    ks, vs = normal(x, batch, s, n_kv, dk), normal(x, batch, s, n_kv, dk)
    for t in range(s):
        jcache = jakv.insert_bucket_major(jcache, jx(ks[:, t]), jx(vs[:, t]))
        akv.insert_bucket_major(tcache, th(ks[:, t]), th(vs[:, t]))
    return jcache, tcache


def test_flat_insert_matches_reference():
    jcache, tcache, _, _ = _flat_pair(0)
    _same_cache(tcache, jcache)


def test_bucket_major_insert_overflows_as_the_reference_does():
    jcache, tcache = _bucket_major_pair(1)
    assert int(np.asarray(jcache.counts).max()) > jcache.capacity
    _same_cache(tcache, jcache)


def test_bulk_prefill_matches_reference():
    x = rng(4)
    ks, vs = normal(x, 2, 12, 2, 8), normal(x, 2, 12, 2, 8)
    jcache = jakv.init_cache(jax.random.PRNGKey(4), batch=2, s_max=16,
                             n_kv=2, dk=8, compression=4, dtype=jnp.float32)
    tcache = akv.init_cache(_lsh(jcache), batch=2, s_max=16, n_kv=2, dk=8,
                            compression=4, dtype=torch.float32)
    got = akv.prefill(tcache, th(ks), th(vs))
    _same_cache(got, jakv.prefill(jcache, jx(ks), jx(vs)))
    assert not tcache.counts.any()          # prefill builds a new cache


@pytest.mark.parametrize("n_refine,kb,empty", [
    (1, 8, 0), (3, 8, 2), (8, 8, 3),         # fewer non-empty than R
    (MAX_K + 8, 70, 10),                     # wider than one kernel round
])
def test_select_buckets_matches_reference(n_refine, kb, empty):
    x = rng(n_refine + kb)
    qg, mean_k = normal(x, 3, 2, 2, 8), normal(x, 3, kb, 2, 8)
    counts = x.integers(1, 5, (3, kb)).astype(np.int32)
    counts[:, x.permutation(kb)[:empty]] = 0
    mean_k[1, 5] = mean_k[1, 2]             # an exact tie: lowest index first
    want_idx, want_use = jakv.select_buckets(jx(qg), jx(mean_k), jx(counts),
                                             n_refine=n_refine)
    got_idx, got_use = akv.select_buckets(th(qg), th(mean_k), th(counts),
                                          n_refine=n_refine)
    use = np.asarray(want_use)
    np.testing.assert_array_equal(np_of(got_use), use)
    np.testing.assert_array_equal(np_of(got_idx)[use],
                                  np.asarray(want_idx)[use])


@pytest.mark.parametrize("rf", RFS)
def test_decode_attend_flat_matches_reference(rf):
    jcache, tcache, ks, _ = _flat_pair(5)
    q = normal(rng(6), 2, 4, 8)
    pos = np.full((2,), ks.shape[1] - 1, np.int32)
    scale = 1.0 / math.sqrt(8)
    want = jakv.decode_attend(jx(q), jcache, jx(pos), refine_frac=rf,
                              scale=scale)
    got = akv.decode_attend(th(q), tcache, th(pos), refine_frac=rf,
                            scale=scale)
    assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rf", RFS)
def test_decode_attend_bucket_major_matches_reference(rf):
    jcache, tcache = _bucket_major_pair(7)
    q = normal(rng(8), 2, 4, 8)
    scale = 1.0 / math.sqrt(8)
    want = jakv.decode_attend_bucket_major(jx(q), jcache, refine_frac=rf,
                                           scale=scale)
    got = akv.decode_attend_bucket_major(th(q), tcache, refine_frac=rf,
                                         scale=scale)
    assert_close(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _configs(**kw):
    return (jax_config("qwen3-8b", smoke=True).with_(**kw),
            get_config("qwen3-8b", smoke=True).with_(**kw))


@pytest.fixture(scope="module")
def params():
    """The smoke qwen3-8b's weights, drawn by the JAX package and carried
    across (one set for every layout)."""
    jcfg, tcfg = _configs()
    jp = jax_init_params(jax.random.PRNGKey(1), jcfg)
    return jp, lm_params_from_numpy(_np_tree(jp), tcfg, device="cpu")


@pytest.mark.parametrize("agg", [None, "flat", "bucket_major"])
def test_serve_step_matches_reference(params, agg):
    kw = dict(agg_kv=False) if agg is None else dict(
        agg_kv=True, agg_layout=agg, agg_compression=4, agg_refine_frac=0.25)
    jcfg, tcfg = _configs(**kw)
    jp, model = params
    jcaches = jax_init_caches(jax.random.PRNGKey(7), jcfg, batch=2, s_max=32)
    lsh = (lm_cache_lsh_from_numpy(_np_tree(jcaches), tcfg, device="cpu")
           if agg else None)
    tcaches = model_lib.init_caches(tcfg, batch=2, s_max=32, lsh=lsh,
                                    device="cpu")
    toks = rng(9).integers(0, tcfg.vocab_size, (2, 14)).astype(np.int32)
    step = jax.jit(jax_serve_step, static_argnames=("cfg",))
    for t in range(toks.shape[1]):
        pos = np.full((2,), t, np.int32)
        want, jcaches = step(jp, jcaches, jx(toks[:, t:t + 1]), jx(pos),
                             cfg=jcfg)
        got, _ = model_lib.serve_step(model, tcaches, th(toks[:, t:t + 1]),
                                      th(pos), tcfg)
        assert_close(got, want, rtol=TOL, atol=TOL, err_msg=f"step {t}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

STEPS = 6


def _serve(engine, prefixes, rf, *, to_np, kill_after=None):
    """Insert prompt i into slot (1 - i), decode STEPS steps at rf; returns
    (tokens [STEPS, slots], logits [STEPS, slots, V])."""
    engine.free_all()
    for i, pf in enumerate(prefixes):
        engine.insert(pf, 1 - i)
    toks, logits = [], []
    for step in range(STEPS):
        if step == kill_after:
            engine.kill_shard(0)
        nxt, lg = engine.generate_step(rf)
        toks.append(to_np(nxt))
        logits.append(to_np(lg))
    engine.revive_shards()
    return np.stack(toks), np.stack(logits)


@pytest.fixture(scope="module", params=LAYOUTS)
def engines(request, params):
    """The JAX and the port's engines over the same weights and LSH draws,
    each with its two prompts prefilled once."""
    kw = dict(agg_kv=True, agg_layout=request.param, agg_compression=4)
    jcfg, tcfg = _configs(**kw)
    jp, model = params
    jeng = JaxDecodeEngine(jp, jcfg, max_slots=2, s_max=16,
                           key=jax.random.PRNGKey(7), n_shards=2)
    teng = DecodeEngine(
        model, tcfg, max_slots=2, s_max=16, n_shards=2,
        lsh=lm_cache_lsh_from_numpy(_np_tree(jeng.state), tcfg,
                                    device="cpu"))
    prompts = rng(10).integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    jpf = [jeng.prefill(p) for p in prompts]
    tpf = [teng.prefill(p) for p in prompts]
    return jeng, teng, jpf, tpf, prompts


def test_engine_prefill_matches_reference(engines):
    _, _, jpf, tpf, _ = engines
    for j, t in zip(jpf, tpf):
        assert t.next_token == j.next_token and t.length == j.length
        assert_close(t.logits, j.logits, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rf", RFS)
def test_engine_decode_matches_reference(engines, rf):
    jeng, teng, jpf, tpf, _ = engines
    want_t, want_l = _serve(jeng, jpf, rf, to_np=np.asarray)
    got_t, got_l = _serve(teng, tpf, rf, to_np=np_of)
    np.testing.assert_array_equal(got_t, want_t)
    assert_close(got_l, want_l, rtol=TOL, atol=TOL)


def test_engine_kill_shard_matches_reference(engines):
    jeng, teng, jpf, tpf, _ = engines
    want_t, want_l = _serve(jeng, jpf, 0.25, to_np=np.asarray, kill_after=2)
    got_t, got_l = _serve(teng, tpf, 0.25, to_np=np_of, kill_after=2)
    np.testing.assert_array_equal(got_t, want_t)
    assert_close(got_l, want_l, rtol=TOL, atol=TOL)
    assert teng.dead_shards == frozenset()


def test_engine_reinserted_prefix_is_unchanged(engines):
    """Decoding updates the engine's caches in place, never the prefix's:
    the same prefixes serve every level."""
    _, teng, _, tpf, _ = engines
    before = [[t.clone() for t in (c.counts, c.mean_k, c.k)]
              for c in tpf[0].caches]
    _serve(teng, tpf, 0.25, to_np=np_of)
    for b, c in zip(before, tpf[0].caches):
        for x, y in zip(b, (c.counts, c.mean_k, c.k)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("rf", RFS)
def test_engine_step_bytes_match_reference(engines, rf):
    jeng, teng, *_ = engines
    assert teng.step_bytes(rf) == jeng.step_bytes(rf)


def test_engine_full_refine_equals_exact_attention(engines, params):
    """refine_frac 1.0 re-attends every bucket exactly: the engine's tokens
    are those of a plain exact-attention decode of the same model."""
    _, teng, _, tpf, prompts = engines
    got_t, got_l = _serve(teng, tpf, 1.0, to_np=np_of)
    _, exact_cfg = _configs(agg_kv=False)
    model = params[1]
    for slot, prompt in ((1, prompts[0]), (0, prompts[1])):
        caches = model_lib.init_caches(exact_cfg, batch=1, s_max=16,
                                       device="cpu")
        feed = list(prompt)
        for t in range(len(prompt) + STEPS):
            logits, _ = model_lib.serve_step(
                model, caches, th(np.asarray([[feed[t]]], np.int32)),
                th(np.asarray([t], np.int32)), exact_cfg)
            if t >= len(prompt) - 1:
                feed.append(int(torch.argmax(logits[0])))
                step = t - len(prompt)
                if step >= 0:
                    assert feed[-1] == got_t[step, slot]
                    assert_close(logits[0], got_l[step, slot], rtol=TOL,
                                 atol=TOL)


def test_engine_meters_and_traces_its_steps(params):
    """Tokens, prefills, step latency and refine_frac reach the engine's
    registry; prefill and each step are spans of the context tracer."""
    _, tcfg = _configs(agg_kv=True, agg_layout="flat", agg_compression=4)
    ticks = iter(range(1000))
    reg = MetricsRegistry()
    eng = DecodeEngine(params[1], tcfg, max_slots=3, s_max=16, registry=reg,
                       clock=lambda: float(next(ticks)),
                       generator=torch.Generator().manual_seed(0))
    tracer = Tracer(clock=lambda: 0.0)
    with use_tracer(tracer):
        pf = eng.prefill([3, 1, 4])
        eng.insert(pf, 0)
        eng.insert(pf, 2)
        for _ in range(3):
            eng.generate_step(0.25)
    assert reg.get("lm_decode_tokens_total").value == 6   # 2 live slots
    assert reg.get("lm_prefill_total").value == 1
    assert reg.get("lm_decode_refine_frac").value == 0.25
    steps, = [e for e in reg.snapshot()["reservoirs"]
              if e["name"] == "lm_decode_step_latency_s"]
    assert steps["count"] == 3 and steps["min"] == steps["max"] == 1.0
    names = [sp.name for sp in tracer.traces()]
    assert names == ["decode.prefill"] + ["decode.step"] * 3
    assert tracer.traces()[1].attrs == {"refine_frac": 0.25, "live": 2}
    assert eng.live_slots == [0, 2] and eng.free_slots == [1]
    with pytest.raises(ValueError, match="live"):
        eng.insert(pf, 2)


def test_engine_needs_aggregated_caches(params):
    _, tcfg = _configs(agg_kv=False)
    with pytest.raises(ValueError, match="agg_kv"):
        DecodeEngine(params[1], tcfg, max_slots=1, s_max=8)


def test_bucket_shard_plan():
    plan = BucketShardPlan(n_buckets=10, n_shards=3)
    assert list(plan.buckets_of(0)) == [0, 3, 6, 9]
    keep = plan.keep_mask({0})
    assert keep.sum() == 6
    assert not keep[0] and not keep[9] and keep[1]
