"""The port's LSH, aggregation, ranking, refinement selection, engine and
data generator against the JAX package's, on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import assert_close, normal, np_of, rng, th
from repro.core import aggregate as jagg
from repro.core import correlation as jcorr
from repro.core import engine as jengine
from repro.core import lsh as _jlsh
from repro.core import refine as jrefine
from repro.data.synthetic import make_mfeat_like as jmake_mfeat_like
from repro.data.synthetic import make_netflix_like as jmake_netflix_like
from repro_torch import convert
from repro_torch.core import aggregate as agg
from repro_torch.core import correlation as corr
from repro_torch.core import engine
from repro_torch.core import lsh
from repro_torch.core import refine
from repro_torch.data.synthetic import (
    holdout_split, make_mfeat_like, make_netflix_like,
)
from repro_torch.obs.trace import Tracer, current_tracer, use_tracer

jx = jnp.asarray


class jlsh:
    """The reference's LSH, its array functions jitted (one compile per
    shape instead of one per operation)."""
    LSHConfig, LSHParams = _jlsh.LSHConfig, _jlsh.LSHParams
    init_lsh, nested_config = _jlsh.init_lsh, _jlsh.nested_config
    config_for_compression = _jlsh.config_for_compression
    SIGNATURE_PRIMES = _jlsh._SIGNATURE_PRIMES
    raw_hashes = jax.jit(_jlsh.raw_hashes)
    fine_bucket_ids = jax.jit(_jlsh.fine_bucket_ids)
    bucket_ids = jax.jit(_jlsh.bucket_ids)


def _params(seed, n_features, cfg):
    """The reference's draw, and the same numbers as the port's params."""
    jp = jlsh.init_lsh(jax.random.PRNGKey(seed), n_features, cfg)
    tp = convert.lsh_params_from_numpy(
        np.asarray(jp.a), np.asarray(jp.b), n_hashes=cfg.n_hashes,
        bucket_width=cfg.bucket_width, n_buckets=cfg.n_buckets,
        base_buckets=cfg.base_buckets, device="cpu")
    return jp, tp


def _border_rows(x, jp):
    """Rows whose projection lies so near a bucket border that float32
    summation order alone can flip floor(proj / w)."""
    a, b = np.asarray(jp.a, np.float64), np.asarray(jp.b, np.float64)
    w = jp.config.bucket_width
    proj = (x.astype(np.float64) @ a + b) / w
    scale = (np.abs(x.astype(np.float64)) @ np.abs(a) + np.abs(b)) / w
    return (np.abs(proj - np.round(proj)) < 1e-5 * scale + 1e-6).any(axis=1)


@pytest.mark.parametrize("n,d,h", [(300, 24, 4), (500, 217, 4), (400, 16, 12),
                                   (64, 8, 1)])
def test_bucket_ids_parity(n, d, h):
    """Reference-drawn projections: equal hashes and ids away from borders."""
    x = normal(rng(n + d + h), n, d) * 2
    cfg = jlsh.LSHConfig(n_hashes=h, bucket_width=4.0, n_buckets=97)
    jp, tp = _params(n * h, d, cfg)
    border = _border_rows(x, jp)
    assert border.sum() <= max(1, n // 50)
    raw = np_of(lsh.raw_hashes(th(x), tp))
    np.testing.assert_array_equal(
        raw[~border], np.asarray(jlsh.raw_hashes(jx(x), jp))[~border])
    ids = np_of(lsh.bucket_ids(th(x), tp))
    np.testing.assert_array_equal(
        ids[~border], np.asarray(jlsh.bucket_ids(jx(x), jp))[~border])
    assert ids.dtype == np.int32 and ((ids >= 0) & (ids < 97)).all()


@pytest.mark.parametrize("h,scale,signs", [
    (4, 1, "negative"),       # every hash negative: uint32(h) wraps
    (12, 20000, "mixed"),     # hashes of either sign far beyond 2^16
    (3, 20000, "negative"),
    (1, 5, "mixed"),
])
def test_signature_wraps_like_uint32(h, scale, signs):
    """Integer data and projections (|proj| < 2^24), so both sides hash
    exactly alike: the signature sum_j uint32(h_j) * prime_j wraps at 2^32
    for hashes of any sign."""
    r = rng(h * 7 + scale)
    if signs == "negative":
        x = r.integers(1, 4, (300, 10)) * scale
        a = -r.integers(1, 4, (10, h))
    else:
        x = r.integers(-3, 4, (300, 10)) * scale
        a = r.integers(-3, 4, (10, h))
    x, a = x.astype(np.float32), a.astype(np.float32)
    b = np.full(h, 0.5, np.float32)      # proj / w is never an integer
    cfg = jlsh.LSHConfig(n_hashes=h, bucket_width=4.0, n_buckets=1009)
    jp = jlsh.LSHParams(a=jx(a), b=jx(b), config=cfg)
    tp = convert.lsh_params_from_numpy(a, b, n_hashes=h, bucket_width=4.0,
                                       n_buckets=1009, device="cpu")
    raw = np_of(lsh.raw_hashes(th(x), tp))
    np.testing.assert_array_equal(raw, np.asarray(jlsh.raw_hashes(jx(x), jp)))
    if signs == "negative":
        assert (raw < 0).all()
    if scale > 100:
        assert (np.abs(raw) > 2 ** 16).any()
    ids = np_of(lsh.bucket_ids(th(x), tp))
    np.testing.assert_array_equal(ids, np.asarray(jlsh.bucket_ids(jx(x), jp)))
    primes = np.array(jlsh.SIGNATURE_PRIMES[:h], np.uint32)
    sig = (raw.astype(np.uint32) * primes).sum(axis=1, dtype=np.uint32)
    np.testing.assert_array_equal(ids, (sig % np.uint32(1009)).astype(np.int32))


@pytest.mark.parametrize("base,n_buckets", [(256, 32), (96, 96), (120, 8)])
def test_nested_bucket_ids_parity(base, n_buckets):
    x = normal(rng(base), 400, 20) * 2
    cfg = jlsh.nested_config(base, n_buckets)
    jp, tp = _params(base + n_buckets, 20, cfg)
    border = _border_rows(x, jp)
    fine = np_of(lsh.fine_bucket_ids(th(x), tp))
    np.testing.assert_array_equal(
        fine[~border], np.asarray(jlsh.fine_bucket_ids(jx(x), jp))[~border])
    ids = np_of(lsh.bucket_ids(th(x), tp))
    np.testing.assert_array_equal(ids, fine // (base // n_buckets))
    np.testing.assert_array_equal(
        ids[~border], np.asarray(jlsh.bucket_ids(jx(x), jp))[~border])


@pytest.mark.parametrize("h,nest", [(4, None), (1, None), (12, None),
                                    (4, 4), (12, 16)])
def test_bucket_ids_cpu_bits_unchanged(h, nest):
    """On a CPU tensor core/lsh.py goes through ops to the plain versions:
    the same bits as its own product, floor and int64 signature gave before
    the LSH step ran on the kernel."""
    from repro_torch.core.signature import wrapped_signature

    x = th(normal(rng(h + (nest or 0)), 500, 217) * 3)
    cfg = lsh.LSHConfig(n_hashes=h, bucket_width=4.0, n_buckets=97,
                        base_buckets=nest and nest * 97)
    p = lsh.init_lsh(torch.Generator().manual_seed(h), 217, cfg,
                     device="cpu")
    raw = torch.floor((x @ p.a + p.b[None, :]) / 4.0).to(torch.int32)
    fine = (wrapped_signature(raw) % ((nest or 1) * 97)).to(torch.int32)
    ids = fine if nest is None else fine // nest
    assert torch.equal(lsh.raw_hashes(x, p), raw)
    assert torch.equal(lsh.fine_bucket_ids(x, p), fine)
    assert torch.equal(lsh.bucket_ids(x, p), ids)


@pytest.mark.parametrize("kwargs,message", [
    ({"n_buckets": 64, "base_buckets": 32}, "base_buckets=32 < n_buckets=64"),
    ({"n_buckets": 64, "base_buckets": 96}, "divide"),
])
def test_lsh_config_validation(kwargs, message):
    for config in (lsh.LSHConfig, jlsh.LSHConfig):
        with pytest.raises(ValueError, match=message):
            config(**kwargs)


@pytest.mark.parametrize("n,ratio", [(1000, 100.0), (287_500, 100.0),
                                     (50, 1000.0), (12_345, 7.5)])
def test_config_for_compression_parity(n, ratio):
    got = lsh.config_for_compression(n, ratio, n_hashes=3, bucket_width=2.0)
    want = jlsh.config_for_compression(n, ratio, n_hashes=3, bucket_width=2.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_init_lsh_draws_from_the_generator():
    cfg = lsh.LSHConfig(n_hashes=5, bucket_width=3.0, n_buckets=10)
    p1 = lsh.init_lsh(torch.Generator().manual_seed(4), 30, cfg, device="cpu")
    p2 = lsh.init_lsh(torch.Generator().manual_seed(4), 30, cfg, device="cpu")
    assert torch.equal(p1.a, p2.a) and torch.equal(p1.b, p2.b)
    assert p1.a.shape == (30, 5) and p1.b.shape == (5,)
    assert ((p1.b >= 0) & (p1.b < 3.0)).all() and p1.config == cfg


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def _bucketed(seed, n, d, k, empty=()):
    r = rng(seed)
    live = np.setdiff1d(np.arange(k), empty)
    ids = r.choice(live, n).astype(np.int32)
    return normal(r, n, d), ids


@pytest.mark.parametrize("n,d,k", [(1, 3, 1), (500, 24, 37), (2000, 217, 20)])
def test_aggregate_by_bucket_parity(n, d, k):
    x, ids = _bucketed(n + k, n, d, k, empty=(0, k // 2) if k > 2 else ())
    got = agg.aggregate_by_bucket(th(x), th(ids), k)
    want = jagg.aggregate_by_bucket(jx(x), jx(ids), k)
    for name in ("counts", "perm", "offsets", "bucket_of"):
        g, w = np_of(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert_close(got.means, want.means, rtol=1e-6, atol=1e-6)
    assert float(got.realized_compression()) == pytest.approx(
        float(want.realized_compression()))
    assert got.n_buckets == k and got.n_points == n


def test_second_moments_parity_with_empty_buckets():
    k, n_classes = 12, 4
    x, ids = _bucketed(7, 300, 10, k, empty=(3, 11))
    labels = rng(8).integers(0, n_classes, 300).astype(np.int32)
    sums = agg.segment_sum(th(x), th(ids), k)
    sumsq = agg.bucket_sumsq(th(x), th(ids), k)
    want_sums = jax.ops.segment_sum(jx(x), jx(ids), num_segments=k)
    want_sumsq = jagg.bucket_sumsq(jx(x), jx(ids), k)
    assert_close(sums, want_sums, rtol=1e-5, atol=1e-5)
    assert_close(sumsq, want_sumsq, rtol=1e-5, atol=1e-5)
    counts = torch.bincount(th(ids).long(), minlength=k).to(torch.int32)
    spread = np_of(agg.bucket_spread(sums, sumsq, counts))
    want = np.asarray(jagg.bucket_spread(want_sums, want_sumsq,
                                         jx(np_of(counts))))
    assert np.isinf(spread[[3, 11]]).all() and np.isfinite(np.delete(
        spread, [3, 11])).all()
    assert_close(spread, want, rtol=1e-4, atol=1e-4)
    hist = np.zeros((k, n_classes), np.float32)
    np.add.at(hist, (ids, labels), 1.0)
    disp = np_of(agg.histogram_dispersion(th(hist)))
    np.testing.assert_array_equal(
        disp, np.asarray(jagg.histogram_dispersion(jx(hist))))
    assert np.isinf(disp[[3, 11]]).all()


def test_aggregate_with_moments_matches_separate_sums():
    k = 12
    x, ids = _bucketed(11, 300, 10, k, empty=(3, 11))
    got, sums, sumsq = agg.aggregate_with_moments(th(x), th(ids), k)
    want = agg.aggregate_by_bucket(th(x), th(ids), k)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name
    assert torch.equal(sums, agg.segment_sum(th(x), th(ids), k))
    assert torch.equal(sumsq, agg.bucket_sumsq(th(x), th(ids), k))
    assert_close(sumsq, jagg.bucket_sumsq(jx(x), jx(ids), k),
                 rtol=1e-5, atol=1e-5)


def test_segment_sum_is_the_same_on_every_run():
    x, ids = _bucketed(9, 4000, 33, 50)
    one = agg.segment_sum(th(x), th(ids), 50)
    two = agg.segment_sum(th(x), th(ids), 50)
    assert torch.equal(one, two)
    want = np.zeros((50, 33), np.float64)
    np.add.at(want, ids, x.astype(np.float64))
    assert_close(one, want, rtol=1e-5, atol=1e-5)


def test_segment_sums_share_one_sort():
    """Several arrays summed from one sort: each equals its own segment_sum,
    and the order and counts are those of aggregate_by_bucket."""
    k = 12
    x, ids = _bucketed(13, 300, 10, k, empty=(0, 5))
    y = normal(rng(14), 300, 4)
    order, counts, (sx, sy) = agg.segment_sums((th(x), th(y)), th(ids), k)
    assert torch.equal(sx, agg.segment_sum(th(x), th(ids), k))
    assert torch.equal(sy, agg.segment_sum(th(y), th(ids), k))
    ref = agg.aggregate_by_bucket(th(x), th(ids), k)
    assert torch.equal(order.to(torch.int32), ref.perm)
    assert torch.equal(counts.to(torch.int32), ref.counts)
    assert torch.equal(agg.bucket_offsets(counts), ref.offsets)
    assert_close(sy, jax.ops.segment_sum(jx(y), jx(ids), num_segments=k),
                 rtol=1e-5, atol=1e-5)


def test_centered_second_moment_parity():
    r = rng(15)
    x = normal(r, 200, 9) * 2 + 3
    ids = r.integers(0, 8, 200).astype(np.int32)
    ids[ids == 6] = 7                                  # bucket 6 is empty
    mask = (r.random((200, 9)) < 0.5).astype(np.float32)
    s, s2, c = (np.asarray(jax.ops.segment_sum(jx(v), jx(ids),
                                               num_segments=8))
                for v in (x * mask, x * x * mask, mask))
    got = np_of(agg.centered_second_moment(th(s), th(s2), th(c)))
    assert_close(got, jagg.centered_second_moment(jx(s), jx(s2), jx(c)),
                 rtol=1e-5, atol=1e-5)
    assert (got >= 0).all() and (got[6] == 0).all()


# ---------------------------------------------------------------------------
# ranking and refinement selection, batched over queries
# ---------------------------------------------------------------------------

def _ranked_agg(seed, n=240, d=6, k=30):
    x, ids = _bucketed(seed, n, d, k, empty=(2, 17))
    r = rng(seed + 1)
    # correlations with exact ties, to pin the stable (lowest id first) order
    corrs = r.integers(-5, 0, (7, k)).astype(np.float32)
    return (agg.aggregate_by_bucket(th(x), th(ids), k),
            jagg.aggregate_by_bucket(jx(x), jx(ids), k), corrs)


def test_rankings_parity_with_ties():
    tagg, jaggd, corrs = _ranked_agg(3)
    got = np_of(corr.rank_buckets_multi(th(corrs), tagg.counts))
    want = np.asarray(jcorr.rank_buckets_multi(jx(corrs), jaggd.counts))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    for row in range(corrs.shape[0]):
        np.testing.assert_array_equal(
            np_of(corr.rank_buckets(th(corrs[row]), tagg.counts)), want[row])
    np.testing.assert_array_equal(
        np_of(corr.mask_empty(th(corrs[0]), tagg.counts)),
        np.asarray(jcorr.mask_empty(jx(corrs[0]), jaggd.counts)))


@pytest.mark.parametrize("budget", [1, 7, 8, 60, 239, 240, 300])
def test_refinement_indices_and_coverage_parity(budget):
    tagg, jaggd, corrs = _ranked_agg(budget)
    rankings = np.asarray(jcorr.rank_buckets_multi(jx(corrs), jaggd.counts))
    idx, valid = agg.refinement_indices(tagg, th(rankings), budget)
    covered = agg.buckets_fully_covered(tagg, th(rankings), budget)
    want_idx, want_valid = jax.jit(jax.vmap(
        lambda r: jagg.refinement_indices(jaggd, r, budget)))(jx(rankings))
    want_cov = jax.jit(jax.vmap(
        lambda r: jagg.buckets_fully_covered(jaggd, r, budget)))(jx(rankings))
    assert idx.shape == valid.shape == (7, budget) and idx.dtype == torch.int32
    np.testing.assert_array_equal(np_of(idx), np.asarray(want_idx))
    np.testing.assert_array_equal(np_of(valid), np.asarray(want_valid))
    np.testing.assert_array_equal(np_of(covered), np.asarray(want_cov))
    # one ranking row gives the row of the batch
    i1, v1 = agg.refinement_indices(tagg, th(rankings[2]), budget)
    assert torch.equal(i1, idx[2]) and torch.equal(v1, valid[2])
    assert torch.equal(
        agg.buckets_fully_covered(tagg, th(rankings[2]), budget), covered[2])


@pytest.mark.parametrize("budget", [5, 100])
def test_select_refinement_parity(budget):
    tagg, jaggd, corrs = _ranked_agg(11)
    got = refine.select_refinement(tagg, th(corrs[0]), budget)
    want = jrefine.select_refinement(jaggd, jx(corrs[0]), budget)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(np_of(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("n,eps", [(1000, 0.0), (1000, 0.01), (287_500, 0.01),
                                   (7, 0.5), (333, 1.0), (10, -0.1)])
def test_eps_to_budget_parity(n, eps):
    got = refine.eps_to_budget(n, eps)
    assert isinstance(got, int) and got == jrefine.eps_to_budget(n, eps)


# ---------------------------------------------------------------------------
# map/reduce engine (mesh=None)
# ---------------------------------------------------------------------------

def _map_fn(x, y, q):
    d = (x[:, None, :] - q[None, :, :]).sum(-1)                   # [N, Q]
    return {"s": d.sum(0), "y": y[:3] * 2, "q": q[:2]}


@pytest.mark.parametrize("mode", ["all_gather", "psum", "identity"])
def test_mapreduce_shuffle_bytes_and_outputs(mode):
    r = rng(2)
    x, q = normal(r, 40, 5), normal(r, 6, 5)
    y = r.integers(0, 3, 40).astype(np.int32)
    reduce_fn = None if mode == "identity" else (lambda o: o)
    mr = engine.MapReduce(mesh=None)
    got = mr.run(_map_fn, engine.CombineSpec(mode, reduce_fn),
                 th(x), th(y), replicated_args=(th(q),))
    jmr = jengine.MapReduce(mesh=None)
    want = jmr.run(_map_fn, jengine.CombineSpec(mode, reduce_fn),
                   jx(x), jx(y), replicated_args=(jx(q),))
    assert mr.last_shuffle_bytes == jmr.last_shuffle_bytes
    assert (mr.last_shuffle_bytes == 0) == (mode == "identity")
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)


def test_mapreduce_spans_under_a_tracer():
    ticks = iter(range(100))
    tracer = Tracer(clock=lambda: float(next(ticks)))
    assert not current_tracer().enabled
    mr = engine.MapReduce()
    with use_tracer(tracer):
        assert current_tracer() is tracer
        out = mr.run(lambda a: (a * 2,),
                     engine.CombineSpec("all_gather", lambda g: g[0].sum(0)),
                     th(np.ones((3, 2), np.float32)))
    assert torch.equal(out, torch.full((3, 2), 2.0))
    (root,) = tracer.traces()
    assert [s.name for s in root.walk()] == ["mapreduce", "map.shard",
                                            "reduce"]
    assert root.attrs["shuffle_bytes"] == 24 == mr.last_shuffle_bytes
    assert root.find("map.shard")[0].attrs == {"shard": 0,
                                               "shuffle_bytes": 24}


class _Mesh:
    """A stand-in for a (4,) ``data`` DeviceMesh: the engine reads its
    axis before any collective."""

    mesh_dim_names = ("data",)
    shape = (4,)

    def get_group(self, axis):
        return None

    def get_local_rank(self, dim):
        return 0


def test_mapreduce_refuses_a_mesh():
    """A mesh whose axis does not divide a sharded argument's leading
    dimension is refused, as ``shard_map`` refuses it (the mesh path
    itself: tests/test_torch_parallel.py)."""
    eng = engine.MapReduce(mesh=_Mesh())
    assert eng.mesh is not None and eng.axis == "data"
    with pytest.raises(ValueError, match="does not divide by the 'data'"):
        eng.run(lambda a: a, engine.CombineSpec("psum"), torch.zeros(6, 2))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_make_mfeat_like_is_seeded_and_shaped():
    kw = dict(n_points=500, n_features=17, n_classes=4, modes_per_class=3,
              device="cpu")
    x1, y1 = make_mfeat_like(torch.Generator().manual_seed(3), **kw)
    x2, y2 = make_mfeat_like(torch.Generator().manual_seed(3), **kw)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert x1.shape == (500, 17) and x1.dtype == torch.float32
    assert y1.shape == (500,) and y1.dtype == torch.int32
    assert set(y1.tolist()) == {0, 1, 2, 3}
    # the same mixture as the reference, drawn with other bits
    jx1, _ = jmake_mfeat_like(jax.random.PRNGKey(3), n_points=500,
                              n_features=17, n_classes=4, modes_per_class=3)
    assert float(x1.std()) == pytest.approx(float(jnp.std(jx1)), rel=0.15)


def test_make_netflix_like_is_seeded_and_shaped():
    kw = dict(n_users=400, n_items=150, density=0.1, device="cpu")
    r1, m1 = make_netflix_like(torch.Generator().manual_seed(3), **kw)
    r2, m2 = make_netflix_like(torch.Generator().manual_seed(3), **kw)
    assert torch.equal(r1, r2) and torch.equal(m1, m2)
    assert r1.shape == m1.shape == (400, 150)
    assert r1.dtype == m1.dtype == torch.float32
    rated = np_of(r1)[np_of(m1) == 1]
    assert set(np.unique(rated)) <= {1.0, 2.0, 3.0, 4.0, 5.0}
    assert (np_of(r1)[np_of(m1) == 0] == 0).all()
    assert set(np.unique(np_of(m1))) == {0.0, 1.0}
    # the same distribution as the reference, drawn with other bits: mean
    # density, the Zipf head more rated than the tail, the star mean
    jr, jm = jmake_netflix_like(jax.random.PRNGKey(3), n_users=400,
                                n_items=150, density=0.1)
    jr, jm = np.asarray(jr), np.asarray(jm)
    assert float(m1.mean()) == pytest.approx(jm.mean(), rel=0.1)
    assert float(m1.mean()) == pytest.approx(0.1, rel=0.1)
    assert np_of(m1)[:, :10].mean() > 3 * np_of(m1)[:, -50:].mean()
    assert rated.mean() == pytest.approx(jr[jm == 1].mean(), abs=0.15)


def test_holdout_split_partitions_the_mask():
    _, m = make_netflix_like(torch.Generator().manual_seed(4), n_users=300,
                             n_items=100, density=0.2, device="cpu")
    train, test = holdout_split(torch.Generator().manual_seed(5), m, 0.2,
                                device="cpu")
    assert torch.equal(train + test, m)
    assert not bool((train * test).any())
    assert float(test.sum() / m.sum()) == pytest.approx(0.2, abs=0.03)
    again = holdout_split(torch.Generator().manual_seed(5), m, 0.2,
                          device="cpu")
    assert torch.equal(again[1], test)
