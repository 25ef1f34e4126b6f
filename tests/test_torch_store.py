"""The port's aggregate store (``repro_torch.store``), its nested LSH ids
and the kNN and CF servables that read it: every scenario of
``tests/test_store.py`` replayed on the port, then parity with the JAX
package on the same numpy inputs and the reference's LSH draws."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import (
    assert_close, assert_topk_match, normal, np_of, rng, th,
)
from repro.apps import cf as jcf
from repro.apps import knn as jknn
from repro.core import aggregate as jagg
from repro.core import lsh as jlsh
from repro.store import AggregateStore as JAggregateStore
from repro_torch import convert
from repro_torch.apps import cf, knn
from repro_torch.apps.cf import CFServable
from repro_torch.apps.knn import KNNServable
from repro_torch.core import aggregate as agg_lib
from repro_torch.core import lsh as lsh_lib
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.serve import servable as servable_lib
from repro_torch.serve.request import ErrorBound
from repro_torch.store import (
    AggregateStore, PyramidSpec, SOURCE_BUILT, SOURCE_MEMORY, SOURCE_MERGED,
    SOURCE_RESTORED, StreamingAggregate,
)

N, D, C = 384, 8, 5
CF_TOL = 2e-4          # tests/test_kernels.py: CF weights and sums

jx = jnp.asarray


def _knn_data(seed=0, n=N):
    r = rng(seed)
    return normal(r, n, D), r.integers(0, C, n).astype(np.int32)


def _draws(seed, n_features, n_hashes=4, width=4.0):
    """The reference's LSH draw for a PRNG key (independent of the bucket
    count), as numpy: what its servables hash with."""
    cfg = jlsh.LSHConfig(n_hashes=n_hashes, bucket_width=width)
    p = jlsh.init_lsh(jax.random.PRNGKey(seed), n_features, cfg)
    return np.asarray(p.a), np.asarray(p.b)


@pytest.fixture(scope="module")
def knn_pair():
    """Two independent servables over identical data and draws: one builds
    each ratio cold, the other reuses its pyramid."""
    x, y = _knn_data()

    def make(**kw):
        return KNNServable(x, y, n_classes=C, k=3,
                           lsh_generator=torch.Generator().manual_seed(7),
                           device="cpu", **kw)

    return make


def _cf_data(seed=5, users=128, items=24):
    r = rng(seed)
    m = (r.random((users, items)) < 0.3).astype(np.float32)
    x = (r.random((users, items)) * 4 + 1).astype(np.float32) * m
    return x, m


def _make_cf(x, m, **kw):
    return CFServable(x, m, lsh_generator=torch.Generator().manual_seed(8),
                      device="cpu", **kw)


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(np_of(a), np_of(b), err_msg=msg)


# ---------------------------------------------------------------------------
# pyramid spec / quantization
# ---------------------------------------------------------------------------

def test_spec_grid_shape():
    spec = PyramidSpec.for_points(16_384, branch=2, finest_ratio=4.0)
    assert spec.base_buckets == 4096
    assert spec.n_buckets(0) == 4096 and spec.n_buckets(2) == 1024
    assert spec.ratio(0) == 4.0
    for lvl in range(spec.n_levels - 1):
        assert spec.n_buckets(lvl) == 2 * spec.n_buckets(lvl + 1)


@pytest.mark.parametrize("drift", [1e-9, -1e-9, 1e-7])
def test_spec_ratio_quantization_is_drift_proof(drift):
    spec = PyramidSpec.for_points(10_000)
    assert spec.quantize_ratio(20.0 * (1 + drift)) == spec.quantize_ratio(20.0)
    assert spec.quantize_ratio(200.0) > spec.quantize_ratio(10.0)


def test_spec_clamps_out_of_range_ratios():
    spec = PyramidSpec.for_points(1000, finest_ratio=4.0)
    assert spec.level_for_ratio(0.001) == 0
    assert spec.level_for_ratio(1e12) == spec.n_levels - 1


@pytest.mark.parametrize("n", [1, 100, 10_000, 287_500, 6_002])
def test_spec_equals_the_reference(n):
    from repro.store import PyramidSpec as JSpec

    got, want = PyramidSpec.for_points(n), JSpec.for_points(n)
    assert (got.base_buckets, got.n_levels) == (want.base_buckets,
                                                want.n_levels)
    for ratio in (0.5, 4.0, 20.0, 100.0, 400.0, 1e6):
        assert got.level_for_ratio(ratio) == want.level_for_ratio(ratio)


def test_spec_at_the_jobs_shard_sizes():
    """The kNN and CF jobs' shards: 287,500 points over 131,072 base
    buckets in 9 levels; 6,002 users over 2,048."""
    knn_spec = PyramidSpec.for_points(287_500)
    assert (knn_spec.base_buckets, knn_spec.n_levels) == (131_072, 9)
    assert knn_spec.n_buckets(knn_spec.level_for_ratio(100.0)) == 2048
    assert knn_spec.n_buckets(knn_spec.level_for_ratio(400.0)) == 512
    assert knn_spec.n_buckets(knn_spec.level_for_ratio(25.0)) == 8192
    cf_spec = PyramidSpec.for_points(6_002)
    assert cf_spec.base_buckets == 2048
    assert cf_spec.n_buckets(cf_spec.level_for_ratio(20.0)) == 256
    assert cf_spec.n_buckets(cf_spec.level_for_ratio(80.0)) == 64


# ---------------------------------------------------------------------------
# nested LSH ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_coarse", [32, 16, 4])
def test_nested_ids_are_prefix_merges(k_coarse):
    """Every coarse id equals fine_id // factor: the exactness precondition
    of the whole pyramid."""
    data = th(normal(rng(3), 200, D))
    cfg = lsh_lib.nested_config(64, k_coarse)
    params = lsh_lib.fit(torch.Generator().manual_seed(9), D, cfg,
                         device="cpu")
    fine = np_of(lsh_lib.fine_bucket_ids(data, params))
    coarse = np_of(lsh_lib.bucket_ids(data, params))
    np.testing.assert_array_equal(coarse, fine // (64 // k_coarse))
    assert coarse.min() >= 0 and coarse.max() < k_coarse
    assert fine.max() < 64 and (fine >= k_coarse).any()


@pytest.mark.parametrize("n_buckets,base", [(48, 64), (128, 64)])
def test_nested_config_validation(n_buckets, base):
    with pytest.raises(ValueError):
        lsh_lib.LSHConfig(n_buckets=n_buckets, base_buckets=base)
    with pytest.raises(ValueError):
        lsh_lib.nested_config(base, n_buckets)


def test_nested_build_matches_flat_semantics():
    """aggregate_nested agrees with aggregate_by_bucket over the coarse
    ids: same buckets, same members, means to fp tolerance."""
    data = th(normal(rng(4), 300, D))
    cfg = lsh_lib.nested_config(64, 16)
    params = lsh_lib.init_lsh(torch.Generator().manual_seed(2), D, cfg,
                              device="cpu")
    nested = agg_lib.build_aggregates(data, params)
    coarse_ids = lsh_lib.bucket_ids(data, params)
    flat = agg_lib.aggregate_by_bucket(data, coarse_ids, 16)
    _equal(nested.counts, flat.counts)
    assert_close(nested.means, flat.means, rtol=1e-5, atol=1e-5)
    _equal(nested.offsets, flat.offsets)
    _equal(nested.bucket_of, coarse_ids)
    assert nested.counts.dtype == nested.offsets.dtype == torch.int32
    off, perm, bo = np_of(nested.offsets), np_of(nested.perm), np_of(
        coarse_ids)
    for b in range(16):
        assert (bo[perm[off[b]:off[b + 1]]] == b).all()


def test_build_aggregates_flat_config_is_aggregate_by_bucket():
    data = th(normal(rng(6), 120, D))
    params = lsh_lib.init_lsh(torch.Generator().manual_seed(3), D,
                              lsh_lib.LSHConfig(n_buckets=16), device="cpu")
    got = agg_lib.build_aggregates(data, params)
    want = agg_lib.aggregate_by_bucket(
        data, lsh_lib.bucket_ids(data, params), 16)
    for f in ("means", "counts", "perm", "offsets", "bucket_of"):
        _equal(getattr(got, f), getattr(want, f), f)


# ---------------------------------------------------------------------------
# coarsening exactness
# ---------------------------------------------------------------------------

def test_coarsen_bit_identical_to_cold_build(knn_pair):
    """Merging a cached level 0 down to any coarser supported ratio gives
    the same bits as building that ratio on a cold store."""
    cold = knn_pair()
    warm = knn_pair()
    warm.store.get(warm, warm.pyramid_spec.ratio(0))
    for level in range(1, warm.pyramid_spec.n_levels):
        ratio = warm.pyramid_spec.ratio(level)
        built, src_cold = AggregateStore().get(cold, ratio)
        merged, src_warm = warm.store.get(warm, ratio)
        assert src_cold == SOURCE_BUILT and src_warm == SOURCE_MERGED
        for f in ("counts", "means", "perm", "offsets", "bucket_of"):
            _equal(getattr(built.agg, f), getattr(merged.agg, f), f)
        _equal(built.bucket_labels, merged.bucket_labels)


def test_coarsen_bit_identical_for_cf():
    x, m = _cf_data()
    warm = _make_cf(x, m)
    warm.store.get(warm, warm.pyramid_spec.ratio(0))
    for level in (1, warm.pyramid_spec.n_levels - 1):
        ratio = warm.pyramid_spec.ratio(level)
        built, _ = AggregateStore().get(_make_cf(x, m), ratio)
        merged, src = warm.store.get(warm, ratio)
        assert src == SOURCE_MERGED
        for field in ("profile", "profile_mask", "s", "c", "cvar"):
            _equal(getattr(built, field), getattr(merged, field), field)


def test_second_moments_survive_merge_and_snapshot(knn_pair, tmp_path):
    """Spread and dispersion of a merged or restored level equal the cold
    build's to the bit; populated buckets are finite, empty ones +inf."""
    cold = knn_pair()
    warm = knn_pair()
    warm.store.get(warm, warm.pyramid_spec.ratio(0))
    for level in (1, warm.pyramid_spec.n_levels - 1):
        ratio = warm.pyramid_spec.ratio(level)
        built, _ = AggregateStore().get(cold, ratio)
        merged, src = warm.store.get(warm, ratio)
        assert src == SOURCE_MERGED
        _equal(built.spread, merged.spread)
        _equal(built.dispersion, merged.dispersion)
    assert warm.store.save(tmp_path / "snap") == 1
    dst = knn_pair()
    assert dst.store.restore(tmp_path / "snap", [dst]) == 1
    ratio0 = warm.pyramid_spec.ratio(0)
    restored, source = dst.store.get(dst, ratio0)
    assert source == SOURCE_RESTORED
    built0, _ = AggregateStore().get(knn_pair(), ratio0)
    _equal(built0.spread, restored.spread)
    _equal(built0.dispersion, restored.dispersion)
    sp, counts = np_of(restored.spread), np_of(restored.agg.counts)
    assert np.isfinite(sp[counts > 0]).all()
    assert np.isinf(sp[counts == 0]).all()


def test_assemble_without_sumsq_degrades_to_infinite_spread():
    x, y = _knn_data()
    params = lsh_lib.init_lsh(torch.Generator().manual_seed(7), D,
                              lsh_lib.LSHConfig(n_buckets=32), device="cpu")
    ids = lsh_lib.bucket_ids(th(x), params)
    stats = dict(knn.knn_mergeable_stats(th(x), th(y), ids, 32, C))
    del stats["sumsq"]
    old = knn.knn_assemble(stats, agg_lib.bucket_index(ids, 32))
    assert torch.isinf(old.spread).all()


def test_assemble_without_sr2_saturates_to_finite_big():
    x, m = _cf_data()
    ids = th(rng(1).integers(0, 16, x.shape[0]).astype(np.int32))
    stats = dict(cf.cf_mergeable_stats(th(x), th(m), ids, 16))
    del stats["sr2"]
    old = cf.cf_assemble(stats, agg_lib.bucket_index(ids, 16))
    assert torch.isfinite(old.cvar).all()
    assert bool((old.cvar == knn.BIG).all())


def test_store_sources_and_memoization(knn_pair):
    s = knn_pair()
    sources = [s.store.get(s, r)[1] for r in (8.0, 8.0, 32.0, 32.0)]
    assert sources == [SOURCE_BUILT, SOURCE_MEMORY, SOURCE_MERGED,
                       SOURCE_MEMORY]
    stats = s.store.stats()
    assert stats["builds"] == 1 and stats["merges"] == 1
    assert stats["memory_hits"] == 2 and stats["pyramids"] == 1
    assert stats["restores"] == 0
    # level 0: sums, sumsq [K, D] f32, label_hist [K, C] f32, counts [K]
    # int32; index: perm and bucket_of [N], offsets [K+1], all int32
    k = s.pyramid_spec.base_buckets
    assert stats["resident_bytes"] == 4 * (k * (2 * D + C + 1) + 2 * N
                                           + k + 1)


def test_store_get_emits_a_trace_event(knn_pair):
    s = knn_pair()
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    tracer = Tracer(clock=clock)
    with use_tracer(tracer):
        s.store.get(s, 8.0)
        s.store.get(s, 32.0)
    events = [sp for root in tracer.traces() for sp in root.walk()
              if sp.name == "store.get"]
    assert [e.attrs["source"] for e in events] == [SOURCE_BUILT,
                                                   SOURCE_MERGED]
    assert all(e.duration_s == 0.0 and e.attrs["kind"] == "knn"
               for e in events)
    with tracer.span("outer"):
        tracer.add_span("wait", 1.0, 3.5, rid=4)
    outer = tracer.traces()[-1]
    assert [c.name for c in outer.children] == ["wait"]
    assert outer.children[0].duration_s == 2.5
    assert outer.children[0].attrs == {"rid": 4}


# (seed, n, levels) of the merge property, as the reference's hypothesis
# examples draw them: seeds in [0, 1000], n in [8, 200], levels in [1, 4]
MERGE_CASES = [(0, 8, 1), (1, 200, 4), (17, 57, 2), (123, 199, 3),
               (999, 8, 4), (500, 100, 1), (42, 33, 3), (7, 150, 2),
               (256, 64, 4), (800, 13, 1), (333, 121, 2), (64, 90, 3)]


@pytest.mark.parametrize("seed,n,levels", MERGE_CASES)
def test_merge_preserves_counts_and_weighted_means(seed, n, levels):
    """Merging levels preserves total counts and weighted means exactly
    (integer features: every sum is exact in fp32, so bit equality)."""
    r = rng(seed)
    base = 2 ** (levels + 2)
    data = th(r.integers(-8, 8, (n, 4)).astype(np.float32))
    ids = th(r.integers(0, base, n).astype(np.int32))
    counts = torch.bincount(ids.long(), minlength=base).to(torch.int32)
    sums = agg_lib.segment_sum(data, ids, base)
    factor = 2 ** levels
    counts_m = agg_lib.merge_levels(counts, factor)
    sums_m = agg_lib.merge_levels(sums, factor)
    assert counts_m.dtype == torch.int32 and sums_m.dtype == torch.float32
    assert int(counts_m.sum()) == n
    _equal(sums_m.sum(0), sums.sum(0))
    coarse = torch.div(ids, factor, rounding_mode="floor")
    counts_d = torch.bincount(coarse.long(), minlength=base // factor)
    sums_d = agg_lib.segment_sum(data, coarse, base // factor)
    _equal(counts_m, counts_d)
    _equal(sums_m, sums_d)
    _equal(sums_m / torch.clamp_min(counts_m[:, None].float(), 1),
           sums_d / torch.clamp_min(counts_d[:, None].float(), 1))


def test_merge_levels_refuses_a_factor_that_does_not_divide():
    with pytest.raises(ValueError):
        agg_lib.merge_levels(torch.zeros(12), 8)
    with pytest.raises(ValueError):
        agg_lib.coarsen_index(agg_lib.bucket_index(
            torch.zeros(5, dtype=torch.int32), 12), 8)


def test_coarsen_index_remaps_exactly():
    ids = th(np.random.RandomState(0).randint(0, 16, size=120)
             .astype(np.int32))
    index = agg_lib.bucket_index(ids, 16)
    coarse = agg_lib.coarsen_index(index, 4)
    assert coarse.n_buckets == 4
    _equal(coarse.perm, index.perm)
    _equal(coarse.bucket_of, np_of(ids) // 4)
    assert coarse.bucket_of.dtype == coarse.offsets.dtype == torch.int32
    off, perm, bo = np_of(coarse.offsets), np_of(coarse.perm), np_of(ids) // 4
    assert off[0] == 0 and off[-1] == 120
    for b in range(4):
        assert (bo[perm[off[b]:off[b + 1]]] == b).all()


def test_refined_bucket_mask_marks_the_first_ranked():
    agg = agg_lib.aggregate_by_bucket(th(normal(rng(2), 40, 3)),
                                      th(np.arange(40, dtype=np.int32) % 8),
                                      8)
    ranking = th(np.array([5, 2, 7, 0, 1, 3, 4, 6]))
    mask = np_of(agg_lib.refined_bucket_mask(agg, ranking, 3))
    assert sorted(np.flatnonzero(mask)) == [2, 5, 7]


# ---------------------------------------------------------------------------
# streaming ingest
# ---------------------------------------------------------------------------

def _stream(capacity=256, chunk=32, **kw):
    cfg = lsh_lib.LSHConfig(n_hashes=4, bucket_width=4.0, n_buckets=32)
    params = lsh_lib.init_lsh(torch.Generator().manual_seed(7), D, cfg,
                              device="cpu")
    return params, StreamingAggregate(params, D, capacity=capacity,
                                      chunk=chunk, device="cpu", **kw)


@pytest.mark.parametrize("batches", [((0, 60), (60, 110), (110, 150)),
                                     ((0, 32), (32, 64), (64, 150)),
                                     ((0, 1), (1, 150))])
def test_streaming_append_matches_batch_rebuild(batches):
    """Delta-updated statistics equal one-shot segment sums over all rows
    (integer rows, so the order of the sums cannot matter); short chunks'
    padding rows add nothing."""
    params, stream = _stream()
    x = th(rng(1).integers(-6, 6, (150, D)).astype(np.float32))
    for start, stop in batches:
        stream.append(x[start:stop])
    assert stream.n == 150
    ids = lsh_lib.fine_bucket_ids(x, params)
    live = stream.live_stats()
    _equal(live["counts"], torch.bincount(ids.long(), minlength=32))
    assert live["counts"].dtype == torch.int32
    _equal(live["sums"], agg_lib.segment_sum(x, ids, 32))
    _equal(stream.data(), x)
    _equal(stream.bucket_of[:150], ids)
    assert not stream.bucket_of[150:].any() and not stream.buffer[150:].any()


def test_streaming_extra_stats_and_staleness_schedule():
    _, stream = _stream(extra_shapes={"label_hist": (C,)})
    x = normal(rng(2), 120, D)
    oh = np.eye(C, dtype=np.float32)[
        np.random.RandomState(0).randint(0, C, 120)]
    stream.append(x[:80], label_hist=oh[:80])
    assert stream.stale_points == 80 and stream.needs_rebucket
    stats, index, n = stream.level0()
    assert n == 80 and stream.stale_points == 0
    assert int(stats["label_hist"].sum()) == 80

    stream.append(x[80:90], label_hist=oh[80:90])
    assert stream.stale_points == 10 and not stream.needs_rebucket
    _, _, n2 = stream.level0()          # the last consistent view
    assert n2 == 80
    assert int(stream.live_stats()["counts"].sum()) == 90
    stream.append(x[90:], label_hist=oh[90:])  # 40 stale > 25% of 80
    assert stream.needs_rebucket
    _, index, n3 = stream.level0()
    assert n3 == 120 and stream.stale_points == 0
    assert index.perm.shape == (120,) and int(index.offsets[-1]) == 120


def test_streaming_index_is_consistent_and_adoptable():
    params, stream = _stream()
    x = normal(rng(3), 100, D)
    stream.append(x)
    stats, index, n = stream.level0()
    perm, off, bo = np_of(index.perm), np_of(index.offsets), np_of(
        index.bucket_of)
    assert perm.shape == (100,) and off[-1] == 100
    for b in range(32):
        assert (bo[perm[off[b]:off[b + 1]]] == b).all()
    # the streamed index is the cold build's
    cold = agg_lib.bucket_index(lsh_lib.fine_bucket_ids(th(x), params), 32)
    for f in ("perm", "offsets", "bucket_of"):
        _equal(getattr(index, f), getattr(cold, f), f)
    # adopt into a pyramid and serve from it
    y = rng(4).integers(0, C, 100).astype(np.int32)
    spec = PyramidSpec(n_points=100, base_buckets=32, branch=2, n_levels=4)
    servable = KNNServable(stream.data(), y, n_classes=C, k=3,
                           lsh_params=(params.a, params.b),
                           pyramid_spec=spec, device="cpu")
    stats = dict(stats)
    stats["label_hist"] = knn.label_histogram(th(y), index.bucket_of, 32, C)
    servable.store.adopt(servable, stats, index)
    prepared, src = servable.store.get(servable, 8.0)
    assert src == SOURCE_MERGED
    assert int(prepared.agg.counts.sum()) == 100


def test_streaming_capacity_and_arg_validation():
    _, stream = _stream(capacity=64)
    stream.append(torch.ones((60, D)))
    with pytest.raises(ValueError):
        stream.append(torch.ones((5, D)))        # over capacity
    with pytest.raises(ValueError):
        stream.append(torch.ones((2, D)), bogus=torch.ones((2, 3)))
    assert stream.n == 60
    nested = lsh_lib.LSHParams(a=torch.zeros(D, 4), b=torch.zeros(4),
                               config=lsh_lib.nested_config(64, 32))
    with pytest.raises(ValueError):
        StreamingAggregate(nested, D, capacity=8, device="cpu")


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def test_snapshot_restore_roundtrip(knn_pair, tmp_path):
    src = knn_pair()
    built = src.build(16.0)
    assert src.store.save(tmp_path / "snap") == 1
    dst = knn_pair()
    assert dst.store.restore(tmp_path / "snap", [dst]) == 1
    restored, source = dst.store.get(dst, 16.0)
    assert source == SOURCE_RESTORED
    for f in ("means", "counts", "perm", "offsets", "bucket_of"):
        _equal(getattr(built.agg, f), getattr(restored.agg, f), f)
        assert getattr(built.agg, f).dtype == getattr(restored.agg, f).dtype
    _, source2 = dst.store.get(dst, 64.0)
    assert source2 == SOURCE_MERGED
    assert dst.store.builds == 0 and dst.store.restores == 1
    manifest = json.loads((tmp_path / "snap" / "manifest.json").read_text())
    assert manifest["version"] == 1
    (entry,) = manifest["entries"]
    assert entry["stats_keys"] == ["counts", "label_hist", "sums", "sumsq"]
    with np.load(tmp_path / "snap" / f"{entry['id']}.npz") as npz:
        assert sorted(npz.keys()) == [
            "index/bucket_of", "index/offsets", "index/perm",
            "stats/counts", "stats/label_hist", "stats/sums", "stats/sumsq"]


@pytest.mark.parametrize("change", ["data", "draws", "row order"])
def test_snapshot_skips_mismatched_identity(knn_pair, tmp_path, change):
    src = knn_pair()
    src.build(16.0)
    src.store.save(tmp_path / "snap")
    x, y = _knn_data()
    if change == "data":
        other = KNNServable(*_knn_data(seed=99), n_classes=C, k=3,
                            lsh_generator=torch.Generator().manual_seed(7),
                            device="cpu")
    elif change == "draws":
        other = KNNServable(x, y, n_classes=C, k=3,
                            lsh_generator=torch.Generator().manual_seed(123),
                            device="cpu")
    else:   # the same rows, two of them swapped: the checksum sees it
        x2, y2 = x.copy(), y.copy()
        x2[[0, 1]], y2[[0, 1]] = x[[1, 0]], y[[1, 0]]
        other = KNNServable(x2, y2, n_classes=C, k=3,
                            lsh_generator=torch.Generator().manual_seed(7),
                            device="cpu")
    assert other.store_key() != src.store_key()
    assert AggregateStore().restore(tmp_path / "snap", [other]) == 0


def test_save_is_atomic_and_overwrites(knn_pair, tmp_path):
    s = knn_pair()
    s.build(16.0)
    assert s.store.save(tmp_path / "snap") == 1
    assert s.store.save(tmp_path / "snap") == 1   # idempotent overwrite
    assert not (tmp_path / "snap.tmp").exists()
    assert not (tmp_path / "snap.old").exists()
    dst = knn_pair()
    assert dst.store.restore(tmp_path / "snap", [dst]) == 1


def test_empty_save_never_clobbers_a_good_snapshot(knn_pair, tmp_path):
    s = knn_pair()
    s.build(16.0)
    assert s.store.save(tmp_path / "snap") == 1
    assert AggregateStore().save(tmp_path / "snap") == 0  # nothing built
    assert not (tmp_path / "snap.tmp").exists()
    dst = knn_pair()
    assert dst.store.restore(tmp_path / "snap", [dst]) == 1


def test_restore_recovers_from_interrupted_save(knn_pair, tmp_path):
    s = knn_pair()
    s.build(16.0)
    s.store.save(tmp_path / "snap")
    (tmp_path / "snap").rename(tmp_path / "snap.old")  # the crash
    dst = knn_pair()
    assert dst.store.restore(tmp_path / "snap", [dst]) == 1
    assert dst.store.restore(tmp_path / "nowhere", [knn_pair()]) == 0


def test_restore_skips_incompatible_format_version(knn_pair, tmp_path):
    s = knn_pair()
    s.build(16.0)
    s.store.save(tmp_path / "snap")
    manifest = tmp_path / "snap" / "manifest.json"
    doc = json.loads(manifest.read_text())
    doc["version"] = 999
    manifest.write_text(json.dumps(doc))
    assert AggregateStore().restore(tmp_path / "snap", [knn_pair()]) == 0


def test_assembled_levels_are_bounded(knn_pair):
    """Only the last ``max_assembled`` prepared levels stay resident; an
    evicted level re-derives with one merge, never a cold rebuild."""
    s = knn_pair()
    pyr = s.store.pyramid(s)
    assert pyr.max_assembled < pyr.spec.n_levels
    for level in range(pyr.spec.n_levels):
        pyr.level(level)
    assert len(pyr.assembled_levels) == pyr.max_assembled
    evicted = pyr.spec.n_levels - pyr.max_assembled - 1
    assert evicted not in pyr.assembled_levels
    _, source = pyr.level(evicted)
    assert source == (SOURCE_MEMORY if evicted == 0 else SOURCE_MERGED)
    with pytest.raises(ValueError):
        pyr.level(pyr.spec.n_levels)


def test_adopt_checks_the_resolution(knn_pair):
    s = knn_pair()
    k = s.pyramid_spec.base_buckets
    index = agg_lib.bucket_index(torch.zeros(N, dtype=torch.int32), k)
    with pytest.raises(ValueError, match="counts"):
        s.store.adopt(s, {"sums": torch.zeros(k, D)}, index)
    with pytest.raises(ValueError, match="buckets"):
        s.store.adopt(s, {"counts": torch.zeros(k // 2,
                                                dtype=torch.int32)}, index)
    with pytest.raises(ValueError, match="index"):
        s.store.adopt(s, {"counts": torch.zeros(k, dtype=torch.int32)},
                      agg_lib.bucket_index(index.bucket_of, k // 2))
    assert s.store.invalidate(s) == 1 and s.store.invalidate(s) == 0


# ---------------------------------------------------------------------------
# the servables' plumbing
# ---------------------------------------------------------------------------

def test_checksum_is_position_sensitive_and_repeatable():
    a = th(normal(rng(8), 50, 3))
    assert servable_lib._checksum(a) == servable_lib._checksum(a.clone())
    swapped = a.clone()
    swapped[[0, 1]] = a[[1, 0]]
    assert servable_lib._checksum(swapped) != servable_lib._checksum(a)
    assert isinstance(servable_lib._checksum(a), float)


def test_servable_takes_exactly_one_draw_source():
    x, y = _knn_data()
    with pytest.raises(ValueError, match="exactly one"):
        KNNServable(x, y, n_classes=C, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        KNNServable(x, y, n_classes=C, device="cpu",
                    lsh_generator=torch.Generator(),
                    lsh_params=_draws(7, D))
    with pytest.raises(ValueError, match="lsh_params"):
        KNNServable(x, y, n_classes=C, device="cpu",
                    lsh_params=_draws(7, D + 1))


def test_nested_levels_reuse_the_base_draws(knn_pair):
    s = knn_pair()
    for ratio in (4.0, 16.0, 64.0):
        p = s._lsh_params(ratio)
        assert p.a is s.lsh_a and p.b is s.lsh_b
        cfg = p.config
        assert cfg.base_buckets == s.pyramid_spec.base_buckets
        assert cfg.n_buckets == s.pyramid_spec.n_buckets(
            s.pyramid_spec.level_for_ratio(ratio))
    assert s.cache_key(16.0) == s.cache_key(16.0 * (1 + 1e-9))
    assert s.cache_key(16.0) != s.cache_key(64.0)
    assert s.quantized_ratio(15.0) == s.pyramid_spec.ratio(
        s.pyramid_spec.level_for_ratio(15.0))


def test_stack_pad_pads_each_column_to_the_batch():
    rows = [(torch.full((3,), float(i)), torch.tensor(i)) for i in range(2)]
    a, b = servable_lib.LSHServableBase.stack_pad(rows, 4)
    assert a.shape == (4, 3) and b.shape == (4,)
    _equal(a[:, 0], [0, 1, 0, 0])
    _equal(b, [0, 1, 0, 0])


def test_knn_servable_answers_through_its_protocol(knn_pair):
    s = knn_pair()
    x, _ = _knn_data()
    payloads = [(th(x[i]),) for i in range(5)]
    batch = s.pad_batch(payloads, 8)
    assert batch[0].shape == (8, D)
    prepared = s.build(16.0)
    stage1 = s.run(prepared, batch, refine_budget=0)
    refined = s.run(prepared, batch, refine_budget=40)
    assert s.last_shuffle_bytes == 8 * (3 * 8 + 4)
    labels = s.unpack(refined, 5)
    assert len(labels) == 5 and all(0 <= v < C for v in labels)
    bounds = s.error_bounds(stage1, 5)
    assert all(isinstance(b, ErrorBound) and 0.0 <= b.value <= 1.0
               and b.metric == "label_divergence" for b in bounds)
    proxy = s.accuracy_proxy(stage1, refined, 5)
    assert len(proxy) == 5 and all(0.0 <= p <= 1.0 for p in proxy)
    assert s.accuracy_proxy(refined, refined, 5) == [0.0] * 5
    assert s.probe_payload()[0].shape == (D,)


def test_full_budget_answers_equal_the_exact_map(knn_pair):
    """At refine_budget = N every bucket is covered, so the store-backed
    answer is exact kNN."""
    s = knn_pair()
    x, y = _knn_data()
    q = th(normal(rng(11), 40, D))
    d, lab, vote, _ = s.run(s.build(32.0), (q,), refine_budget=N)
    want_d, want_l = knn.exact_map(th(x), th(y), q, k=3)
    assert_topk_match(d, lab, want_d, want_l)
    _equal(vote, knn.majority_vote(want_d, want_l, C))


def test_cf_servable_answers_through_its_protocol():
    x, m = _cf_data()
    s = _make_cf(x, m)
    payloads = [(th(x[i]), th(m[i])) for i in range(3)]
    batch = s.pad_batch(payloads, 4)
    prepared = s.build(8.0)
    stage1 = s.run(prepared, batch, refine_budget=0)
    refined = s.run(prepared, batch, refine_budget=20)
    assert stage1[0].shape == (4, x.shape[1]) and stage1[1].shape == (4,)
    rows = s.unpack(refined, 3)
    assert len(rows) == 3 and rows[0].shape == (x.shape[1],)
    bounds = s.error_bounds(stage1, 3)
    assert all(b.metric == "rating_mae" and np.isfinite(b.value)
               and b.value >= 0 for b in bounds)
    proxy = s.accuracy_proxy(stage1, refined, 3)
    assert len(proxy) == 3 and all(p >= 0 for p in proxy)
    assert s.accuracy_proxy(stage1, stage1, 3) == [0.0] * 3


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _border_rows(x, a, b, w):
    """Rows whose projection lies so near a bucket border that float32
    summation order alone can flip floor(proj / w)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    proj = (x.astype(np.float64) @ a + b) / w
    scale = (np.abs(x.astype(np.float64)) @ np.abs(a) + np.abs(b)) / w
    return (np.abs(proj - np.round(proj)) < 1e-5 * scale + 1e-6).any(axis=1)


@pytest.mark.parametrize("base,k_coarse", [(64, 64), (64, 16), (512, 8),
                                           (131_072, 2048)])
def test_fine_and_nested_ids_parity(base, k_coarse):
    x = normal(rng(base + k_coarse), 500, 24) * 2
    a, b = _draws(base, 24)
    cfg = jlsh.nested_config(base, k_coarse)
    jp = jlsh.LSHParams(a=jx(a), b=jx(b), config=cfg)
    tp = convert.lsh_params_from_numpy(a, b, n_hashes=4, bucket_width=4.0,
                                       n_buckets=k_coarse, base_buckets=base,
                                       device="cpu")
    border = _border_rows(x, a, b, 4.0)
    assert border.sum() <= 10
    for fn in ("fine_bucket_ids", "bucket_ids"):
        got = np_of(getattr(lsh_lib, fn)(th(x), tp))
        want = np.asarray(getattr(jlsh, fn)(jx(x), jp))
        np.testing.assert_array_equal(got[~border], want[~border], fn)
        assert got.dtype == np.int32


@pytest.fixture(scope="module")
def knn_ref():
    """The reference's kNN servable and the port's over the same numpy data
    and draws, with the reference's fine ids (downstream parity does not
    depend on hashing)."""
    x, y = _knn_data(seed=21, n=600)
    a, b = _draws(7, D)
    js = jknn.KNNServable(jx(x), jx(y), n_classes=C, k=3,
                          lsh_key=jax.random.PRNGKey(7))
    ts = KNNServable(x, y, n_classes=C, k=3, lsh_params=(a, b),
                     device="cpu")
    base = js.pyramid_spec.base_buckets
    assert dataclasses.astuple(ts.pyramid_spec) == dataclasses.astuple(
        js.pyramid_spec)
    fine = np.asarray(js.fine_ids(base))
    return x, y, js, ts, fine


def test_servable_fine_ids_parity(knn_ref):
    x, _, js, ts, fine = knn_ref
    a, b = _draws(7, D)
    border = _border_rows(x, a, b, 4.0)
    got = np_of(ts.fine_ids(ts.pyramid_spec.base_buckets))
    np.testing.assert_array_equal(got[~border], fine[~border])


def test_knn_mergeable_stats_and_merge_parity(knn_ref):
    x, y, js, ts, fine = knn_ref
    base = js.pyramid_spec.base_buckets
    want = jknn.knn_mergeable_stats(jx(x), jx(y), jx(fine), base, C)
    got = knn.knn_mergeable_stats(th(x), th(y), th(fine), base, C)
    assert sorted(got) == sorted(want)
    _equal(got["counts"], want["counts"])
    assert got["counts"].dtype == torch.int32
    for name in ("sums", "sumsq", "label_hist"):
        assert_close(got[name], want[name], err_msg=name)
    for level in (1, 3, js.pyramid_spec.n_levels - 1):
        f = js.pyramid_spec.factor(level)
        for name in got:
            m_got = agg_lib.merge_levels(got[name], f)
            m_want = jagg.merge_levels(want[name], f)
            assert m_got.dtype == got[name].dtype
            if name == "counts":
                _equal(m_got, m_want)
            else:
                assert_close(m_got, m_want, err_msg=name)
    got_i = agg_lib.bucket_index(th(fine), base, counts=got["counts"])
    want_i = jagg.bucket_index(jx(fine), base, counts=want["counts"])
    for level in (0, 2, 5):
        f = js.pyramid_spec.factor(level)
        gi = agg_lib.coarsen_index(got_i, f)
        wi = jagg.coarsen_index(want_i, f)
        for field in ("perm", "offsets", "bucket_of"):
            _equal(getattr(gi, field), getattr(wi, field), field)


def test_cf_mergeable_stats_parity():
    x, m = _cf_data(seed=9, users=200, items=40)
    ids = rng(2).integers(0, 64, 200).astype(np.int32)
    want = jcf.cf_mergeable_stats(jx(x), jx(m), jx(ids), 64)
    got = cf.cf_mergeable_stats(th(x), th(m), th(ids), 64)
    assert sorted(got) == sorted(want)
    _equal(got["counts"], want["counts"])
    for name in ("sr", "sr2", "s", "c"):
        assert_close(got[name], want[name], rtol=CF_TOL, atol=CF_TOL,
                     err_msg=name)
        for f in (2, 8):
            assert_close(agg_lib.merge_levels(got[name], f),
                         jagg.merge_levels(want[name], f), rtol=CF_TOL,
                         atol=CF_TOL, err_msg=name)


def test_aggregate_nested_parity():
    x = normal(rng(30), 300, D)
    ids = rng(31).integers(0, 64, 300).astype(np.int32)
    got = agg_lib.aggregate_nested(th(x), th(ids), 64, 8)
    want = jagg.aggregate_nested(jx(x), jx(ids), 64, 8)
    for f in ("counts", "perm", "offsets", "bucket_of"):
        _equal(getattr(got, f), getattr(want, f), f)
    assert_close(got.means, want.means)


def test_refined_bucket_mask_parity():
    agg = agg_lib.aggregate_by_bucket(th(normal(rng(2), 40, 3)),
                                      th(np.arange(40, dtype=np.int32) % 8),
                                      8)
    ranking = rng(5).permutation(8).astype(np.int32)
    for n_ref in (0, 3, 8):
        want = jagg.refined_bucket_mask(None, jx(ranking), n_ref)
        _equal(agg_lib.refined_bucket_mask(agg, th(ranking), n_ref), want)


def _jnp_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_reference_snapshot_assembles_to_the_reference_aggregates(
        tmp_path, kind):
    """A reference ``save_store`` npz, read by
    ``convert.store_level0_from_numpy`` and assembled by the port, gives
    the reference's prepared aggregates at every level."""
    if kind == "knn":
        x, y = _knn_data(seed=22, n=500)
        js = jknn.KNNServable(jx(x), jx(y), n_classes=C, k=3,
                              lsh_key=jax.random.PRNGKey(3))
        fields = ("bucket_labels", "spread", "dispersion")
        assemble = knn.knn_assemble
    else:
        x, m = _cf_data(seed=23, users=300, items=30)
        js = jcf.CFServable(jx(x), jx(m), lsh_key=jax.random.PRNGKey(4))
        fields = ("profile", "profile_mask", "s", "c", "cvar")
        assemble = cf.cf_assemble
    js.store.get(js, js.pyramid_spec.ratio(0))
    assert js.store.save(tmp_path / "snap") == 1
    (entry,) = json.loads(
        (tmp_path / "snap" / "manifest.json").read_text())["entries"]
    with np.load(tmp_path / "snap" / f"{entry['id']}.npz") as npz:
        stats0, index0 = convert.store_level0_from_numpy(npz, device="cpu")
    assert stats0["counts"].dtype == index0.perm.dtype == torch.int32
    spec = js.pyramid_spec
    for level in (0, 1, spec.n_levels - 1):
        want, _ = js.store.get(js, spec.ratio(level))
        f = spec.factor(level)
        stats = stats0 if level == 0 else {
            k: agg_lib.merge_levels(v, f) for k, v in stats0.items()}
        index = index0 if level == 0 else agg_lib.coarsen_index(index0, f)
        got = assemble(stats, index)
        for field in ("counts", "perm", "offsets", "bucket_of"):
            _equal(getattr(got.agg, field), getattr(want.agg, field), field)
        assert_close(got.agg.means, want.agg.means)
        for field in fields:
            w = np.asarray(getattr(want, field))
            g = np_of(getattr(got, field))
            if field == "bucket_labels":
                _equal(g, w)
            else:
                fin = np.isfinite(w)
                np.testing.assert_array_equal(np.isfinite(g), fin, field)
                assert_close(g[fin], w[fin], rtol=CF_TOL, atol=CF_TOL,
                             err_msg=field)


def _port_level(js, level, device="cpu"):
    """The reference servable's level-0 state at ``level`` in the port's
    form, assembled by the port."""
    pyr = js.store.pyramid(js)
    stats0 = {k: np.asarray(v) for k, v in pyr.stats_at(0).items()}
    idx = pyr.index_at(0)
    npz = {**{f"stats/{k}": v for k, v in stats0.items()},
           "index/perm": np.asarray(idx.perm),
           "index/offsets": np.asarray(idx.offsets),
           "index/bucket_of": np.asarray(idx.bucket_of)}
    stats, index = convert.store_level0_from_numpy(npz, device=device)
    f = js.pyramid_spec.factor(level)
    if level:
        stats = {k: agg_lib.merge_levels(v, f) for k, v in stats.items()}
        index = agg_lib.coarsen_index(index, f)
    return stats, index


@pytest.mark.parametrize("budget", [0, 30, 120])
def test_knn_servable_run_parity(knn_ref, budget):
    """The same prepared level and batch give the reference's top-k,
    votes and bounds (the tolerances of tests/_torch_parity.py; labels
    equal but at named near-ties)."""
    x, y, js, ts, _ = knn_ref
    level = js.pyramid_spec.level_for_ratio(16.0)
    jprep, _ = js.store.get(js, 16.0)
    tprep = ts.assemble(*_port_level(js, level))
    q = normal(rng(40), 64, D)
    want = js.run(jprep, (jx(q),), refine_budget=budget)
    got = ts.run(tprep, (th(q),), refine_budget=budget)
    nxt = knn.accurateml_map(th(x), th(y), tprep, th(q), k=4,
                             refine_budget=budget)[0][:, 3]
    ties = assert_topk_match(got[0], got[1], want[0], want[1], nxt,
                             real_only=False)
    assert not ties, f"near-tie label swaps at this seed: {ties}"
    _equal(got[2], want[2])
    assert_close(got[3], want[3])
    assert ts.last_shuffle_bytes == js.last_shuffle_bytes
    assert ts.unpack(got, 10) == js.unpack(want, 10)
    assert [b.value for b in ts.error_bounds(got, 5)] == pytest.approx(
        [b.value for b in js.error_bounds(want, 5)], abs=1e-4, rel=1e-4)


@pytest.mark.parametrize("budget", [0, 15, 60])
def test_cf_servable_run_parity(budget):
    x, m = _cf_data(seed=24, users=300, items=30)
    a, b = _draws(5, 30, width=8.0)
    js = jcf.CFServable(jx(x), jx(m), lsh_key=jax.random.PRNGKey(5))
    ts = CFServable(x, m, lsh_params=(a, b), device="cpu")
    jprep, _ = js.store.get(js, 8.0)
    tprep = ts.assemble(*_port_level(js, js.pyramid_spec.level_for_ratio(8.0)))
    qa, qm = _cf_data(seed=25, users=16, items=30)
    want = js.run(jprep, (jx(qa), jx(qm)), refine_budget=budget)
    got = ts.run(tprep, (th(qa), th(qm)), refine_budget=budget)
    assert_close(got[0], want[0], rtol=CF_TOL, atol=CF_TOL)
    assert_close(got[1], want[1], rtol=CF_TOL, atol=CF_TOL)
    assert ts.last_shuffle_bytes == js.last_shuffle_bytes


def test_restore_moves_arrays_to_the_servable_device(knn_pair, tmp_path):
    s = knn_pair()
    s.build(16.0)
    s.store.save(tmp_path / "snap")
    dst = knn_pair()
    fresh = AggregateStore()
    assert fresh.restore(tmp_path / "snap", [dst]) == 1
    prepared, source = fresh.get(dst, 16.0)
    assert source == SOURCE_RESTORED
    assert all(t.device.type == "cpu" for t in
               (prepared.agg.means, prepared.agg.perm, prepared.spread))
    assert fresh.stats()["restores"] == 1


def test_reference_store_replays_the_same_sources(knn_ref):
    """The two stores meter the same sources for the same sequence."""
    x, y, _, _, _ = knn_ref
    a, b = _draws(7, D)
    js = jknn.KNNServable(jx(x), jx(y), n_classes=C, k=3,
                          lsh_key=jax.random.PRNGKey(7))
    ts = KNNServable(x, y, n_classes=C, k=3, lsh_params=(a, b),
                     device="cpu")
    jst, tst = JAggregateStore(), AggregateStore()
    for ratio in (8.0, 8.0, 32.0, 4.0, 150.0):
        assert tst.get(ts, ratio)[1] == jst.get(js, ratio)[1]
    got, want = tst.stats(), jst.stats()
    assert got == want
