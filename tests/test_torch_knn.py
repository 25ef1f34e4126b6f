"""kNN Algorithm 1 end to end: the port's ``apps.knn`` against the JAX
package's, on the reference's data, LSH draws and sample permutations."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import (
    BIG, assert_close, assert_topk_match, np_of, rng, th,
)
from repro.apps import knn as jknn
from repro.core import engine as jengine
from repro.core import lsh as jlsh
from repro.data.synthetic import make_mfeat_like as jmake_mfeat_like
from repro_torch import convert
from repro_torch.apps import knn
from repro_torch.core import engine, lsh

K, N_CLASSES = 5, 8

jx = jnp.asarray


@pytest.fixture(scope="module")
def data():
    """The reference generator's data, as numpy: 2400 training points and
    200 queries, 24 features, 8 classes."""
    x, y = jmake_mfeat_like(jax.random.PRNGKey(0), n_points=2600,
                            n_features=24, n_classes=N_CLASSES)
    x, y = np.array(x), np.array(y)
    return x[200:], y[200:], x[:200], y[:200]


def _shard_params(key, n_shards, n, n_features, ratio):
    """Each shard's LSH draw as the reference's run_accurateml makes it, in
    the reference's and in the port's form."""
    jps, tps = [], []
    for s in range(n_shards):
        n_s = (s + 1) * n // n_shards - s * n // n_shards
        cfg = jlsh.config_for_compression(n_s, ratio)
        jp = jlsh.init_lsh(jax.random.fold_in(key, s), n_features, cfg)
        jps.append(jp)
        tps.append(convert.lsh_params_from_numpy(
            np.asarray(jp.a), np.asarray(jp.b), n_hashes=cfg.n_hashes,
            bucket_width=cfg.bucket_width, n_buckets=cfg.n_buckets,
            device="cpu"))
    return jps, tps


@pytest.fixture(scope="module")
def aggregates(data):
    """One shard's aggregates built by the reference, and the same numbers
    in the port's form (downstream tests do not depend on hashing)."""
    tx, ty, _, _ = data
    (jp,), _ = _shard_params(jax.random.PRNGKey(7), 1, tx.shape[0], 24, 16.0)
    ja = jknn.build_knn_aggregates(jx(tx), jx(ty), jp, N_CLASSES)
    g = ja.agg
    ta = convert.knn_aggregates_from_numpy(
        g.means, g.counts, g.perm, g.offsets, g.bucket_of, ja.bucket_labels,
        ja.spread, ja.dispersion, device="cpu")
    return ja, ta


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_labels", [True, False])
def test_local_topk_parity(shared_labels):
    r = rng(1)
    d = r.integers(0, 20, (9, 40)).astype(np.float32)       # many exact ties
    lab = (r.integers(0, 6, 40) if shared_labels
           else r.integers(0, 6, (9, 40))).astype(np.int32)
    got = knn.local_topk(th(d), th(lab), 7)
    want = jknn.local_topk(jx(d), jx(lab), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


def test_majority_vote_parity_with_ties_and_padding():
    r = rng(2)
    d = (r.random((50, 6)) * 3).astype(np.float32)
    d[r.random((50, 6)) < 0.2] = BIG                        # padding slots
    d[7] = BIG                                              # all padding
    lab = r.integers(0, 3, (50, 6)).astype(np.int32)        # frequent ties
    got = knn.majority_vote(th(d), th(lab), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        np_of(got), np.asarray(jknn.majority_vote(jx(d), jx(lab), 4)))
    assert int(got[7]) == 0


@pytest.mark.parametrize("s,width", [(1, 5), (3, 5), (4, 9), (1, 7),
                                     (2, 5), (8, 5), (8, 9), (2, 9)])
def test_merge_topk_parity(s, width):
    r = rng(s * 10 + width)
    d = np.sort(r.integers(0, 15, (s, 11, width)).astype(np.float32), axis=-1)
    lab = r.integers(0, 9, (s, 11, width)).astype(np.int32)
    got = knn.merge_topk(th(d), th(lab), K)
    want = jknn.merge_topk(jx(d), jx(lab), K)
    assert_topk_match(*got, *want, real_only=False, rtol=0, atol=0)


def test_accuracy_and_loss_parity():
    r = rng(3)
    pred, truth = (r.integers(0, 4, 100).astype(np.int32) for _ in range(2))
    assert knn.accuracy(th(pred), th(truth)) == pytest.approx(
        jknn.accuracy(jx(pred), jx(truth)))
    for exact, approx in [(0.9, 0.8), (0.5, 0.7), (0.0, 0.0)]:
        assert knn.accuracy_loss(exact, approx) == jknn.accuracy_loss(exact,
                                                                      approx)


# ---------------------------------------------------------------------------
# map tasks
# ---------------------------------------------------------------------------

def test_exact_and_sampled_map_parity(data):
    tx, ty, qx, _ = data
    got = knn.exact_map(th(tx), th(ty), th(qx), k=K)
    want = jknn.exact_map(jx(tx), jx(ty), jx(qx), k=K)
    nxt = knn.exact_map(th(tx), th(ty), th(qx), k=K + 1)[0][:, K]
    assert_topk_match(*got, *want, nxt, real_only=False)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(4),
                                             tx.shape[0])).astype(np.int32)
    got = knn.sampled_map(th(tx), th(ty), th(qx), th(perm), k=K, n_sample=300)
    want = jknn.sampled_map(jx(tx), jx(ty), jx(qx), jx(perm), k=K,
                            n_sample=300)
    nxt = knn.sampled_map(th(tx), th(ty), th(qx), th(perm), k=K + 1,
                          n_sample=300)[0][:, K]
    assert_topk_match(*got, *want, nxt, real_only=False)


def test_build_knn_aggregates_parity(data, aggregates):
    tx, ty, _, _ = data
    (jp,), (tp,) = _shard_params(jax.random.PRNGKey(7), 1, tx.shape[0], 24,
                                 16.0)
    got = knn.build_knn_aggregates(th(tx), th(ty), tp, N_CLASSES)
    want, _ = aggregates
    for name in ("counts", "perm", "offsets", "bucket_of"):
        np.testing.assert_array_equal(np_of(getattr(got.agg, name)),
                                      np.asarray(getattr(want.agg, name)),
                                      err_msg=name)
    assert_close(got.agg.means, want.agg.means, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np_of(got.bucket_labels),
                                  np.asarray(want.bucket_labels))
    assert_close(got.spread, want.spread)
    np.testing.assert_array_equal(np_of(got.dispersion),
                                  np.asarray(want.dispersion))
    assert np.isinf(np_of(got.spread)[np_of(got.agg.counts) == 0]).all()


@pytest.mark.parametrize("budget", [0, 1, 37, 300])
@pytest.mark.parametrize("with_bound", [False, True])
def test_accurateml_map_parity(data, aggregates, budget, with_bound):
    tx, ty, qx, _ = data
    ja, ta = aggregates
    got = knn.accurateml_map(th(tx), th(ty), ta, th(qx), k=K,
                             refine_budget=budget, with_bound=with_bound)
    want = jknn.accurateml_map(jx(tx), jx(ty), ja, jx(qx), k=K,
                               refine_budget=budget, with_bound=with_bound)
    nxt = knn.accurateml_map(th(tx), th(ty), ta, th(qx), k=K + 1,
                             refine_budget=budget)[0][:, K]
    ties = assert_topk_match(got[0], got[1], want[0], want[1], nxt,
                             real_only=False)
    assert not ties, f"near-tie label swaps at this seed: {ties}"
    if with_bound:
        assert got[2].shape == (qx.shape[0],) and got[2].dtype == torch.float32
        assert_close(got[2], want[2])
        assert ((np_of(got[2]) >= 0) & (np_of(got[2]) <= 1)).all()


def test_mapreduce_with_bound_batch_parity(data, aggregates):
    """One with_bound batch through the engine's all_gather combine: the
    same answers and the same shuffle bytes as the reference."""
    tx, ty, qx, _ = data
    ja, ta = aggregates

    def reduce_fn(mod, maxf, g):
        d, lab = mod.merge_topk(g[0], g[1], K)
        return d, lab, mod.majority_vote(d, lab, N_CLASSES), maxf(g[2])

    mr = engine.MapReduce(mesh=None)
    got = mr.run(
        partial(knn.accurateml_map, k=K, refine_budget=60, with_bound=True),
        engine.CombineSpec("all_gather",
                           partial(reduce_fn, knn, lambda b: b.max(0).values)),
        th(tx), th(ty), replicated_args=(ta, th(qx)))
    jmr = jengine.MapReduce(mesh=None)
    want = jmr.run(
        partial(jknn.accurateml_map, k=K, refine_budget=60, with_bound=True),
        jengine.CombineSpec("all_gather",
                            partial(reduce_fn, jknn,
                                    lambda b: jnp.max(b, axis=0))),
        jx(tx), jx(ty), replicated_args=(ja, jx(qx)))
    assert mr.last_shuffle_bytes == jmr.last_shuffle_bytes
    assert mr.last_shuffle_bytes == qx.shape[0] * (K * 8 + 4)
    assert_topk_match(got[0], got[1], want[0], want[1], real_only=False)
    np.testing.assert_array_equal(np_of(got[2]), np.asarray(want[2]))
    assert_close(got[3], want[3])


# ---------------------------------------------------------------------------
# end-to-end jobs, two shards
# ---------------------------------------------------------------------------

def test_run_exact_parity(data):
    tx, ty, qx, _ = data
    got = knn.run_exact(tx, ty, qx, k=K, n_classes=N_CLASSES, n_shards=2,
                        device="cpu")
    want = jknn.run_exact(jx(tx), jx(ty), jx(qx), k=K, n_classes=N_CLASSES,
                          n_shards=2)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


@pytest.mark.parametrize("eps", [0.0, 0.05, 0.3])
def test_run_accurateml_parity(data, eps):
    tx, ty, qx, _ = data
    key = jax.random.PRNGKey(7)
    _, params = _shard_params(key, 2, tx.shape[0], 24, 16.0)
    got = knn.run_accurateml(
        th(tx), th(ty), th(qx), k=K, n_classes=N_CLASSES,
        compression_ratio=16.0, eps_max=eps, lsh_params=params, n_shards=2,
        device="cpu")
    want = jknn.run_accurateml(
        jx(tx), jx(ty), jx(qx), k=K, n_classes=N_CLASSES,
        compression_ratio=16.0, eps_max=eps, lsh_key=key, n_shards=2)
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_run_sampled_parity(data):
    tx, ty, qx, _ = data
    key = jax.random.PRNGKey(9)
    n_s = tx.shape[0] // 2
    perms = [th(np.asarray(jax.random.permutation(jax.random.fold_in(key, s),
                                                  n_s)))
             for s in range(2)]
    got = knn.run_sampled(th(tx), th(ty), th(qx), k=K, n_classes=N_CLASSES,
                          sample_frac=0.2, sample_perms=perms, n_shards=2,
                          device="cpu")
    want = jknn.run_sampled(jx(tx), jx(ty), jx(qx), k=K, n_classes=N_CLASSES,
                            sample_frac=0.2, sample_key=key, n_shards=2)
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_full_refinement_equals_exact_and_draws_are_seeded(data):
    tx, ty, qx, qy = data
    common = dict(k=K, n_classes=N_CLASSES, n_shards=2, device="cpu")
    exact = knn.run_exact(tx, ty, qx, **common)
    runs = [knn.run_accurateml(
        th(tx), th(ty), th(qx), compression_ratio=16.0, eps_max=eps,
        lsh_generator=torch.Generator().manual_seed(7), **common)
        for eps in (1.0, 1.0, 0.0)]
    assert torch.equal(runs[0], exact) and torch.equal(runs[0], runs[1])
    assert knn.accuracy(exact, th(qy)) > 0.9
    assert knn.accuracy(runs[2], th(qy)) > 0.5
    s1 = knn.run_sampled(tx, ty, qx, sample_frac=0.3,
                         sample_generator=torch.Generator().manual_seed(1),
                         **common)
    s2 = knn.run_sampled(tx, ty, qx, sample_frac=0.3,
                         sample_generator=torch.Generator().manual_seed(1),
                         **common)
    assert torch.equal(s1, s2)


def test_run_jobs_check_their_draw_arguments(data):
    tx, ty, qx, _ = data
    common = dict(k=K, n_classes=N_CLASSES, n_shards=2, device="cpu")
    aml = dict(compression_ratio=16.0, eps_max=0.1)
    with pytest.raises(ValueError, match="exactly one"):
        knn.run_accurateml(tx, ty, qx, **aml, **common)
    _, params = _shard_params(jax.random.PRNGKey(7), 2, tx.shape[0], 24, 16.0)
    with pytest.raises(ValueError, match="exactly one"):
        knn.run_accurateml(tx, ty, qx, lsh_params=params,
                           lsh_generator=torch.Generator(), **aml, **common)
    with pytest.raises(ValueError, match="1 lsh_params for 2 shards"):
        knn.run_accurateml(tx, ty, qx, lsh_params=params[:1], **aml, **common)
    with pytest.raises(ValueError, match="config"):
        knn.run_accurateml(tx, ty, qx, lsh_params=params[::-1] * 1,
                           compression_ratio=8.0, eps_max=0.1, **common)
    with pytest.raises(ValueError, match="exactly one"):
        knn.run_sampled(tx, ty, qx, sample_frac=0.5, **common)
    with pytest.raises(ValueError, match="1 sample_perms for 2 shards"):
        knn.run_sampled(tx, ty, qx, sample_frac=0.5,
                        sample_perms=[th(np.arange(1200))], **common)


def test_lsh_params_from_numpy_checks_shapes():
    with pytest.raises(ValueError, match="n_hashes=4"):
        convert.lsh_params_from_numpy(np.zeros((5, 3)), np.zeros(3),
                                      n_hashes=4, bucket_width=4.0,
                                      n_buckets=8, device="cpu")
    p = convert.lsh_params_from_numpy(np.ones((5, 2)), np.zeros(2),
                                      n_hashes=2, bucket_width=4.0,
                                      n_buckets=8, device="cpu")
    assert p.a.dtype == torch.float32 and p.config == lsh.LSHConfig(
        n_hashes=2, bucket_width=4.0, n_buckets=8)
