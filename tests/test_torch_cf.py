"""User-based CF (Algorithm 1, application 2) end to end: the port's
``apps.cf`` against the JAX package's, on the reference's data, LSH draws
and sample permutations.

Tolerances: CF weights and partial sums within 2e-4 (the reference's own
kernel tolerance, tests/test_kernels.py:63,317); RMSE equal to 1e-5.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import assert_close, np_of, th
from repro.apps import cf as jcf
from repro.core import engine as jengine
from repro.core import lsh as jlsh
from repro.data.synthetic import holdout_split as jholdout_split
from repro.data.synthetic import make_netflix_like as jmake_netflix_like
from repro_torch import convert
from repro_torch.apps import cf
from repro_torch.core import engine

CF_TOL = 2e-4
RMSE_TOL = 1e-5
N_ACTIVE = 40
RATIO = 20.0

jx = jnp.asarray


@pytest.fixture(scope="module")
def data():
    """The reference generator's ratings, split as benchmarks/common.py
    splits them, as numpy: 600 neighbourhood users and 40 active users
    over 120 items."""
    ratings, mask = jmake_netflix_like(jax.random.PRNGKey(1),
                                       n_users=600 + N_ACTIVE, n_items=120,
                                       density=0.12)
    train_mask, test_mask = jholdout_split(jax.random.PRNGKey(2), mask, 0.2)
    train_r = np.array(ratings * train_mask)
    train_mask, test_mask = np.array(train_mask), np.array(test_mask)
    a = N_ACTIVE
    return (train_r[a:], train_mask[a:], train_r[:a], train_mask[:a],
            np.array(ratings)[:a], test_mask[:a])


def _shard_params(key, n_shards, n, n_items, ratio=RATIO):
    """Each shard's LSH draw as the reference's run_accurateml makes it, in
    the reference's and in the port's form."""
    jps, tps = [], []
    for s in range(n_shards):
        n_s = (s + 1) * n // n_shards - s * n // n_shards
        cfg = jlsh.config_for_compression(n_s, ratio, n_hashes=4,
                                          bucket_width=8.0)
        jp = jlsh.init_lsh(jax.random.fold_in(key, s), n_items, cfg)
        jps.append(jp)
        tps.append(convert.lsh_params_from_numpy(
            np.asarray(jp.a), np.asarray(jp.b), n_hashes=cfg.n_hashes,
            bucket_width=cfg.bucket_width, n_buckets=cfg.n_buckets,
            device="cpu"))
    return jps, tps


def _to_port(ja):
    g = ja.agg
    return convert.cf_aggregates_from_numpy(
        g.means, g.counts, g.perm, g.offsets, g.bucket_of, ja.profile,
        ja.profile_mask, ja.s, ja.c, ja.cvar, device="cpu")


@pytest.fixture(scope="module")
def aggregates(data):
    """One shard's aggregates built by the reference, and the same numbers
    in the port's form (downstream tests do not depend on hashing)."""
    nr, nm = data[:2]
    (jp,), _ = _shard_params(jax.random.PRNGKey(9), 1, nr.shape[0],
                             nr.shape[1])
    ja = jcf.build_cf_aggregates(jx(nr), jx(nm), jp)
    return ja, _to_port(ja)


def _close(got, want, names):
    for g, w, name in zip(got, want, names):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert_close(g, w, rtol=CF_TOL, atol=CF_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_user_means_and_shrink_parity(data):
    nr, nm = data[:2]
    assert_close(cf.user_means(th(nr), th(nm)),
                 jcf.user_means(jx(nr), jx(nm)), rtol=1e-6, atol=1e-6)
    w = np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6)
    co = np.arange(24, dtype=np.float32).reshape(4, 6)
    assert_close(cf.shrink_weights(th(w), th(co)),
                 jcf.shrink_weights(jx(w), jx(co)), rtol=1e-6, atol=1e-7)
    assert cf.SHRINK == jcf.SHRINK and cf.CF_BOUND_Z == jcf.CF_BOUND_Z
    assert cf.CF_BOUND_CONFIDENCE == jcf.CF_BOUND_CONFIDENCE


def test_predict_rmse_and_loss_parity(data):
    *_, a, am, truth, tmask = data
    r = np.random.default_rng(3)
    num = r.standard_normal(a.shape).astype(np.float32)
    den = r.random(a.shape).astype(np.float32)
    den[r.random(a.shape) < 0.3] = 0.0                 # no neighbour: mean
    got = cf.predict(th(num), th(den), th(a), th(am))
    want = jcf.predict(jx(num), jx(den), jx(a), jx(am))
    assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert cf.rmse(got, th(truth), th(tmask)) == pytest.approx(
        jcf.rmse(want, jx(truth), jx(tmask)), rel=RMSE_TOL)
    for exact, approx in [(0.9, 0.95), (0.9, 0.8), (0.0, 0.0)]:
        assert cf.rmse_loss(exact, approx) == jcf.rmse_loss(exact, approx)


@pytest.mark.parametrize("n_users,n_items,n_active,ratio,eps", [
    (10_000, 500, 100, 10.0, 0.0), (10_000, 500, 100, 100.0, 0.05),
    (48_019, 17_700, 1024, 20.0, 0.05), (6_002, 17_700, 1024, 20.0, 0.5),
])
def test_shuffle_bytes_parity(n_users, n_items, n_active, ratio, eps):
    assert cf.shuffle_bytes_exact(n_users, n_items, n_active) == \
        jcf.shuffle_bytes_exact(n_users, n_items, n_active)
    assert cf.shuffle_bytes_accurateml(n_users, n_items, n_active, ratio,
                                       eps) == \
        jcf.shuffle_bytes_accurateml(n_users, n_items, n_active, ratio, eps)


def test_shuffle_bytes_count_the_budget_the_job_refines():
    """The port rounds eps * U up in float64 (math.ceil), as
    core/refine.py:eps_to_budget sizes the refinement; the reference's model
    rounds a float32 (jnp.ceil), which can land one user lower."""
    from repro_torch.core.refine import eps_to_budget
    n, eps, k = 100, 0.07, 10
    assert eps_to_budget(n, eps) == 8
    assert cf.shuffle_bytes_accurateml(n, 50, 4, 10.0, eps) == \
        4 * (4 * (k + 8) + 2 * (k + 8) * 50)
    assert jcf.shuffle_bytes_accurateml(n, 50, 4, 10.0, eps) == \
        4 * (4 * (k + 7) + 2 * (k + 7) * 50)


# ---------------------------------------------------------------------------
# map tasks
# ---------------------------------------------------------------------------

def test_exact_and_sampled_map_parity(data):
    nr, nm, a, am = (th(x) for x in data[:4])
    jargs = [jx(x) for x in data[:4]]
    _close(cf.exact_map(nr, nm, a, am), jcf.exact_map(*jargs),
           ("num", "den"))
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(4),
                                             nr.shape[0])).astype(np.int32)
    _close(cf.sampled_map(nr, nm, a, am, th(perm), n_sample=90),
           jcf.sampled_map(*jargs, jx(perm), n_sample=90), ("num", "den"))


def test_build_cf_aggregates_parity(data, aggregates):
    nr, nm = data[:2]
    _, (tp,) = _shard_params(jax.random.PRNGKey(9), 1, nr.shape[0],
                             nr.shape[1])
    got = cf.build_cf_aggregates(th(nr), th(nm), tp)
    want, _ = aggregates
    for name in ("counts", "perm", "offsets", "bucket_of"):
        g = np_of(getattr(got.agg, name))
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, np.asarray(getattr(want.agg, name)),
                                      err_msg=name)
    assert_close(got.agg.means, want.agg.means, rtol=CF_TOL, atol=CF_TOL)
    for name in ("profile", "profile_mask", "s", "c", "cvar"):
        assert_close(getattr(got, name), getattr(want, name), rtol=CF_TOL,
                     atol=CF_TOL, err_msg=name)
    assert (np_of(got.agg.counts) == 0).any()  # an empty bucket is covered


def test_cf_aggregates_are_the_same_bits_on_two_builds(data):
    nr, nm = th(data[0]), th(data[1])
    _, (tp,) = _shard_params(jax.random.PRNGKey(9), 1, nr.shape[0],
                             nr.shape[1])
    one = cf.build_cf_aggregates(nr, nm, tp)
    two = cf.build_cf_aggregates(nr, nm, tp)
    for f in ("profile", "profile_mask", "s", "c", "cvar"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    for f in ("means", "counts", "perm", "offsets", "bucket_of"):
        assert torch.equal(getattr(one.agg, f), getattr(two.agg, f)), f


@pytest.mark.parametrize("budget", [0, 45, 600])
@pytest.mark.parametrize("with_bound", [False, True])
def test_accurateml_map_parity(data, aggregates, budget, with_bound):
    """Budget 0 is pure stage 1, 45 refines some buckets per query, 600 is
    the whole shard."""
    ja, ta = aggregates
    got = cf.accurateml_map(*(th(x) for x in data[:2]), ta,
                            *(th(x) for x in data[2:4]),
                            refine_budget=budget, with_bound=with_bound)
    want = jcf.accurateml_map(*(jx(x) for x in data[:2]), ja,
                              *(jx(x) for x in data[2:4]),
                              refine_budget=budget, with_bound=with_bound)
    assert len(got) == len(want) == (3 if with_bound else 2)
    _close(got, want, ("num", "den", "varsum"))
    if with_bound and budget == 600:  # every bucket refined: no surrogate
        assert (np_of(got[2]) == 0).all()


def test_mapreduce_psum_batch_parity(data, aggregates):
    """One with_bound batch through the engine's psum combine: the same
    predictions, bound and shuffle bytes as the reference."""
    ja, ta = aggregates
    *_, a, am, _, _ = data

    def reduce_fn(nd):        # CFServable.run's reduce, in torch
        pred = cf.predict(nd[0], nd[1], th(a), th(am))
        stderr = torch.where(nd[1] > 1e-8, nd[2].sqrt()
                             / torch.clamp_min(nd[1], 1e-8), 0.0)
        return pred, cf.CF_BOUND_Z * stderr.mean(-1)

    def jreduce_fn(nd):
        pred = jcf.predict(nd[0], nd[1], jx(a), jx(am))
        stderr = jnp.where(nd[1] > 1e-8,
                           jnp.sqrt(nd[2]) / jnp.maximum(nd[1], 1e-8), 0.0)
        return pred, jcf.CF_BOUND_Z * jnp.mean(stderr, axis=-1)

    mr = engine.MapReduce(mesh=None)
    got = mr.run(
        partial(cf.accurateml_map, refine_budget=45, with_bound=True),
        engine.CombineSpec("psum", reduce_fn),
        th(data[0]), th(data[1]), replicated_args=(ta, th(a), th(am)))
    jmr = jengine.MapReduce(mesh=None)
    want = jmr.run(
        partial(jcf.accurateml_map, refine_budget=45, with_bound=True),
        jengine.CombineSpec("psum", jreduce_fn),
        jx(data[0]), jx(data[1]), replicated_args=(ja, jx(a), jx(am)))
    assert mr.last_shuffle_bytes == jmr.last_shuffle_bytes
    assert mr.last_shuffle_bytes == 3 * 4 * a.size
    _close(got, want, ("pred", "bound"))


# ---------------------------------------------------------------------------
# end-to-end jobs, two shards
# ---------------------------------------------------------------------------

def _rmse_pair(got, want, data):
    truth, tmask = data[4:]
    g = cf.rmse(got, th(truth), th(tmask))
    w = jcf.rmse(want, jx(truth), jx(tmask))
    assert g == pytest.approx(w, rel=RMSE_TOL, abs=RMSE_TOL)
    return g


def test_run_exact_parity(data):
    got = cf.run_exact(*data[:4], n_shards=2, device="cpu")
    want = jcf.run_exact(*(jx(x) for x in data[:4]), n_shards=2)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close((got,), (want,), ("pred",))
    _rmse_pair(got, want, data)


@pytest.mark.parametrize("eps", [0.0, 0.05, 0.3])
def test_run_accurateml_parity(data, eps):
    key = jax.random.PRNGKey(9)
    _, params = _shard_params(key, 2, data[0].shape[0], data[0].shape[1])
    got = cf.run_accurateml(*(th(x) for x in data[:4]),
                            compression_ratio=RATIO, eps_max=eps,
                            lsh_params=params, n_shards=2, device="cpu")
    want = jcf.run_accurateml(*(jx(x) for x in data[:4]),
                              compression_ratio=RATIO, eps_max=eps,
                              lsh_key=key, n_shards=2)
    _close((got,), (want,), ("pred",))
    _rmse_pair(got, want, data)


def test_run_sampled_parity(data):
    key = jax.random.PRNGKey(4)
    n_s = data[0].shape[0] // 2
    perms = [th(np.asarray(jax.random.permutation(jax.random.fold_in(key, s),
                                                  n_s)))
             for s in range(2)]
    frac = 1.0 / RATIO + 0.05
    got = cf.run_sampled(*(th(x) for x in data[:4]), sample_frac=frac,
                         sample_perms=perms, n_shards=2, device="cpu")
    want = jcf.run_sampled(*(jx(x) for x in data[:4]), sample_frac=frac,
                           sample_key=key, n_shards=2)
    _close((got,), (want,), ("pred",))
    _rmse_pair(got, want, data)


def test_full_refinement_equals_exact_and_draws_are_seeded(data):
    """The reference's own thresholds (tests/test_apps.py:91-99)."""
    truth, tmask = th(data[4]), th(data[5])
    common = dict(n_shards=2, device="cpu")
    exact = cf.run_exact(*data[:4], **common)
    runs = [cf.run_accurateml(
        *data[:4], compression_ratio=16.0, eps_max=eps,
        lsh_generator=torch.Generator().manual_seed(7), **common)
        for eps in (1.0, 1.0, 0.05)]
    assert abs(cf.rmse(exact, truth, tmask)
               - cf.rmse(runs[0], truth, tmask)) < 1e-3
    assert float((exact - runs[0]).abs().max()) < 0.05
    assert torch.equal(runs[0], runs[1])
    loss = cf.rmse_loss(cf.rmse(exact, truth, tmask),
                        cf.rmse(runs[2], truth, tmask))
    assert 0.0 <= loss < 0.06
    s1, s2 = (cf.run_sampled(
        *data[:4], sample_frac=0.3,
        sample_generator=torch.Generator().manual_seed(1), **common)
        for _ in range(2))
    assert torch.equal(s1, s2)


def test_accurateml_beats_sampling_at_equal_work_on_the_reference_inputs():
    """tests/test_apps.py::test_cf_beats_sampling_at_equal_work on the port:
    the same 1150 neighbourhood users and 50 active users over 300 items,
    the same LSH draws and sample permutations, the same threshold.  The
    port's RMSEs equal the JAX package's, so the two order the methods
    alike."""
    ratings, mask = jmake_netflix_like(jax.random.PRNGKey(1), n_users=1200,
                                       n_items=300, density=0.12)
    train_mask, test_mask = jholdout_split(jax.random.PRNGKey(2), mask, 0.2)
    train_r = ratings * train_mask
    jargs = (train_r[50:], train_mask[50:], train_r[:50], train_mask[:50])
    truth, tmask = np.array(ratings)[:50], np.array(test_mask)[:50]
    args = tuple(th(np.array(x)) for x in jargs)
    r, eps, common = 20.0, 0.02, dict(n_shards=2)
    lsh_key, sample_key = jax.random.PRNGKey(9), jax.random.PRNGKey(4)
    _, params = _shard_params(lsh_key, 2, 1150, 300, ratio=r)
    perms = [th(np.asarray(jax.random.permutation(
        jax.random.fold_in(sample_key, s), 575))) for s in range(2)]
    got = [cf.run_exact(*args, device="cpu", **common),
           cf.run_accurateml(*args, compression_ratio=r, eps_max=eps,
                             lsh_params=params, device="cpu", **common),
           cf.run_sampled(*args, sample_frac=1.0 / r + eps,
                          sample_perms=perms, device="cpu", **common)]
    want = [jcf.run_exact(*jargs, **common),
            jcf.run_accurateml(*jargs, compression_ratio=r, eps_max=eps,
                               lsh_key=lsh_key, **common),
            jcf.run_sampled(*jargs, sample_frac=1.0 / r + eps,
                            sample_key=sample_key, **common)]
    rmse_e, rmse_a, rmse_s = (_rmse_pair(g, w, (None,) * 4 + (truth, tmask))
                              for g, w in zip(got, want))
    loss_a = cf.rmse_loss(rmse_e, rmse_a)
    loss_s = cf.rmse_loss(rmse_e, rmse_s)
    assert loss_a <= loss_s + 1e-9, (loss_a, loss_s)


def test_run_jobs_check_their_draw_arguments(data):
    common = dict(n_shards=2, device="cpu")
    aml = dict(compression_ratio=RATIO, eps_max=0.1)
    with pytest.raises(ValueError, match="exactly one"):
        cf.run_accurateml(*data[:4], **aml, **common)
    _, params = _shard_params(jax.random.PRNGKey(9), 2, data[0].shape[0],
                              data[0].shape[1])
    with pytest.raises(ValueError, match="exactly one"):
        cf.run_accurateml(*data[:4], lsh_params=params,
                          lsh_generator=torch.Generator(), **aml, **common)
    with pytest.raises(ValueError, match="1 lsh_params for 2 shards"):
        cf.run_accurateml(*data[:4], lsh_params=params[:1], **aml, **common)
    with pytest.raises(ValueError, match="config"):
        cf.run_accurateml(*data[:4], lsh_params=params,
                          compression_ratio=8.0, eps_max=0.1, **common)
    with pytest.raises(ValueError, match="exactly one"):
        cf.run_sampled(*data[:4], sample_frac=0.5, **common)
    with pytest.raises(ValueError, match="1 sample_perms for 2 shards"):
        cf.run_sampled(*data[:4], sample_frac=0.5,
                       sample_perms=[th(np.arange(300))], **common)
