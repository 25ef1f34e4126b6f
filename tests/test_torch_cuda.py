"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  On a machine with an NVIDIA H100
and the CUDA toolkit (the kernels build with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import (
    BATCHED_TOPK_CASES, BIG, CF_AGGREGATE_CASES, CF_SPARSE_CASES,
    assert_close, assert_topk_match, batched_inputs, candidates,
    cf_aggregate_args, cf_aggregate_inputs, cf_inputs, cf_sparse_inputs,
    normal, np_of, rng, th, topk_inputs,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.agg_refine import agg_refine_attention_cuda
from repro_torch.kernels.aggregated_attention import aggregated_attention_cuda
from repro_torch.kernels.candidate_topk import candidate_topk_cuda
from repro_torch.kernels.cf_aggregate import cf_aggregate_cuda
from repro_torch.kernels.cf_refine import cf_refine_cuda
from repro_torch.kernels.cf_weights import cf_weights_cuda
from repro_torch.kernels.distance_topk import SMALL_MAX_N, distance_topk_cuda
from repro_torch.kernels.knn_distance import knn_distance_cuda
from repro_torch.kernels.lsh_hash import lsh_bucket_ids_cuda, lsh_hash_cuda
from repro_torch.kernels.refine_distances import refine_distances_cuda
from repro_torch.kernels.topk_stream import MAX_K

CF_TOL = 2e-4  # tests/test_kernels.py:63,317
ATTN_TOL = 2e-5  # tests/test_kernels.py:108: f32 sums in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [None if a is None else th(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d,k,metric,valid_frac", [
    (1, 1, 1, 1, "l2", 1.0), (7, 3, 9, 5, "l2", 1.0),
    (130, 5000, 217, 6, "l2", 0.5), (64, 40, 12, 3, "l2", 0.0),
    (33, 777, 50, 17, "l2", 1.0), (33, 777, 50, 32, "dot", 0.8),
    # k > MAX_K within the batched regime's N: one launch
    (1, 64, 1024, 64, "dot", 0.9),       # rf 1.0 bucket selection, K = 64
    (3, 500, 40, 70, "l2", 0.5), (2, 50, 8, 80, "dot", 0.6),
    # the wide regime, off the 128 x 128 tile grid
    (129, 5000, 217, 5, "l2", 1.0), (127, 2875, 217, 6, "l2", 0.9),
    (1, 1025, 1, 3, "dot", 1.0), (300, 20_000, 217, 5, "l2", 1.0),
    # wider than the wide regime's k-best: rounds of MAX_K, a row at a time
    (2, 3000, 16, 40, "l2", 0.7),
])
def test_cuda_distance_topk(cuda, q, n, d, k, metric, valid_frac):
    qs, ps, labs, valid = _on(cuda, *topk_inputs(q + n + d, q, n, d,
                                                 valid_frac))
    before = distance_topk_cuda.launches
    got = ops.distance_topk(qs, ps, labs, valid, k=k, metric=metric)
    # one launch, except in the wide regime past MAX_K
    rounds = (1 if n <= SMALL_MAX_N or k <= MAX_K
              else q * -(-k // MAX_K))
    assert distance_topk_cuda.launches == before + rounds
    want = ref.distance_topk(qs, ps, labs, valid, k=k, metric=metric)
    next_d = ref.distance_topk(qs, ps, labs, valid, k=k + 1,
                               metric=metric)[0][:, k]
    assert_topk_match(*got, *want, next_d)
    assert (got[1].cpu().numpy()[got[0].cpu().numpy() >= 1.5e38] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,metric", [(60, 7, "l2"), (60, 20, "dot"),
                                        (3000, 7, "l2"), (3000, 20, "dot")])
def test_cuda_distance_topk_ties_go_to_the_lowest_index(cuda, n, k, metric):
    """Small-integer points, each three times: scores tie exactly and are
    exact in fp32, so the kernel gives the plain version's bits, lowest
    index first on ties, in both regimes (N = 60 and 3000)."""
    r = rng(n + k)
    base = r.integers(-2, 3, (n // 3, 6)).astype(np.float32)
    qs, ps, labs = _on(cuda, r.integers(-2, 3, (9, 6)).astype(np.float32),
                       np.concatenate([base, base, base]),
                       np.arange(n, dtype=np.int32))
    got = ops.distance_topk(qs, ps, labs, k=k, metric=metric)
    want = ref.distance_topk(qs, ps, labs, k=k, metric=metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,q,n,d,k,metric,valid_frac,ties,per_item",
                         BATCHED_TOPK_CASES)
def test_cuda_batched_distance_topk(cuda, b, q, n, d, k, metric, valid_frac,
                                    ties, per_item):
    """The batched regime against the plain version: one launch for the B
    items, k up to N and past it."""
    qs, ps, labs, valid = _on(cuda, *batched_inputs(
        b * 1000 + n + k, b, q, n, d, valid_frac, ties=ties,
        per_item_labels=per_item))
    before = distance_topk_cuda.launches
    got_d, got_l = ops.distance_topk(qs, ps, labs, valid, k=k, metric=metric)
    assert distance_topk_cuda.launches == before + 1
    assert got_d.shape == got_l.shape == (b, q, k)
    want_d, want_l = ref.distance_topk(qs, ps, labs, valid, k=k,
                                       metric=metric)
    next_d = ref.distance_topk(qs, ps, labs, valid, k=k + 1,
                               metric=metric)[0][..., k]
    flat = (lambda t: t.reshape(b * q, -1))
    assert_topk_match(flat(got_d), flat(got_l), flat(want_d), flat(want_l),
                      next_d.reshape(b * q))
    pad = got_d.cpu().numpy() >= 1.5e38
    assert (got_l.cpu().numpy()[pad] == 0).all()


@pytest.mark.cuda
def test_cuda_batched_distance_topk_wide_items(cuda):
    """Batched items past the batched regime's N: the wide regime, one
    launch an item."""
    b, n = 2, SMALL_MAX_N + 500
    qs, ps, labs, valid = _on(cuda, *batched_inputs(7, b, 3, n, 40, 0.8,
                                                    per_item_labels=True))
    before = distance_topk_cuda.launches
    got_d, got_l = ops.distance_topk(qs, ps, labs, valid, k=5)
    assert distance_topk_cuda.launches == before + b
    want_d, want_l = ref.distance_topk(qs, ps, labs, valid, k=5)
    next_d = ref.distance_topk(qs, ps, labs, valid, k=6)[0][..., 5]
    assert_topk_match(got_d.reshape(b * 3, 5), got_l.reshape(b * 3, 5),
                      want_d.reshape(b * 3, 5), want_l.reshape(b * 3, 5),
                      next_d.reshape(b * 3))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["knn_distance", "wide", "batched"])
def test_cuda_distance_kernels_give_the_same_bits_twice(cuda, regime):
    """No atomics and a fixed order of every sum and merge: two runs on the
    same inputs give the same bits."""
    r = rng(11)
    if regime == "batched":
        args = _on(cuda, *batched_inputs(3, 4, 1, 64, 1024, 0.8))
        run = (lambda: ops.distance_topk(*args, k=16, metric="dot"))
    else:
        qs, ps, labs, valid = _on(cuda, *topk_inputs(5, 300, 5000, 217, 0.9))
        run = ((lambda: (ops.knn_distance(qs, ps),))
               if regime == "knn_distance"
               else (lambda: ops.distance_topk(qs, ps, labs, valid, k=6)))
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


# the row lengths of each regime (a warp, a block a row) and the path's:
# the reduce's 5, the shard's 2875; every CAP of the k-best
TOPK_M = (1, 5, 2875, 20_000)
TOPK_K = (1, 5, 6, 8, 9, 16, 17, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("q,m,k,seeded", [
    (1, 1, 1, False), (9, 3, 5, True), (300, 2875, 6, True),
    (20, 10, 17, False), (1024, 2875, 5, False), (7, 65, 3, True),
    (5, 1025, 32, True),
] + [(33, m, k, seeded) for m in TOPK_M for k in TOPK_K
     for seeded in (False, True)])
def test_cuda_candidate_topk(cuda, q, m, k, seeded):
    args = _on(cuda, *candidates(q + m + k, q, m, k, seeded))
    before = candidate_topk_cuda.launches
    got = ops.candidate_topk(*args, k=k)
    want = ref.candidate_topk(*args, k=k)
    assert candidate_topk_cuda.launches == before + 1
    assert_topk_match(*got, *want, rtol=0, atol=0)
    for a, b in zip(got, ops.candidate_topk(*args, k=k)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,seeded", [(40, 5, True), (40, 9, False),
                                        (600, 6, True), (2875, 5, True),
                                        (2875, 32, False), (5000, 17, True)])
def test_cuda_candidate_topk_ties_go_to_the_lowest_column(cuda, m, k, seeded):
    """Rows of few distinct values and BIG padding: each label names its
    column, so the labels show which of equal candidates won (the seed,
    then the lowest column)."""
    r = rng(m + k)
    q = 40
    d = r.integers(0, 3, (q, m)).astype(np.float32)
    d[r.random((q, m)) < 0.3] = BIG
    d[0] = BIG                                    # a row of padding only
    lab = np.broadcast_to(np.arange(k, k + m, dtype=np.int32), (q, m)).copy()
    init_d = init_l = None
    if seeded:
        init_d = np.sort(r.integers(0, 3, (q, k)).astype(np.float32), axis=1)
        init_d[1] = BIG
        init_l = np.broadcast_to(np.arange(k, dtype=np.int32), (q, k)).copy()
    args = _on(cuda, d, lab, init_d, init_l)
    got_d, got_l = ops.candidate_topk(*args, k=k)
    want_d, want_l = ref.candidate_topk(*args, k=k)
    np.testing.assert_array_equal(np_of(got_d), np_of(want_d))
    real = np_of(want_d) < BIG / 2
    np.testing.assert_array_equal(np_of(got_l)[real], np_of(want_l)[real])
    if not seeded:   # unseeded slots are (BIG, label 0)
        assert (np_of(got_l)[~real] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,m,k", [(1, 9, 5, 5), (7, 1024, 5, 5),
                                     (7, 300, 6, 6), (3, 50, 40, 8),
                                     (2, 20, 700, 17)])
def test_cuda_candidate_topk_reads_a_stack_in_place(cuda, p, q, m, k):
    """A [P, Q, M] stack is one selection over its parts in order: the
    shard reduce's S - 1 folds in one launch, equal to the pairwise fold."""
    r = rng(p * q + m)
    d = np.sort(r.integers(0, 9, (p, q, m)).astype(np.float32), axis=-1)
    lab = r.integers(0, 100, (p, q, m)).astype(np.int32)
    init_d = np.sort(r.integers(0, 9, (q, k)).astype(np.float32), axis=1)
    init_l = r.integers(0, 100, (q, k)).astype(np.int32)
    args = _on(cuda, d, lab, init_d, init_l)
    before = candidate_topk_cuda.launches
    got = ops.candidate_topk(*args, k=k)
    assert candidate_topk_cuda.launches == before + 1
    want = ref.candidate_topk(*args, k=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fold_d, fold_l = args[2], args[3]
    for i in range(p):
        fold_d, fold_l = ref.candidate_topk(args[0][i], args[1][i], fold_d,
                                            fold_l, k=k)
    assert torch.equal(got[0], fold_d) and torch.equal(got[1], fold_l)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d", [
    (1, 1, 1), (70, 130, 217), (3, 65, 1000),
    # off the 128 x 64 tile grid
    (1, 2875, 217), (127, 2875, 1024), (129, 5000, 1), (129, 1, 217),
    (127, 5000, 217), (1024, 2875, 217),    # kNN stage 1
])
def test_cuda_knn_distance(cuda, q, n, d):
    r = rng(q + n + d)
    qs, ps = _on(cuda, normal(r, q, d), normal(r, n, d))
    before = knn_distance_cuda.launches
    assert_close(ops.knn_distance(qs, ps), ref.knn_distance(qs, ps))
    assert knn_distance_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d,b,n_keys", [
    (1, 1, 1, 1, 1), (30, 120, 217, 40, 7), (4, 50, 500, 70, 3),
    # B off every tile, features past one staged slice, one key for all
    (9, 500, 217, 131, 1), (3, 4000, 300, 3100, 40), (33, 90, 17, 257, 5),
])
def test_cuda_refine_distances(cuda, q, n, d, b, n_keys):
    """Arbitrary idx, with no bucket structure: slots that share a key hold
    other rows than the staged ones and are summed from device memory."""
    r = rng(q + n + d + b)
    qs, xs, idx, valid, bucket_of = _on(
        cuda, normal(r, q, d), normal(r, n, d),
        r.integers(-2, n + 2, (q, b)).astype(np.int32),
        r.random((q, b)) < 0.7,
        r.integers(-1, n_keys + 1, n).astype(np.int32))
    got = ops.refine_distances(qs, xs, idx, valid, bucket_of,
                               n_buckets=n_keys)
    assert_close(got, ref.refine_distances(qs, xs, idx, valid))
    assert torch.equal(got >= BIG / 2, ~valid)


def _refinement(dev, n, d, q, ratio, budget, hot, dead, seed):
    """A refinement selection of the kNN path on a small shard: the port's
    own aggregates, each query's ranking by its centroid distances, and
    ``refinement_indices`` at ``budget``.  With ``hot`` every query ranks
    the largest bucket first; the first ``dead`` rows are all invalid."""
    from repro_torch.apps import knn
    from repro_torch.core import aggregate as agg_lib
    from repro_torch.core import correlation, lsh
    from repro_torch.data.synthetic import make_mfeat_like

    x, y = make_mfeat_like(torch.Generator().manual_seed(seed),
                           n_points=n + q, n_features=d, device="cpu")
    params = lsh.init_lsh(torch.Generator().manual_seed(seed + 1), d,
                          lsh.config_for_compression(n, ratio), device="cpu")
    agg = knn.build_knn_aggregates(x[q:], y[q:], params, 10).agg
    corr = -ref.knn_distance(x[:q], agg.means)
    if hot:
        corr[:, int(agg.counts.argmax())] = 1.0
    ranking = correlation.rank_buckets_multi(corr, agg.counts)
    idx, valid = agg_lib.refinement_indices(agg, ranking, budget)
    valid[:dead] = False
    return ([t.to(dev) for t in (x[:q], x[q:], idx, valid, agg.bucket_of)],
            agg.n_buckets)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,q,ratio,budget,hot,dead", [
    (4000, 217, 64, 20.0, 200, False, 0),    # ~10 buckets a query
    (4000, 217, 100, 20.0, 131, True, 3),    # one bucket for 100 queries
    (3000, 50, 40, 150.0, 600, False, 0),    # buckets past one 64-row tile
    (2000, 300, 20, 10.0, 63, True, 0),      # features past one slice
    (6000, 217, 1024, 100.0, 60, False, 1024),   # every slot invalid
])
def test_cuda_refine_distances_on_a_refinement_selection(
        cuda, n, d, q, ratio, budget, hot, dead):
    """The path's selections, made of whole bucket runs and a partial last
    run: equal to the plain version, BIG exactly where not valid, the same
    bits on two runs."""
    (qs, xs, idx, valid, bucket_of), n_keys = _refinement(
        cuda, n, d, q, ratio, budget, hot, dead, seed=n + q)
    before = refine_distances_cuda.launches
    got = ops.refine_distances(qs, xs, idx, valid, bucket_of,
                               n_buckets=n_keys)
    assert refine_distances_cuda.launches == before + 1
    want = ref.refine_distances(qs, xs, idx, valid)
    assert torch.equal(got >= BIG / 2, ~valid)
    assert_close(got[valid], want[valid])
    again = ops.refine_distances(qs, xs, idx, valid, bucket_of,
                                 n_buckets=n_keys)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("qn,un,ni", [(16, 32, 20), (64, 130, 64),
                                      (5, 7, 300), (70, 300, 1777)])
def test_cuda_cf_weights(cuda, qn, un, ni):
    args = _on(cuda, *cf_inputs(qn + un + ni, qn, un, ni))
    assert_close(ops.cf_weights(*args), ref.cf_weights(*args), rtol=CF_TOL,
                 atol=CF_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("qn,un,ni,b,use_frac", [
    (4, 30, 25, 7, 0.6), (9, 64, 130, 17, 0.6), (3, 50, 2100, 300, 0.9),
    (2, 20, 40, 6, 0.0), (5, 10, 33, 0, 1.0),
])
def test_cuda_cf_refine(cuda, qn, un, ni, b, use_frac):
    r = rng(qn + un + ni + b)
    a, am, u, um = cf_inputs(qn * 100 + b, qn, un, ni)
    idx = r.integers(-2, un + 2, (qn, b)).astype(np.int32)
    args = _on(cuda, a, am, u, um, idx, r.random((qn, b)) < use_frac)
    before = cf_refine_cuda.launches
    got = ops.cf_refine(*args, shrink=8.0)
    assert cf_refine_cuda.launches == before + 1
    want = ref.cf_refine(*args, shrink=8.0)
    for g, w, name in zip(got, want, ("w_ref", "num_delta", "den_delta")):
        assert_close(g, w, rtol=CF_TOL, atol=CF_TOL, err_msg=name)
    unused = ~args[5].cpu().numpy()
    assert (got[0].cpu().numpy()[unused] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("qn,un,ni,density,skew,mask_values", CF_SPARSE_CASES)
def test_cuda_cf_weights_sparse(cuda, qn, un, ni, density, skew,
                                mask_values):
    """Any density, skewed or not, and mask values other than 0 and 1; an
    active or neighbour user whose centred ratings are all 0 (row 0) or who
    rated nothing (row 1) has weights of exactly 0."""
    args = _on(cuda, *cf_sparse_inputs(qn + un + ni, qn, un, ni, density,
                                       skew, mask_values))
    before = cf_weights_cuda.launches
    got = ops.cf_weights(*args)
    assert cf_weights_cuda.launches == before + 1
    assert_close(got, ref.cf_weights(*args), rtol=CF_TOL, atol=CF_TOL)
    assert bool((got[:2] == 0).all()) and bool((got[:, :2] == 0).all())


def _refine_slots(seed, qn, un, b, use_frac):
    """[qn, b] selected users with duplicates and out-of-range indices,
    and their gate."""
    r = rng(seed)
    idx = r.integers(-2, un + 2, (qn, b)).astype(np.int32)
    if b >= 2:
        idx[:, 1] = idx[:, 0]          # a duplicate in every query
    return idx, r.random((qn, b)) < use_frac


@pytest.mark.cuda
@pytest.mark.parametrize("qn,un,ni,density,skew,mask_values", [
    *CF_SPARSE_CASES,
    (2, 6, 41_000, 0.01, 0.8, (1.0,)),   # three passes over the items
])
@pytest.mark.parametrize("b,use_frac", [(0, 1.0), (7, 0.0), (40, 0.7)])
def test_cuda_cf_refine_sparse(cuda, qn, un, ni, density, skew, mask_values,
                               b, use_frac):
    """Any density and mask values; duplicate and out-of-range indices, all
    slots unused, B = 0.  A slot whose selected user's centred ratings are
    all 0 (row 0) or who rated nothing (row 1), or whose query is such a
    row, has a weight of exactly 0."""
    a, am, u, um = cf_sparse_inputs(qn * 7 + un + ni, qn, un, ni, density,
                                    skew, mask_values)
    idx, use = _refine_slots(qn + b, qn, un, b, use_frac)
    args = _on(cuda, a, am, u, um, idx, use)
    before = cf_refine_cuda.launches
    got = ops.cf_refine(*args, shrink=8.0)
    assert cf_refine_cuda.launches == before + 1
    want = ref.cf_refine(*args, shrink=8.0)
    for g, w, name in zip(got, want, ("w_ref", "num_delta", "den_delta")):
        assert g.shape == w.shape
        assert_close(g, w, rtol=CF_TOL, atol=CF_TOL, err_msg=name)
    w = got[0].cpu().numpy()
    rows = np.clip(idx, 0, un - 1)
    zero = ~use | (rows <= 1) | (np.arange(qn)[:, None] <= 1)
    assert (w[zero] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["cf_weights", "cf_refine"])
def test_cuda_cf_kernels_give_the_same_bits_twice(cuda, op):
    """No atomics and one fixed order of every sum: two runs on the same
    inputs give the same bits."""
    a, am, u, um = cf_sparse_inputs(5, 64, 300, 3000, 0.02, 0.8)
    if op == "cf_weights":
        args = _on(cuda, a, am, u, um)
        run = (lambda: (ops.cf_weights(*args),))
    else:
        args = _on(cuda, a, am, u, um, *_refine_slots(6, 64, 300, 60, 0.8))
        run = (lambda: ops.cf_refine(*args, shrink=8.0))
    for one, two in zip(run(), run()):
        assert torch.equal(one, two)


def _same_bits(got, want):
    for g, w, name in zip(got, want, ("sr", "sr2", "s", "c")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), (
            f"{name}: {int((g != w).sum())} entries differ, largest gap "
            f"{float((g - w).abs().max()):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("nu,ni,k,layout", CF_AGGREGATE_CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_cf_aggregate(cuda, nu, ni, k, layout, offset):
    """The plain version's bits, at every bucket layout: empty buckets, one
    bucket of every user, one user a bucket, a bucket of most users, one
    user; item counts off a multiple of 4.  ``offset`` 1 starts the rows
    one float past a 16-byte boundary (the kernel's one-float loads)."""
    x, m, ids = _on(cuda, *cf_aggregate_inputs(nu + ni + k, nu, ni, k,
                                               layout))
    if offset:
        x, m = (torch.empty(t.numel() + offset, device=cuda)[offset:]
                .view(t.shape).copy_(t) for t in (x, m))
    args = cf_aggregate_args(x, m, ids, k)
    before = cf_aggregate_cuda.launches
    got = ops.cf_aggregate(*args)
    assert cf_aggregate_cuda.launches == before + 1
    _same_bits(got, ref.cf_aggregate(*args))
    _same_bits(ops.cf_aggregate(*args), got)


@pytest.mark.cuda
def test_cuda_cf_aggregate_at_the_cf_shard_shape(cuda):
    """A map task of the CF cells: 6,002 users x 17,700 items at density
    0.012 with Zipf item popularity, K 300, the buckets skewed; the plain
    version's bits."""
    g = torch.Generator(cuda).manual_seed(29)
    nu, ni, k = 6002, 17_700, 300
    pop = (1.0 + torch.arange(ni, device=cuda)) ** -0.8
    pop = torch.clamp(pop / pop.mean() * 0.012, 0.0, 0.95)
    mask = (torch.rand((nu, ni), generator=g, device=cuda) < pop).float()
    ratings = torch.randint(1, 6, (nu, ni), generator=g,
                            device=cuda).float() * mask
    ids = (torch.rand(nu, generator=g, device=cuda) ** 3 * k).int()
    args = cf_aggregate_args(ratings, mask, ids, k)
    _same_bits(ops.cf_aggregate(*args), ref.cf_aggregate(*args))


@pytest.mark.cuda
def test_cuda_cf_aggregate_launches_once_a_map_task(cuda, monkeypatch):
    """One launch a map task: 8 in a CF ``run_accurateml`` job of 8 map
    tasks, none in its exact job or in a kNN job; no CUDA tensor reaches
    the plain version."""
    from repro_torch.apps import cf, knn

    plain = ref.cf_aggregate

    def cpu_only(*args):
        assert all(a.device.type == "cpu" for a in args)
        return plain(*args)

    monkeypatch.setattr(ref, "cf_aggregate", cpu_only)
    a, am, u, um = _on(cuda, *cf_sparse_inputs(8, 16, 800, 300, 0.1, 0.8))
    ops.reset_launch_counts()
    cf.run_accurateml(u, um, a, am, compression_ratio=20.0, eps_max=0.05,
                      lsh_generator=torch.Generator(cuda).manual_seed(1),
                      n_shards=8, device=cuda)
    assert ops.launch_counts()["cf_aggregate"] == 8
    cf.run_exact(u, um, a, am, n_shards=8, device=cuda)
    assert ops.launch_counts()["cf_aggregate"] == 8
    r = rng(9)
    x, q = _on(cuda, normal(r, 4000, 16), normal(r, 32, 16))
    y = torch.from_numpy(r.integers(0, 4, 4000).astype(np.int32)).to(cuda)
    ops.reset_launch_counts()
    knn.run_accurateml(x, y, q, k=5, n_classes=4, compression_ratio=20.0,
                       eps_max=0.01,
                       lsh_generator=torch.Generator(cuda).manual_seed(2),
                       n_shards=8, device=cuda)
    counts = ops.launch_counts()
    assert counts["cf_aggregate"] == 0 and counts["lsh_hash"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,h", [(64, 16, 4), (200, 217, 6), (33, 8, 1),
                                   (40_000, 217, 4), (300, 17_700, 4),
                                   (500, 3000, 8)])
def test_cuda_lsh_hash(cuda, n, d, h):
    r = rng(n + d + h)
    x, a, b = _on(cuda, normal(r, n, d), normal(r, d, h),
                  (r.random(h) * 4.0).astype(np.float32))
    before = lsh_hash_cuda.launches
    got = ops.lsh_hash(x, a, b, 4.0)
    assert lsh_hash_cuda.launches == before + 1
    # floor() at a bucket border: off by one on under 0.1 % of entries
    diff = (got.long() - ref.lsh_hash(x, a, b, 4.0).long()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3


def _lsh_case(dev, n, d, h, offset=0, scale=1.0):
    """[n, d] data starting ``offset`` floats into its buffer (an unaligned
    start for offsets 1-3), [d, h] projections, [h] offsets in [0, 4)."""
    r = rng(n + d + h + offset)
    buf = th(normal(r, n * d + offset) * scale).to(dev)
    x = buf[offset:].view(n, d)
    a, b = _on(dev, normal(r, d, h), (r.random(h) * 4.0).astype(np.float32))
    return x, a, b


def _check_lsh_epilogues(x, a, b, base, factor):
    """Both epilogues against the plain versions, a launch each: hashes off
    by at most one on under 0.1 % of entries (floor() at a bucket border);
    ids equal on every row whose hashes all equal the plain ones, and rows
    with a flip under 0.1 %."""
    before = lsh_hash_cuda.launches
    got = ops.lsh_hash(x, a, b, 4.0)
    ids = ops.lsh_bucket_ids(x, a, b, 4.0, base=base, factor=factor)
    assert lsh_hash_cuda.launches == before + 2
    assert got.shape == (x.shape[0], a.shape[1]) and got.dtype == torch.int32
    assert ids.shape == (x.shape[0],) and ids.dtype == torch.int32
    diff = (got.long() - ref.lsh_hash(x, a, b, 4.0).long()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    flipped = (diff > 0).any(dim=1)
    assert float(flipped.float().mean()) < 1e-3
    want = ref.lsh_bucket_ids(x, a, b, 4.0, base=base, factor=factor)
    assert torch.equal(ids[~flipped], want[~flipped])
    assert bool(((ids >= 0) & (ids < -(-base // factor))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,h,offset", [
    (64, 16, 4, 0), (200, 217, 6, 0), (33, 8, 1, 0), (40_000, 217, 4, 0),
    (300, 17_700, 4, 0), (500, 3000, 8, 0),
    # shards that start at any row of a [N, 217] tensor: unaligned starts
    (40_000, 217, 4, 1), (40_000, 217, 4, 2), (40_000, 217, 4, 3),
    (777, 217, 4, 1), (6002, 17_700, 4, 3),
    # one row; rows not a multiple of the 64-row tile
    (1, 217, 4, 0), (1, 17_700, 4, 1), (9_001, 217, 4, 0),
    # 1, 8 and 12 hashes (12: every signature prime)
    (9_000, 217, 1, 0), (9_000, 217, 8, 2), (9_000, 217, 12, 1),
    (500, 17_700, 12, 0), (2000, 2000, 12, 0), (300, 5, 12, 3),
])
def test_cuda_lsh_epilogues(cuda, n, d, h, offset):
    x, a, b = _lsh_case(cuda, n, d, h, offset, scale=3.0)
    _check_lsh_epilogues(x, a, b, base=1009, factor=1)
    # nested: 16 x 1009 fine ids, each coarse id a run of 16 of them
    _check_lsh_epilogues(x, a, b, base=16 * 1009, factor=16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,h,offset", [(287_500, 217, 4, 0),
                                          (20_000, 217, 4, 3),
                                          (6002, 17_700, 4, 0),
                                          (1000, 17_700, 12, 1)])
def test_cuda_lsh_gives_the_same_bits_twice(cuda, n, d, h, offset):
    x, a, b = _lsh_case(cuda, n, d, h, offset)
    for run in (lambda: lsh_hash_cuda(x, a, b, 4.0),
                lambda: lsh_bucket_ids_cuda(x, a, b, 4.0, base=2875)):
        assert torch.equal(run(), run())


@pytest.mark.cuda
@pytest.mark.parametrize("base_buckets", [None, 4 * 97])
def test_cuda_bucket_ids_launch_lsh_hash_once(cuda, base_buckets):
    """core/lsh.py on a CUDA tensor: one launch of the kernel for
    bucket_ids, fine_bucket_ids and raw_hashes each, and no other path."""
    from repro_torch.core import lsh

    x, _, _ = _lsh_case(cuda, 5000, 217, 4)
    cfg = lsh.LSHConfig(n_hashes=4, bucket_width=4.0, n_buckets=97,
                        base_buckets=base_buckets)
    params = lsh.init_lsh(torch.Generator().manual_seed(3), 217, cfg,
                          device=cuda)
    for fn, plain in (
        (lsh.bucket_ids, lambda: ref.lsh_bucket_ids(
            x, params.a, params.b, 4.0, base=base_buckets or 97,
            factor=(base_buckets or 97) // 97)),
        (lsh.fine_bucket_ids, lambda: ref.lsh_bucket_ids(
            x, params.a, params.b, 4.0, base=base_buckets or 97)),
        (lsh.raw_hashes, lambda: ref.lsh_hash(x, params.a, params.b, 4.0)),
    ):
        before = lsh_hash_cuda.launches
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = fn(x, params)
            torch.cuda.synchronize()
        assert lsh_hash_cuda.launches == before + 1
        kernels = {e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        assert kernels and all("lsh_kernel" in k for k in kernels), kernels
        assert got.device == x.device
        agree = float((got == plain()).float().mean())
        assert agree > 0.999, fn.__name__


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda):
    r = rng(0)
    qs, ps = _on(cuda, normal(r, 4, 8), normal(r, 10, 8))
    labs = torch.zeros(10, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="labels"):
        ops.distance_topk(qs, ps, labs, k=3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.knn_distance(qs, ps.t().contiguous().t())
    with pytest.raises(ValueError, match="on cpu"):
        ops.knn_distance(qs, ps.cpu())
    with pytest.raises(ValueError, match="hashes"):
        ops.lsh_hash(qs, normal_on(cuda, 8, 13), normal_on(cuda, 13), 4.0)
    with pytest.raises(ValueError, match="base"):
        ops.lsh_bucket_ids(qs, normal_on(cuda, 8, 4), normal_on(cuda, 4), 4.0,
                           base=0)
    a, am, u, um = _on(cuda, *cf_inputs(0, 4, 10, 8))
    idx = torch.zeros((4, 3), dtype=torch.int64, device=cuda)
    use = torch.ones((4, 3), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="idx"):
        ops.cf_refine(a, am, u, um, idx, use, shrink=8.0)
    with pytest.raises(ValueError, match="users_mask"):
        ops.cf_weights(a, am, u, um[:, :5].contiguous())
    idx32, valid = idx.int(), use
    with pytest.raises(ValueError, match="bucket_of"):
        ops.refine_distances(qs, ps, idx32[:, :3], valid)
    with pytest.raises(ValueError, match="bucket_of"):
        ops.refine_distances(qs, ps, idx32, valid,
                             torch.zeros(3, dtype=torch.int32, device=cuda),
                             n_buckets=1)
    with pytest.raises(ValueError, match="dists"):
        ops.candidate_topk(torch.zeros(2, 3, 4, 5, device=cuda),
                           torch.zeros(2, 3, 4, 5, dtype=torch.int32,
                                       device=cuda), k=2)


def normal_on(dev, *shape):
    return th(normal(rng(len(shape)), *shape)).to(dev)


# ---------------------------------------------------------------------------
# decode attention.  bf16 caches are compared in f32 against the plain
# version on the same bf16 inputs.
# ---------------------------------------------------------------------------

CACHE_DTYPES = [torch.float32, torch.bfloat16]


def _agg_refine_case(dev, dtype, b, kb, cap, hkv, g, dk, dv, r, seed):
    """Selections repeat, ``use`` masks some, one selected bucket is empty
    and counts run past the capacity; with more than one sequence the last
    one's selection is fully masked."""
    x = rng(seed)
    q = th(normal(x, b, hkv, g, dk)).to(dev)
    ks = th(normal(x, b, kb, cap, hkv, dk)).to(dev, dtype)
    vs = th(normal(x, b, kb, cap, hkv, dv)).to(dev, dtype)
    counts = x.integers(0, 2 * cap + 2, (b, kb)).astype(np.int32)
    top = x.integers(0, kb, (b, r)).astype(np.int32)
    top[:, -1] = top[:, 0]                    # a duplicate selection
    counts[0, top[0, 1 % r]] = 0              # an empty selected bucket
    use = x.random((b, r)) < 0.8
    if b > 1:
        use[-1] = False
    return (q, ks, vs, th(counts).to(dev), th(top).to(dev), th(use).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CACHE_DTYPES)
@pytest.mark.parametrize("b,kb,cap,hkv,g,dk,dv,r", [
    (3, 8, 4, 2, 2, 16, 16, 3),               # smoke heads
    (4, 64, 32, 8, 4, 128, 128, 16),          # qwen3-8b, rf 0.25
    (4, 64, 32, 8, 4, 128, 128, 64),          # qwen3-8b, rf 1.0
    (1, 64, 32, 8, 4, 128, 128, 64),          # qwen3-8b prefill, rf 1.0
    (2, 128, 32, 8, 4, 128, 128, 100),        # R above the cluster's warps
    (2, 10, 40, 1, 8, 64, 48, 5),             # MQA, dv != dk, C > 32
    (2, 64, 32, 1, 8, 128, 128, 64),          # MQA: a cluster a sequence
    (4, 64, 32, 1, 128, 576, 512, 16),        # deepseek-v2-236b MLA, rf 0.25
    (1, 64, 32, 1, 128, 576, 512, 64),        # MLA prefill, rf 1.0
    (2, 64, 32, 1, 16, 576, 320, 16),         # a partial value tile
    (2, 16, 8, 2, 12, 32, 264, 5),            # partial head and value tiles
])
def test_cuda_agg_refine_attention(cuda, dtype, b, kb, cap, hkv, g, dk, dv,
                                   r):
    args = _agg_refine_case(cuda, dtype, b, kb, cap, hkv, g, dk, dv, r,
                            b + kb + r)
    scale = 1.0 / np.sqrt(dk)
    before = agg_refine_attention_cuda.launches
    got = ops.agg_refine_attention(*args, scale=scale)
    assert agg_refine_attention_cuda.launches == before + 1
    want = ref.agg_refine_attention(*args, scale=scale)
    for gt, w, name in zip(got, want, ("m", "l", "acc")):
        assert_close(gt, w, rtol=ATTN_TOL, atol=ATTN_TOL, err_msg=name)
    m, l, acc = (t.cpu().numpy() for t in got)
    assert np.isfinite(acc).all()
    if b > 1:
        assert (m[-1] <= ref.NEG / 2).all() and (l[-1] == 0).all()
        assert (acc[-1] == 0).all()
    again = ops.agg_refine_attention(*args, scale=scale)
    for gt, a in zip(got, again):             # a fixed merge order
        assert torch.equal(gt, a)


def _agg_attention_case(dev, dtype, b, s, kb, hq, hkv, dk, dv, seed):
    x = rng(seed)
    q = th(normal(x, b, hq, dk)).to(dev)
    kc = th(normal(x, b, s, hkv, dk)).to(dev, dtype)
    vc = th(normal(x, b, s, hkv, dv)).to(dev, dtype)
    bucket_of = th(x.integers(0, kb, (b, s)).astype(np.int32)).to(dev)
    mk = th(normal(x, b, kb, hkv, dk)).to(dev)
    mv = th(normal(x, b, kb, hkv, dv)).to(dev)
    counts = x.integers(0, 9, (b, kb)).astype(np.int32)
    refined = (x.random((b, kb)) < 0.3) & (counts > 0)
    return [q, kc, vc, bucket_of, mk, mv, th(counts).to(dev),
            th(refined).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CACHE_DTYPES)
@pytest.mark.parametrize("b,s,kb,hq,hkv,dk,dv", [
    (2, 64, 8, 4, 2, 16, 16),                 # smoke heads
    (4, 1024, 64, 32, 8, 128, 128),           # qwen3-8b
    (2, 128, 10, 8, 1, 64, 48),               # MQA, dv != dk
    (4, 1024, 64, 128, 1, 576, 512),          # deepseek-v2-236b MLA
    (2, 1024, 64, 16, 1, 576, 320),           # a partial value tile
    (2, 64, 8, 24, 2, 32, 264),               # partial head and value tiles
])
def test_cuda_aggregated_attention(cuda, dtype, b, s, kb, hq, hkv, dk, dv):
    case = _agg_attention_case(cuda, dtype, b, s, kb, hq, hkv, dk, dv,
                               s + kb)
    valid_len = th(np.asarray([s // 3, s, 1, s - 5][:b], np.int32)).to(cuda)
    scale = 1.0 / np.sqrt(dk)
    before = aggregated_attention_cuda.launches
    got = ops.aggregated_attention_decode(*case, scale=scale,
                                          valid_len=valid_len)
    assert aggregated_attention_cuda.launches == before + 1
    want = ref.aggregated_attention_decode(*case, scale=scale,
                                           valid_len=valid_len)
    assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert torch.equal(got, ops.aggregated_attention_decode(
        *case, scale=scale, valid_len=valid_len))
    # every bucket refined: exact attention over the written tokens
    case[7] = case[6] > 0
    assert_close(ops.aggregated_attention_decode(*case, scale=scale),
                 ref.aggregated_attention_decode(*case, scale=scale),
                 rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CACHE_DTYPES)
@pytest.mark.parametrize("b,s,kb,hq,hkv,valid,all_refined", [
    (1, 1024, 64, 32, 8, [128], True),        # qwen3-8b prefill, rf 1.0
    (1, 1024, 64, 32, 8, [128], False),       # qwen3-8b prefill, rf < 1
    (2, 1024, 64, 32, 8, [1000, 999], False),  # ragged valid_len
    (2, 1024, 64, 32, 8, [1000, 1024], True),
    (2, 1024, 64, 8, 1, [160, 1000], False),  # MQA: a cluster a sequence
])
def test_cuda_aggregated_attention_path_shapes(cuda, dtype, b, s, kb, hq,
                                               hkv, valid, all_refined):
    case = _agg_attention_case(cuda, dtype, b, s, kb, hq, hkv, 128, 128,
                               s + kb + valid[0])
    if all_refined:
        case[7] = case[6] > 0
    valid_len = th(np.asarray(valid, np.int32)).to(cuda)
    scale = 1.0 / np.sqrt(128)
    before = aggregated_attention_cuda.launches
    got = ops.aggregated_attention_decode(*case, scale=scale,
                                          valid_len=valid_len)
    assert aggregated_attention_cuda.launches == before + 1
    want = ref.aggregated_attention_decode(*case, scale=scale,
                                           valid_len=valid_len)
    assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert torch.equal(got, ops.aggregated_attention_decode(
        *case, scale=scale, valid_len=valid_len))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CACHE_DTYPES)
def test_cuda_aggregated_attention_all_empty_cache(cuda, dtype):
    case = _agg_attention_case(cuda, dtype, 2, 64, 8, 4, 2, 16, 16, 1)
    case[6] = torch.zeros_like(case[6])
    case[7] = torch.zeros_like(case[7])
    valid_len = torch.zeros(2, dtype=torch.int32, device=cuda)
    got = ops.aggregated_attention_decode(*case, scale=0.25,
                                          valid_len=valid_len)
    assert bool((got == 0).all())


@pytest.mark.cuda
def test_cuda_decode_attention_refuses_what_it_does_not_take(cuda):
    args = list(_agg_refine_case(cuda, torch.bfloat16, 2, 8, 4, 2, 2, 16,
                                 16, 3, 0))
    scale = 0.25

    def refine(**swap):
        a = dict(zip(("q", "k", "v", "counts", "top", "use"), args), **swap)
        return ops.agg_refine_attention(*a.values(), scale=scale)

    with pytest.raises(TypeError, match="top_idx"):
        refine(top=args[4].long())
    with pytest.raises(TypeError, match="use"):
        refine(use=args[5].int())
    with pytest.raises(TypeError, match="cache dtype"):
        refine(k=args[1].half(), v=args[2].half())
    with pytest.raises(ValueError, match="contiguous"):
        refine(k=args[1].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="on cpu"):
        refine(counts=args[3].cpu())
    with pytest.raises(ValueError, match="key width"):
        refine(q=args[0][..., :12].contiguous(),
               k=args[1][..., :12].contiguous())
    with pytest.raises(ValueError, match="value width"):
        refine(v=args[2][..., :12].contiguous())
    case = _agg_attention_case(cuda, torch.float32, 2, 64, 8, 5, 2, 16, 16,
                               0)
    with pytest.raises(ValueError, match="query heads over"):
        ops.aggregated_attention_decode(*case, scale=scale)
    with pytest.raises(ValueError, match="key width"):
        refine(q=normal_on(cuda, 2, 2, 2, 1032),
               k=normal_on(cuda, 2, 8, 4, 2, 1032).to(torch.bfloat16))
    case = _agg_attention_case(cuda, torch.float32, 2, 64, 8, 4, 2, 16, 16,
                               0)
    with pytest.raises(TypeError, match="valid_len"):
        ops.aggregated_attention_decode(
            *case, scale=scale, valid_len=torch.ones(2, device=cuda))
    with pytest.raises(TypeError, match="refined"):
        ops.aggregated_attention_decode(*case[:7], case[7].int(),
                                        scale=scale)


# the arch phase's head shapes (Hkv, G, dk): zamba2-7b's shared attention,
# gemma3-1b's MQA, qwen2-vl-2b's GQA, whisper-tiny's MHA
ARCH_HEADS = [(32, 1, 112), (1, 4, 256), (2, 6, 128), (6, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CACHE_DTYPES)
@pytest.mark.parametrize("hkv,g,dk", ARCH_HEADS)
def test_cuda_decode_kernels_at_the_arch_head_shapes(cuda, dtype, hkv, g,
                                                     dk):
    """Both decode-attention kernels and the selection at the other five
    families' head shapes, on the LM path's cache (4 slots, 64 buckets of
    32 slots over 1024 tokens; rf 0.25 and 1.0, and the batch-1 prefill),
    against their plain versions; the same bits on a second run."""
    scale = 1.0 / np.sqrt(dk)
    for b, r in ((4, 16), (4, 64), (1, 64)):
        args = _agg_refine_case(cuda, dtype, b, 64, 32, hkv, g, dk, dk, r,
                                hkv + g + dk + r)
        got = ops.agg_refine_attention(*args, scale=scale)
        want = ref.agg_refine_attention(*args, scale=scale)
        for gt, w, name in zip(got, want, ("m", "l", "acc")):
            assert_close(gt, w, rtol=ATTN_TOL, atol=ATTN_TOL,
                         err_msg=f"agg_refine {name} b={b} r={r}")
        for gt, a in zip(got, ops.agg_refine_attention(*args, scale=scale)):
            assert torch.equal(gt, a)
    for b, valid in ((4, [1000, 64, 1024, 500]), (1, [64])):
        case = _agg_attention_case(cuda, dtype, b, 1024, 64, hkv * g, hkv,
                                   dk, dk, dk + b)
        valid_len = th(np.asarray(valid, np.int32)).to(cuda)
        got = ops.aggregated_attention_decode(*case, scale=scale,
                                              valid_len=valid_len)
        assert_close(got, ref.aggregated_attention_decode(
            *case, scale=scale, valid_len=valid_len), rtol=ATTN_TOL,
            atol=ATTN_TOL)
        assert torch.equal(got, ops.aggregated_attention_decode(
            *case, scale=scale, valid_len=valid_len))
    # the selection: the pooled query over the centroids of this dtype's
    # keys (f32 means), 64 buckets, some empty
    x = rng(dk + g)
    for b, k in ((4, 16), (4, 64), (1, 64)):
        q = th(normal(x, b, 1, hkv * dk)).to(cuda)
        cents = th(normal(x, b, 64, hkv * dk)).to(cuda, dtype).float()
        labels = torch.arange(64, dtype=torch.int32, device=cuda)
        valid = th(x.random((b, 64)) < 0.8).to(cuda)
        before = distance_topk_cuda.launches
        got_d, got_l = ops.distance_topk(q, cents, labels, valid, k=k,
                                         metric="dot")
        assert distance_topk_cuda.launches == before + 1
        want_d, want_l = ref.distance_topk(q, cents, labels, valid, k=k,
                                           metric="dot")
        next_d = ref.distance_topk(q, cents, labels, valid, k=k + 1,
                                   metric="dot")[0][..., k]
        assert_topk_match(got_d.reshape(b, k), got_l.reshape(b, k),
                          want_d.reshape(b, k), want_l.reshape(b, k),
                          next_d.reshape(b))
        again = ops.distance_topk(q, cents, labels, valid, k=k, metric="dot")
        assert torch.equal(got_d, again[0]) and torch.equal(got_l, again[1])


# ---------------------------------------------------------------------------
# the aggregate store on the card: merges, ingest and snapshots give the
# same bits on every run (no float index_add_ or scatter_add_ on the path)
# ---------------------------------------------------------------------------

def _store_servable(dev, kind, seed=0):
    from repro_torch.apps.cf import CFServable
    from repro_torch.apps.knn import KNNServable

    r = rng(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    if kind == "knn":
        x = normal(r, 20_000, 217)
        y = r.integers(0, 10, 20_000).astype(np.int32)
        return KNNServable(x, y, n_classes=10, k=5, lsh_generator=gen,
                           device=dev)
    stars = r.integers(1, 6, (1_000, 2_000)).astype(np.float32)
    m = (r.random((1_000, 2_000)) < 0.05).astype(np.float32)
    return CFServable(stars * m, m, lsh_generator=gen, device=dev)


_LEVEL_FIELDS = {
    "knn": ("bucket_labels", "spread", "dispersion"),
    "cf": ("profile", "profile_mask", "s", "c", "cvar"),
}


def _level_tensors(kind, prepared):
    agg = prepared.agg
    return [agg.means, agg.counts, agg.perm, agg.offsets, agg.bucket_of,
            *(getattr(prepared, f) for f in _LEVEL_FIELDS[kind])]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_cuda_store_merged_levels_equal_cold_builds_twice(cuda, kind):
    from repro_torch.store import (
        SOURCE_BUILT, SOURCE_MERGED, AggregateStore,
    )

    runs = []
    for _ in range(2):
        warm = _store_servable(cuda, kind)
        spec = warm.pyramid_spec
        warm.store.get(warm, spec.ratio(0))
        levels = []
        for level in (1, 3, spec.n_levels - 1):
            merged, src = warm.store.get(warm, spec.ratio(level))
            cold, src_cold = AggregateStore().get(
                _store_servable(cuda, kind), spec.ratio(level))
            assert (src, src_cold) == (SOURCE_MERGED, SOURCE_BUILT)
            for m, c in zip(_level_tensors(kind, merged),
                            _level_tensors(kind, cold)):
                assert m.device.type == "cuda" and torch.equal(m, c)
            levels.append(_level_tensors(kind, merged))
        runs.append(levels)
    for one, two in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_cuda_streaming_ingest_gives_the_same_bits_twice(cuda):
    from repro_torch.core import aggregate as agg_lib
    from repro_torch.core import lsh as lsh_lib
    from repro_torch.store import StreamingAggregate

    x = th(normal(rng(3), 30_000, 217)).to(cuda)
    params = lsh_lib.init_lsh(torch.Generator().manual_seed(4), 217,
                              lsh_lib.LSHConfig(n_buckets=8192), device=cuda)
    cuts = [0, 1, 4_097, 9_000, 21_000, 30_000]
    runs = []
    for _ in range(2):
        stream = StreamingAggregate(params, 217, capacity=30_000, chunk=4096,
                                    extra_shapes={"sumsq": (217,)},
                                    device=cuda)
        before = lsh_hash_cuda.launches
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            stream.append(x[lo:hi], sumsq=x[lo:hi] * x[lo:hi])
        assert lsh_hash_cuda.launches - before == sum(
            -(-(hi - lo) // 4096) for lo, hi in zip(cuts[:-1], cuts[1:]))
        runs.append(stream.level0())
    (s1, i1, n1), (s2, i2, n2) = runs
    assert n1 == n2 == 30_000
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    ids = lsh_lib.fine_bucket_ids(x, params)
    cold = agg_lib.bucket_index(ids, 8192)
    agg, sums, sumsq = agg_lib.aggregate_with_moments(x, ids, 8192)
    assert torch.equal(s1["counts"], agg.counts)
    for f in ("perm", "offsets", "bucket_of"):
        assert torch.equal(getattr(i1, f), getattr(i2, f))
        assert torch.equal(getattr(i1, f), getattr(cold, f))
    assert_close(s1["sums"], sums)
    assert_close(s1["sumsq"], sumsq)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_cuda_store_save_and_restore_twice(cuda, kind, tmp_path):
    from repro_torch.store import SOURCE_RESTORED, AggregateStore

    s = _store_servable(cuda, kind)
    ratio = s.pyramid_spec.ratio(2)
    built = s.build(ratio)
    assert s.store.save(tmp_path / "snap") == 1
    if kind == "knn":
        batch = (th(normal(rng(9), 64, 217)).to(cuda),)
    else:
        batch = (s.ratings[:64], s.mask[:64])
    want = s.run(built, batch, refine_budget=200)
    for _ in range(2):
        fresh = AggregateStore()
        assert fresh.restore(tmp_path / "snap", [s]) == 1
        restored, source = fresh.get(s, ratio)
        assert source == SOURCE_RESTORED
        for r, b in zip(_level_tensors(kind, restored),
                        _level_tensors(kind, built)):
            assert r.device.type == "cuda" and torch.equal(r, b)
        got = s.run(restored, batch, refine_budget=200)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_checksum_gives_the_same_number_twice(cuda):
    from repro_torch.serve.servable import _checksum

    a = th(normal(rng(5), 287_500, 217)).to(cuda)
    assert _checksum(a) == _checksum(a)
    assert _checksum(a) == _checksum(a.clone())
    b = a.clone()
    b[[0, 1]] = a[[1, 0]]
    assert _checksum(b) != _checksum(a)


# ---------------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------------

def _card_server(dev, kind, seed=0, **kw):
    """A one-servable server on the card with a fixed cost model (1 s of
    budget buys eps 1.0) and ema 0: grants depend on deadlines only."""
    from repro_torch.core.budget import BudgetPolicy, CostModel
    from repro_torch.serve import (
        ContinuousBatcher, DeadlineController, Server,
    )

    servable = _store_servable(dev, kind, seed)
    ctl = DeadlineController(
        BudgetPolicy(compression_ratio=20.0, eps_max=0.05,
                     degrade_floor=0.004), ema=0.0)
    ctl.set_model(kind, CostModel(c_stage2=1.0 / servable.n_points))
    return Server([servable], controller=ctl,
                  batcher=ContinuousBatcher(max_batch=8, pad_sizes=(8,)),
                  **kw), servable


def _card_payloads(servable, kind, n=12):
    if kind == "knn":
        return [(servable.train_x[i],) for i in range(n)]
    return [(servable.ratings[i], servable.mask[i]) for i in range(n)]


def _answers(resps):
    out = []
    for r in sorted(resps, key=lambda r: (r.rid, r.reexecuted)):
        for ans in (r.stage1, r.refined):
            out.append(ans if ans is None or isinstance(ans, int)
                       else np.asarray(ans))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_cuda_two_servers_answer_with_the_same_bits(cuda, kind):
    runs = []
    for _ in range(2):
        server, servable = _card_server(cuda, kind)
        for p in _card_payloads(servable, kind):
            server.submit(kind, p, deadline_s=30.0)
        resps = server.drain()
        assert all(r.eps_granted == 0.05 and r.refined is not None
                   for r in resps)
        runs.append(_answers(resps))
    for a, b in zip(*runs):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.cuda
def test_cuda_front_door_thread_serves_on_the_card(cuda):
    """The worker thread runs the card's work: every request is answered,
    with the answers a direct call on the main thread gives."""
    import threading

    from repro_torch.serve import FrontDoor, Response

    server, servable = _card_server(cuda, "knn")
    door = FrontDoor(server, default_deadline_s=30.0, queue_limit=64,
                     poll_s=0.001)
    seen = set()
    run = servable.run

    def recording_run(*args, **kwargs):
        seen.add(threading.current_thread() is threading.main_thread())
        return run(*args, **kwargs)

    servable.run = recording_run
    door.start()
    try:
        rids = [door.submit("knn", p)
                for p in _card_payloads(servable, "knn", 16)]
        got = [door.wait(rid, timeout_s=120.0) for rid in rids]
    finally:
        door.stop()
    assert seen == {False}
    assert all(isinstance(r, Response) for r in got)
    prepared = servable.build(20.0)
    q = servable.train_x[:16]
    direct = run(prepared, (q,), refine_budget=0)
    assert [r.stage1 for r in got] == direct[2].cpu().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_cuda_probe_counts_equal_the_launch_counts(cuda, kind):
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.probes import (
        install_kernel_probe, uninstall_kernel_probe,
    )

    server, servable = _card_server(cuda, kind)
    server.prewarm(kind)
    reg = MetricsRegistry()
    ops.reset_launch_counts()
    probe = install_kernel_probe(reg)
    try:
        for p in _card_payloads(servable, kind):
            server.submit(kind, p, deadline_s=30.0)
        server.drain()
    finally:
        uninstall_kernel_probe()
    launches = {op: n for op, n in ops.launch_counts().items() if n}
    assert launches and probe.calls() == launches
    assert {lbl["path"] for lbl, _ in
            reg.get("kernel_calls_total").series()} == {"cuda"}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "cf"])
def test_cuda_calibrate_covers_the_cards_time(cuda, kind):
    """``calibrate``'s stage-1 time is at least the CUDA-event time of the
    same runs (its first four calls: a warm-up, then the three it times):
    it times finished work, not launches.  The check is ``chip_smoke``'s
    own (``EventRecorder``, ``calibrate_covers``)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    server, servable = _card_server(cuda, kind)
    with chip_smoke.EventRecorder(torch, servable) as recorder:
        server.calibrate(kind, batch=8)
    out = chip_smoke.calibrate_covers(server, kind, recorder)
    assert out["t_eps0_ms"] >= out["event_ms"]


# ---------------------------------------------------------------------------
# the training path's attention backward and the checkpointer, on the card
# ---------------------------------------------------------------------------

BLOCKWISE_TOL = 1e-4   # relative to each gradient's largest entry, f32


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, None), (True, 200),
                                           (False, None)])
def test_cuda_blockwise_backward_against_autograd(cuda, causal, window):
    """``blockwise_sdpa``'s hand-written backward against autograd through
    the plain ``_sdpa`` on the same inputs (chunks of 256 and 512, f32)."""
    from repro_torch.models import layers

    b, s, hkv, g, hd = 1, 1024, 4, 2, 64
    r = rng(60)
    q, k, v, ct = _on(cuda, normal(r, b, s, hkv, g, hd),
                      normal(r, b, s, hkv, hd), normal(r, b, s, hkv, hd),
                      normal(r, b, s, hkv * g, hd))
    scale = hd ** -0.5
    mask = (layers.sliding_window_mask(s, window, cuda) if window
            else layers.causal_mask(s, cuda) if causal
            else torch.ones(s, s, dtype=torch.bool, device=cuda))[None]
    grads = []
    for blockwise in (True, False):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if blockwise:
            out = layers.blockwise_sdpa(*xs, scale=scale, causal=causal,
                                        window=window)
        else:
            out = layers._sdpa(xs[0].reshape(b, s, hkv * g, hd), xs[1],
                               xs[2], mask, scale=scale)
        out.backward(ct)
        grads.append([out.detach()] + [x.grad for x in xs])
    for name, got, want in zip(("out", "dq", "dk", "dv"), *grads):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= BLOCKWISE_TOL, (name, err)


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip_with_bf16_leaves(cuda, tmp_path):
    """CUDA tensors, bf16 among them, saved asynchronously and overwritten
    at once: the files hold the values at the save, and restore onto the
    card with their bits."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import AdamState

    r = rng(61)
    tree = {"params": {"embed": th(normal(r, 300, 64)).to(cuda,
                                                         torch.bfloat16),
                       "w": th(normal(r, 64, 64)).to(cuda)},
            "opt": AdamState(step=torch.tensor(5, dtype=torch.int32,
                                               device=cuda),
                             m={"w": th(normal(r, 64, 64)).to(cuda)},
                             v={"w": th(normal(r, 64, 64)).to(cuda)})}
    want = [t.clone() for t in (tree["params"]["embed"], tree["params"]["w"])]
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=False)
    tree["params"]["embed"].add_(1.0)
    tree["params"]["w"].mul_(2.0)
    ck.wait()
    restored, _ = ck.restore(tree)
    emb, w = restored["params"]["embed"], restored["params"]["w"]
    assert emb.device.type == "cuda" and emb.dtype == torch.bfloat16
    assert torch.equal(emb.view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(w, want[1])
    assert int(restored["opt"].step) == 5


# ---------------------------------------------------------------------------
# the mesh path: 2 ranks on the card under gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import _torch_mesh_ranks
    from repro_torch.launch.mesh import run_ranks

    r = rng(60)
    x, y = normal(r, 20_000, 217), r.integers(0, 10, 20_000).astype(np.int32)
    q, moe_x = normal(r, 64, 217), normal(r, 32, 64)
    args = (th(x), th(y), th(q), 5, th(moe_x))
    return args, run_ranks(_torch_mesh_ranks.card_world, 2, *args,
                           timeout=600)


@pytest.mark.cuda
def test_cuda_mesh_knn_merge_equals_single_device_to_the_bit(card_world):
    """Two ranks' merge on the kernels gives ``MapReduce(mesh=None)``'s
    two stacked shards merged, to the bit, and meters their bytes."""
    from repro_torch.apps import knn
    from repro_torch.core import engine

    (x, y, q, k, _), results = card_world
    dev = torch.device("cuda")
    x, y, q = x.to(dev), y.to(dev), q.to(dev)
    outs, nbytes = [], 0
    for s in range(2):
        eng = engine.MapReduce()
        rows = slice(s * 10_000, (s + 1) * 10_000)
        outs.append(eng.run(lambda a, b: knn.exact_map(a, b, q, k=k),
                            engine.CombineSpec("all_gather"), x[rows],
                            y[rows]))
        nbytes += eng.last_shuffle_bytes
    d, lab = knn.merge_topk(torch.cat([o[0] for o in outs]),
                            torch.cat([o[1] for o in outs]), k)
    for got in results:
        assert torch.equal(got["d"], d.cpu())
        assert torch.equal(got["l"], lab.cpu())
        assert got["shuffle"] == nbytes
        assert got["counts"]["distance_topk"] == 1
        assert got["counts"]["candidate_topk"] == 1


@pytest.mark.cuda
def test_cuda_moe_ep_equals_moe_dense(card_world):
    _, results = card_world
    for got in results:
        assert_close(got["ep"], got["dense"], rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_dryrun_cell_fits_and_builds_on_the_card(cuda):
    """One device's blocks of gemma3-1b decode_32k on 16 x 16 allocate on
    the card and are freed after; gemma3-1b long_500k at a cut depth,
    built on the card, is the dry run's stand-ins leaf by leaf."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("gemma3-1b", "decode_32k", False, save=False,
                          verbose=False)
    mem = rec["memory"]
    held = torch.cuda.memory_allocated()
    got = dryrun.allocate_on_card("gemma3-1b", "decode_32k", False)
    assert got["bytes"] == mem["argument_size_in_bytes"] + mem["unused"]
    assert got["allocated"] >= got["bytes"]
    assert torch.cuda.memory_allocated() == held
    cfg = dryrun.cut_depth(dryrun.cell_config("gemma3-1b", "long_500k"))
    shape = dryrun.SHAPES["long_500k"]
    cmp = dryrun.compare_build(cfg, shape, dryrun.build_cell(cfg, shape))
    assert cmp["mismatches"] == [] and cmp["bytes"] == cmp["counted"]


@pytest.mark.cuda
def test_examples_quickstart_launches_its_kernels_on_the_card(cuda):
    """``examples/torch_quickstart.py`` on the card returns 0 and launches
    the seven kNN and CF kernels, and no other."""
    from _torch_examples import load

    ops.reset_launch_counts()
    assert load("torch_quickstart").main(["--device", "cuda"]) == 0
    launched = {op for op, n in ops.launch_counts().items() if n}
    assert launched == {"distance_topk", "candidate_topk", "knn_distance",
                        "refine_distances", "lsh_hash", "cf_weights",
                        "cf_refine", "cf_aggregate"}
