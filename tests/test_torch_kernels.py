"""The port's kNN, CF, LSH and decode-attention kernels against the JAX
package's.

On the CPU the port's ``kernels.ops`` runs the plain PyTorch versions; they
are held against the JAX Pallas kernel bodies in interpret mode and against
the JAX plain versions, on the same numpy inputs.  The CUDA kernels
themselves are held against the plain versions by ``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import (
    BIG, CF_AGGREGATE_CASES, assert_close, assert_topk_match, candidates,
    cf_aggregate_args, cf_aggregate_inputs, cf_inputs, normal, np_of, rng,
    th, topk_inputs,
)
from repro.kernels import ref as _jref
from repro.kernels import topk_stream as jts
from repro.kernels import ops as jops
from repro.kernels.aggregated_attention import (
    aggregated_attention_pallas, masked_decode_attention,
)
from repro.kernels.cf_refine import cf_refine_pallas
from repro.kernels.cf_weights import cf_weights_pallas
from repro.kernels.distance_topk import distance_topk_pallas
from repro.kernels.knn_distance import knn_distance_pallas
from repro.kernels.lsh_hash import lsh_hash_pallas
from repro.kernels.refine_distances import refine_distances_pallas
from repro.kernels.topk_stream import candidate_topk_pallas
from repro_torch.core import aggregate as agg_lib
from repro_torch.core import lsh
from repro_torch.kernels import ops, ref, refine_schedule, topk_stream
from repro_torch.kernels.candidate_topk import candidate_topk_cuda
from repro_torch.kernels.distance_topk import distance_topk_cuda


jx = jax.numpy.asarray


class jref:
    """The JAX plain versions, jitted: one compile per shape instead of one
    per operation."""
    knn_distance = jax.jit(_jref.knn_distance)
    distance_topk = jax.jit(_jref.distance_topk, static_argnames=("k", "metric"))
    candidate_topk = jax.jit(_jref.candidate_topk, static_argnames=("k",))
    refine_distances = jax.jit(_jref.refine_distances)
    cf_weights = jax.jit(_jref.cf_weights)
    cf_refine = jax.jit(_jref.cf_refine, static_argnames=("shrink",))
    lsh_hash = jax.jit(_jref.lsh_hash, static_argnames=("width",))

# CF weights and sums: the reference's own kernel tolerance
# (tests/test_kernels.py:63,317), fp32 sums over items in another order.
CF_TOL = 2e-4


# ---------------------------------------------------------------------------
# knn_distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,d", [(1, 1, 1), (8, 16, 12), (130, 70, 217),
                                   (5, 300, 33)])
def test_knn_distance_parity(q, n, d):
    r = rng(q * 100 + n + d)
    qs, ps = normal(r, q, d), normal(r, n, d)
    got = ops.knn_distance(th(qs), th(ps))
    assert got.dtype == torch.float32 and got.shape == (q, n)
    assert_close(got, jref.knn_distance(jx(qs), jx(ps)))
    assert_close(got, knn_distance_pallas(jx(qs), jx(ps), interpret=True))
    assert (np_of(got) >= 0).all()


def test_knn_distance_clamps_at_zero():
    """A point equal to its query: the expanded form can round below 0."""
    r = rng(3)
    qs = normal(r, 6, 40) * 50
    got = np_of(ops.knn_distance(th(qs), th(qs)))
    assert (got >= 0).all()
    assert_close(np.diag(got), np.zeros(6), atol=1e-1)


# ---------------------------------------------------------------------------
# distance_topk
# ---------------------------------------------------------------------------

# ``pallas``: also hold the case against the Pallas body in interpret mode
# (slow on the CPU, so not every case)
@pytest.mark.parametrize("q,n,d,k,metric,valid_frac,pallas", [
    (1, 1, 1, 1, "l2", 1.0, True),
    (7, 3, 9, 5, "l2", 1.0, True),    # fewer points than k: BIG padding
    (33, 150, 40, 5, "l2", 0.8, False),
    (64, 40, 12, 3, "l2", 0.0, True),  # every point masked out
    (20, 260, 217, 8, "l2", 0.5, True),
    (17, 90, 24, 6, "dot", 0.8, True),
    (5, 100, 64, 8, "dot", 1.0, False),
])
def test_distance_topk_parity(q, n, d, k, metric, valid_frac, pallas):
    qs, ps, labs, valid = topk_inputs(q * 7919 + n * 31 + d, q, n, d,
                                       valid_frac)
    got_d, got_l = ops.distance_topk(th(qs), th(ps), th(labs), th(valid),
                                     k=k, metric=metric)
    assert got_d.dtype == torch.float32 and got_l.dtype == torch.int32
    assert got_d.shape == got_l.shape == (q, k)
    want_d, want_l = jref.distance_topk(jx(qs), jx(ps), jx(labs), jx(valid),
                                        k=k, metric=metric)
    next_d = ref.distance_topk(th(qs), th(ps), th(labs), th(valid), k=k + 1,
                               metric=metric)[0][:, k]
    # the plain versions agree on every slot, padding labels included
    assert_topk_match(got_d, got_l, want_d, want_l, next_d, real_only=False)
    if not pallas:
        return
    pal_d, pal_l = distance_topk_pallas(jx(qs), jx(ps), jx(labs), jx(valid),
                                        k=k, tq=64, tn=64, metric=metric,
                                        interpret=True)
    assert_topk_match(got_d, got_l, pal_d, pal_l, next_d)


def test_distance_topk_without_mask_and_padding_never_selected():
    """No mask is all valid; a masked point equal to the query (distance 0)
    never enters the top-k: padding is BIG, never zero."""
    r = rng(5)
    qs = normal(r, 6, 10)
    pts = np.concatenate([normal(r, 50, 10) + 30, qs])
    labs = np.concatenate([np.zeros(50, np.int32), np.ones(6, np.int32)])
    valid = np.concatenate([np.ones(50, bool), np.zeros(6, bool)])
    got_d, got_l = ops.distance_topk(th(qs), th(pts), th(labs), th(valid), k=4)
    assert (np_of(got_l) == 0).all() and (np_of(got_d) > 1.0).all()
    all_d, _ = ops.distance_topk(th(qs), th(pts), th(labs), k=4)
    want_d, _ = jref.distance_topk(jx(qs), jx(pts), jx(labs), k=4)
    assert_close(all_d, want_d)
    assert (np_of(all_d)[:, 0] < 1e-3).all()


def test_distance_topk_ties_go_to_the_lowest_index():
    """Exact ties (duplicated points) keep the lowest original index first,
    as jax.lax.top_k does; torch.topk would not promise it."""
    r = rng(8)
    base = r.integers(-2, 3, (12, 4)).astype(np.float32)
    pts = np.concatenate([base, base, base])          # every point 3 times
    labs = np.arange(36, dtype=np.int32)
    qs = r.integers(-2, 3, (9, 4)).astype(np.float32)
    got_d, got_l = ops.distance_topk(th(qs), th(pts), th(labs), k=7)
    want_d, want_l = jref.distance_topk(jx(qs), jx(pts), jx(labs), k=7)
    np.testing.assert_array_equal(np_of(got_d), np_of(want_d))
    np.testing.assert_array_equal(np_of(got_l), np_of(want_l))


@pytest.mark.parametrize("q,n,d,k,metric,valid_frac,dup", [
    (3, 100, 16, topk_stream.MAX_K + 8, "dot", 0.9, False),
    (2, 90, 8, 2 * topk_stream.MAX_K + 3, "l2", 1.0, True),   # exact ties
    (2, 50, 8, 70, "l2", 0.6, False),     # fewer points than k: padding
    (4, 40, 8, topk_stream.MAX_K + 1, "dot", 0.0, False),     # all masked
])
def test_select_in_rounds_ranks_as_one_pass(q, n, d, k, metric, valid_frac,
                                            dup):
    """The rounds of at most MAX_K that the CUDA wrapper takes for a wider
    k, here over the plain selection: the same scores in the same order and
    the same labels as one pass, padding (BIG, label 0)."""
    qs, ps, labs, valid = topk_inputs(q + n + k, q, n, d, valid_frac,
                                      n_labels=n)
    if dup:
        ps[n // 2:] = ps[:n - n // 2]
    args = (th(qs), th(ps), th(labs), th(valid))
    got_d, got_l = topk_stream.select_in_rounds(ref.distance_topk, *args,
                                                k=k, metric=metric)
    assert got_d.shape == got_l.shape == (q, k)
    assert got_l.dtype == torch.int32
    # one pass over each row alone: its products round as the rounds' do
    want_d, want_l = (torch.cat(t) for t in zip(*(
        ref.distance_topk(args[0][i:i + 1], *args[1:], k=k, metric=metric)
        for i in range(q))))
    assert_topk_match(got_d, got_l, want_d, want_l, rtol=0, atol=0)
    assert (np_of(got_l)[np_of(got_d) >= BIG / 2] == 0).all()
    if k <= n:
        jd, jl = jref.distance_topk(jx(qs), jx(ps), jx(labs), jx(valid), k=k,
                                    metric=metric)
        next_d = ref.distance_topk(*args, k=k + 1, metric=metric)[0][:, k]
        assert_topk_match(got_d, got_l, jd, jl, next_d)


def test_distance_topk_rejects_unknown_metric():
    r = rng(0)
    with pytest.raises(ValueError, match="metric"):
        ops.distance_topk(th(normal(r, 2, 3)), th(normal(r, 4, 3)),
                          th(np.zeros(4, np.int32)), k=1, metric="cosine")


# ---------------------------------------------------------------------------
# candidate_topk and the running k-best
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,m,k,seeded,pallas", [
    (1, 1, 1, False, True), (9, 3, 5, True, True), (40, 200, 8, True, False),
    (20, 10, 17, False, True), (33, 130, 6, False, False),
    (12, 64, 32, True, True),
])
def test_candidate_topk_parity(q, m, k, seeded, pallas):
    d, lab, init_d, init_l = candidates(q * 1009 + m + k, q, m, k, seeded)
    args = [th(d), th(lab)] + ([th(init_d), th(init_l)] if seeded else [])
    got_d, got_l = ops.candidate_topk(*args, k=k)
    assert got_d.shape == got_l.shape == (q, k)
    assert got_l.dtype == torch.int32
    jargs = [jx(d), jx(lab)] + ([jx(init_d), jx(init_l)] if seeded else [])
    want_d, want_l = jref.candidate_topk(*jargs, k=k)
    # a pure selection: both sides return the very same values
    assert_topk_match(got_d, got_l, want_d, want_l, real_only=False,
                      rtol=0, atol=0)
    if not pallas:
        return
    if not seeded:
        init_d = np.full((q, k), BIG, np.float32)
        init_l = np.zeros((q, k), np.int32)
    pal_d, pal_l = candidate_topk_pallas(jx(d), jx(lab), jx(init_d),
                                         jx(init_l), k=k, tq=64, tc=64,
                                         interpret=True)
    assert_topk_match(got_d, got_l, pal_d, pal_l, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_merge_kbest_tie_rule(k):
    """merge_kbest: the incumbent wins a tie, then the lowest column."""
    r = rng(k)
    best_d = np.sort(r.integers(0, 4, (10, k)).astype(np.float32), axis=1)
    best_l = r.integers(0, 50, (10, k)).astype(np.int32)
    cand_d = r.integers(0, 4, (10, 20)).astype(np.float32)
    cand_l = r.integers(0, 50, (10, 20)).astype(np.int32)
    got = topk_stream.merge_kbest(th(best_d), th(best_l), th(cand_d),
                                  th(cand_l), k)
    want = jax.jit(jts.merge_kbest, static_argnames=("k",))(
        jx(best_d), jx(best_l), jx(cand_d), jx(cand_l), k=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np_of(w))
    # and it is the seeded plain selection
    sel = ref.candidate_topk(th(cand_d), th(cand_l), th(best_d), th(best_l),
                             k=k)
    for g, s in zip(got, sel):
        np.testing.assert_array_equal(np_of(g), np_of(s))


@pytest.mark.parametrize("shape,mult,dim", [((5, 3), 4, 0), ((5, 3), 4, 1),
                                            ((8, 2), 4, 0), ((2, 3, 5), 8, -1)])
def test_pad_to_multiple(shape, mult, dim):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = topk_stream.pad_to_multiple(th(x), mult, dim, value=BIG)
    want = jts.pad_to_multiple(jx(x), mult, dim % len(shape), value=BIG)
    np.testing.assert_array_equal(np_of(got), np_of(want))


def test_fewer_candidates_than_k_pad_with_big_and_label_zero():
    got_d, got_l = ops.candidate_topk(th(np.array([[1.0, 2.0]], np.float32)),
                                      th(np.array([[4, 6]], np.int32)), k=4)
    np.testing.assert_array_equal(np_of(got_d)[0, :2], [1.0, 2.0])
    assert (np_of(got_d)[0, 2:] >= BIG / 2).all()
    np.testing.assert_array_equal(np_of(got_l)[0], [4, 6, 0, 0])


# ---------------------------------------------------------------------------
# refine_distances
# ---------------------------------------------------------------------------

def _reference_selection(n, d, q, ratio, budget, hot):
    """A kNN refinement selection built by the JAX package: its aggregates
    of a small shard, each query's ranking by its centroid distances, its
    ``refinement_indices``.  With ``hot`` every query ranks the largest
    bucket first.  Numpy arrays: queries, points, idx, valid, bucket_of,
    perm, offsets."""
    from repro.apps import knn as jknn
    from repro.core import aggregate as jagg
    from repro.core import correlation as jcorr
    from repro.core import lsh as jlsh
    from repro.data.synthetic import make_mfeat_like

    x, y = make_mfeat_like(jax.random.PRNGKey(n + q), n_points=n + q,
                           n_features=d, n_classes=6)
    cfg = jlsh.config_for_compression(n, ratio)
    params = jlsh.init_lsh(jax.random.PRNGKey(q), d, cfg)
    agg = jknn.build_knn_aggregates(x[q:], y[q:], params, 6).agg
    corr = -jref.knn_distance(x[:q], agg.means)
    if hot:
        corr = corr.at[:, int(np.argmax(np.asarray(agg.counts)))].set(1.0)
    ranking = jcorr.rank_buckets_multi(corr, agg.counts)
    idx, valid = jax.vmap(
        lambda r: jagg.refinement_indices(agg, r, budget))(ranking)
    return tuple(np.asarray(a) for a in (x[:q], x[q:], idx, valid,
                                         agg.bucket_of, agg.perm,
                                         agg.offsets))


# b: the width of a random selection, or (budget, ratio, hot) of a kNN
# refinement selection built by the JAX package, passed with the bucket of
# each row as the path passes it
@pytest.mark.parametrize("q,n,d,b", [(1, 1, 1, 1), (30, 120, 217, 40),
                                     (4, 50, 500, 7), (9, 33, 17, 64),
                                     (6, 600, 24, (45, 20.0, False)),
                                     (5, 500, 217, (23, 50.0, True))])
def test_refine_distances_parity(q, n, d, b):
    if isinstance(b, tuple):
        qs, xs, idx, valid, bucket_of, _, offsets = _reference_selection(
            n, d, q, *b)
        keys = (th(bucket_of.astype(np.int32)),)
        kw = {"n_buckets": len(offsets) - 1}
    else:
        r = rng(q + n * 13 + d * 101 + b)
        qs, xs = normal(r, q, d), normal(r, n, d)
        idx = r.integers(0, n, (q, b)).astype(np.int32)
        valid = r.random((q, b)) < 0.7
        keys, kw = (), {}
    got = ops.refine_distances(th(qs), th(xs), th(idx), th(valid), *keys,
                               **kw)
    assert got.shape == idx.shape and got.dtype == torch.float32
    assert_close(got, jref.refine_distances(jx(qs), jx(xs), jx(idx),
                                            jx(valid)))
    assert_close(got, refine_distances_pallas(jx(qs), jx(xs), jx(idx),
                                              jx(valid), interpret=True))
    assert ((np_of(got) >= BIG / 2) == ~valid).all()
    none = ops.refine_distances(th(qs), th(xs), th(idx),
                                th(np.zeros_like(valid)), *keys, **kw)
    assert (np_of(none) >= BIG / 2).all()


@pytest.mark.parametrize("n,d,q,ratio,budget,hot", [
    (600, 24, 6, 20.0, 45, False), (500, 217, 40, 50.0, 23, True),
    (2000, 8, 70, 10.0, 700, True), (300, 8, 9, 30.0, 301, False),
])
def test_refinement_selection_is_runs_of_bucket_prefixes(n, d, q, ratio,
                                                         budget, hot):
    """What the kernel's schedule relies on, held on the JAX package's own
    selections: a query row's valid slots are maximal runs of one bucket,
    each run the first rows of its bucket (perm[offsets[b]:][:length]), so
    the runs of a bucket hold the rows of its longest one and no slot of a
    refinement selection is summed from device memory.  With ``hot`` the
    largest bucket is refined by every query."""
    _, _, idx, valid, bucket_of, perm, offsets = _reference_selection(
        n, d, q, ratio, budget, hot)
    runs_of = np.zeros(len(offsets) - 1, np.int64)
    for qq in range(q):
        slots = np.flatnonzero(valid[qq])
        keys = bucket_of[idx[qq, slots]]
        # valid slots are one stretch from slot 0, padding after them
        np.testing.assert_array_equal(slots, np.arange(len(slots)))
        cuts = np.flatnonzero(np.diff(keys)) + 1
        run_keys = keys[np.r_[0, cuts]] if len(slots) else keys
        # each bucket refined at most once a query
        assert len(set(run_keys.tolist())) == len(run_keys)
        runs_of[run_keys] += 1
        for b0, b1 in zip(np.r_[0, cuts], np.r_[cuts, len(slots)]):
            key = keys[b0]
            np.testing.assert_array_equal(
                idx[qq, b0:b1], perm[offsets[key]:offsets[key] + b1 - b0])
    if hot:
        assert runs_of[np.argmax(np.diff(offsets))] == q


def test_refine_schedule_mirrors_the_kernels_constants():
    text = (Path(__file__).resolve().parent.parent
            / "src/repro_torch/csrc/refine_distances.cu").read_text()
    chunk = re.search(r"constexpr int kChunk = (\d+);", text)
    assert chunk and int(chunk.group(1)) == refine_schedule.CHUNK
    # a run is one lane's float4 slot: groups of four runs, a warp a group
    assert refine_schedule.CHUNK % 4 == 0


def test_refine_distances_clips_indices():
    """Out-of-range indices read the first or last row, as the TPU kernel
    clips them."""
    r = rng(4)
    qs, xs = normal(r, 3, 10), normal(r, 6, 10)
    idx = np.array([[-3, 0, 5, 9]] * 3, np.int32)
    valid = np.ones((3, 4), bool)
    got = ops.refine_distances(th(qs), th(xs), th(idx), th(valid))
    assert_close(got, refine_distances_pallas(jx(qs), jx(xs), jx(idx),
                                              jx(valid), interpret=True))
    np.testing.assert_array_equal(np_of(got)[:, 0], np_of(got)[:, 1])
    np.testing.assert_array_equal(np_of(got)[:, 2], np_of(got)[:, 3])


# ---------------------------------------------------------------------------
# cf_weights, cf_refine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qn,un,ni", [(16, 32, 20), (64, 130, 64),
                                      (5, 7, 300)])
def test_cf_weights_parity(qn, un, ni):
    arrays = cf_inputs(qn * 31 + un + ni, qn, un, ni)
    got = ops.cf_weights(*map(th, arrays))
    assert got.shape == (qn, un) and got.dtype == torch.float32
    jarrays = [jx(a) for a in arrays]
    assert_close(got, jref.cf_weights(*jarrays), rtol=CF_TOL, atol=CF_TOL)
    assert_close(got, cf_weights_pallas(*jarrays, tq=64, tu=64,
                                        interpret=True),
                 rtol=CF_TOL, atol=CF_TOL)
    assert (np.abs(np_of(got)) <= 1 + CF_TOL).all()


def _refine_case(qn, un, ni, b, use_frac):
    a, am, u, um = cf_inputs(qn * 100 + b, qn, un, ni)
    r = rng(qn + un + b)
    idx = r.integers(0, un, (qn, b)).astype(np.int32)
    return a, am, u, um, idx, r.random((qn, b)) < use_frac


@pytest.mark.parametrize("qn,un,ni,b", [(4, 30, 25, 7), (9, 64, 130, 17)])
def test_cf_refine_parity(qn, un, ni, b):
    arrays = _refine_case(qn, un, ni, b, 0.6)
    got = ops.cf_refine(*map(th, arrays), shrink=8.0)
    assert [tuple(g.shape) for g in got] == [(qn, b), (qn, ni), (qn, ni)]
    jarrays = [jx(a) for a in arrays]
    for want in (jref.cf_refine(*jarrays, shrink=8.0),
                 cf_refine_pallas(*jarrays, shrink=8.0, interpret=True)):
        for g, w, name in zip(got, want, ("w_ref", "num_delta",
                                          "den_delta")):
            assert_close(g, w, rtol=CF_TOL, atol=CF_TOL, err_msg=name)
    w = np_of(got[0])
    assert (w[~arrays[5]] == 0).all()


def test_cf_refine_all_padding_is_zero():
    """No used slot: zero weights and zero sums, never NaN."""
    a, am, u, um, idx, _ = _refine_case(3, 15, 15, 5, 0.0)
    use = np.zeros((3, 5), bool)
    w, num, den = ops.cf_refine(*map(th, (a, am, u, um, idx, use)),
                                shrink=8.0)
    assert np.isfinite(np_of(w)).all() and (np_of(w) == 0).all()
    assert (np_of(num) == 0).all() and (np_of(den) == 0).all()
    jw, jnum, jden = cf_refine_pallas(*map(jx, (a, am, u, um, idx, use)),
                                      shrink=8.0, interpret=True)
    assert (np.asarray(jw) == 0).all() and (np.asarray(jnum) == 0).all()


def test_cf_refine_clips_indices():
    """Out-of-range indices read the first or last user, as the TPU kernel
    clips them."""
    a, am, u, um, _, _ = _refine_case(3, 6, 20, 4, 1.0)
    idx = np.array([[-3, 0, 5, 9]] * 3, np.int32)
    use = np.ones((3, 4), bool)
    w = np_of(ops.cf_refine(*map(th, (a, am, u, um, idx, use)),
                            shrink=8.0)[0])
    want = cf_refine_pallas(*map(jx, (a, am, u, um, idx, use)), shrink=8.0,
                            interpret=True)[0]
    assert_close(w, want, rtol=CF_TOL, atol=CF_TOL)
    np.testing.assert_array_equal(w[:, 0], w[:, 1])
    np.testing.assert_array_equal(w[:, 2], w[:, 3])


# ---------------------------------------------------------------------------
# cf_aggregate: CF's bucket statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nu,ni,k,layout", CF_AGGREGATE_CASES)
def test_cf_aggregate_is_the_segment_sums_of_the_products(nu, ni, k, layout):
    """On CPU tensors the op gives the bits of the sums it replaces: the
    four [U,I] arrays (r·m, (r·m)·r, the centred ratings, m) summed by
    ``segment_sums`` over one stable sort of the ids."""
    x, m, ids = map(th, cf_aggregate_inputs(nu + ni + k, nu, ni, k, layout))
    ops.reset_launch_counts()
    got = ops.cf_aggregate(*cf_aggregate_args(x, m, ids, k))
    rated = x * m
    _, counts, want = agg_lib.segment_sums(
        (rated, rated * x, ref._centred(x, m), m), ids, k)
    for g, w, name in zip(got, want, ("sr", "sr2", "s", "c")):
        assert g.shape == (k, ni) and g.dtype == torch.float32, name
        assert torch.equal(g, w), name
    assert ops.launch_counts()["cf_aggregate"] == 0
    empty = counts == 0
    assert all(bool((g[empty] == 0).all()) for g in got)


def _bad_aggregate_args(what):
    x, m, ids = map(th, cf_aggregate_inputs(3, 6, 9, 4, "random"))
    args = list(cf_aggregate_args(x, m, ids, 4))
    if what == "dtype":
        args[0] = args[0].double()
    elif what == "order_dtype":
        args[3] = args[3].long()
    elif what == "means_shape":
        args[2] = args[2][:, 0]
    elif what == "mask_shape":
        args[1] = args[1][:, :-1].contiguous()
    elif what == "strided":
        args[0] = args[0].t().contiguous().t()
    elif what == "no_offsets":
        args[4] = args[4][:0]
    return args


@pytest.mark.parametrize("what,error,match", [
    ("dtype", TypeError, "ratings: dtype"),
    ("order_dtype", TypeError, "order: dtype"),
    ("means_shape", ValueError, "means: shape"),
    ("mask_shape", ValueError, "mask: shape"),
    ("strided", ValueError, "ratings: must be contiguous"),
    ("no_offsets", ValueError, "offsets: empty"),
])
def test_cf_aggregate_wrapper_refuses_what_the_kernel_does_not_take(
        what, error, match):
    ops.reset_launch_counts()
    with pytest.raises(error, match=match):
        ops.KERNELS["cf_aggregate"](*_bad_aggregate_args(what))
    assert ops.launch_counts()["cf_aggregate"] == 0


# ---------------------------------------------------------------------------
# lsh_hash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,h", [(64, 16, 4), (200, 217, 6), (33, 8, 1)])
def test_lsh_hash_parity(n, d, h):
    r = rng(n + d + h)
    x, a = normal(r, n, d), normal(r, d, h)
    b = (r.random(h) * 4.0).astype(np.float32)
    got = ops.lsh_hash(th(x), th(a), th(b), 4.0)
    assert got.shape == (n, h) and got.dtype == torch.int32
    for want in (jref.lsh_hash(jx(x), jx(a), jx(b), width=4.0),
                 lsh_hash_pallas(jx(x), jx(a), jx(b), 4.0, tn=64,
                                 interpret=True)):
        # floor() at a bucket border: off by one on under 0.1 % of entries,
        # the reference's own rule (tests/test_kernels.py:47-50)
        diff = np.abs(np_of(got).astype(np.int64) - np.asarray(want))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_lsh_hash_is_raw_hashes():
    """ops.lsh_hash computes core/lsh.py:raw_hashes's expression."""
    r = rng(2)
    x = normal(r, 300, 24)
    cfg = lsh.LSHConfig(n_hashes=4, bucket_width=4.0, n_buckets=16)
    p = lsh.init_lsh(torch.Generator().manual_seed(1), 24, cfg, device="cpu")
    assert torch.equal(ops.lsh_hash(th(x), p.a, p.b, 4.0),
                       lsh.raw_hashes(th(x), p))


@pytest.mark.parametrize("nest", [None, 4, 16])
@pytest.mark.parametrize("h", [1, 4, 8, 12])
def test_lsh_bucket_ids_parity(h, nest):
    """ref.lsh_bucket_ids (the kernel's ids epilogue) on the reference's
    drawn projections equals the JAX package's bucket_ids and
    fine_bucket_ids, flat and nested (base 4 and 16 x n_buckets).  Inputs
    scaled so that hashes go negative and the uint32 signature wraps."""
    from repro.core import lsh as jlsh

    n, d, k = 600, 24, 97
    x = normal(rng(h * 31 + (nest or 1)), n, d) * 40
    cfg = (jlsh.LSHConfig(n_hashes=h, bucket_width=4.0, n_buckets=k)
           if nest is None else jlsh.nested_config(nest * k, k, n_hashes=h))
    jp = jlsh.init_lsh(jax.random.PRNGKey(h + 7 * (nest or 1)), d, cfg)
    a, b = np.asarray(jp.a), np.asarray(jp.b)
    base = nest * k if nest else k
    raw = np_of(ref.lsh_hash(th(x), th(a), th(b), 4.0)).astype(np.int64)
    assert (raw < 0).any() and (raw > 0).any()
    primes = np.array(jlsh._SIGNATURE_PRIMES[:h], np.uint64)
    assert ((raw.astype(np.uint32).astype(np.uint64) * primes).sum(1)
            >= 2**32).any()                   # the signature wraps
    # rows whose projection lies within 1e-4 of a bucket border, where
    # float32 sums in another order may flip floor(): 0 or 1 of the 600
    # rows at these draws (1 at H 1 nested 4x, H 8 and 12 flat and 16x)
    proj = (x.astype(np.float64) @ a + b) / 4.0
    border = (np.abs(proj - np.round(proj)) < 1e-4).any(axis=1)
    assert border.sum() <= 1
    for factor, want in ((1, jlsh.fine_bucket_ids(jx(x), jp)),
                         (base // k, jlsh.bucket_ids(jx(x), jp))):
        got = np_of(ref.lsh_bucket_ids(th(x), th(a), th(b), 4.0, base=base,
                                       factor=factor))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got[~border],
                                      np.asarray(want)[~border])


# ---------------------------------------------------------------------------
# dispatch: CPU tensors to the plain versions, never a CUDA kernel; the
# kernels' wrappers refuse a CPU tensor instead of computing on it
# ---------------------------------------------------------------------------

def _small_args():
    r = rng(1)
    qs, ps = th(normal(r, 4, 8)), th(normal(r, 10, 8))
    labs = th(np.arange(10, dtype=np.int32))
    idx = th(np.zeros((4, 3), np.int32))
    valid = th(np.ones((4, 3), bool))
    dists = th(normal(r, 4, 10))
    a, am, u, um = map(th, cf_inputs(2, 4, 10, 8))
    b = th(np.zeros(3, np.float32))
    return {
        "knn_distance": ((qs, ps), {}),
        "distance_topk": ((qs, ps, labs), {"k": 3}),
        "candidate_topk": ((dists, labs[None].expand(4, 10).contiguous()),
                           {"k": 3}),
        "refine_distances": ((qs, ps, idx, valid), {}),
        "lsh_hash": ((qs, th(normal(r, 8, 3)), b, 4.0), {}),
        "lsh_bucket_ids": ((qs, th(normal(r, 8, 3)), b, 4.0),
                           {"base": 64, "factor": 4}),
        "cf_weights": ((a, am, u, um), {}),
        "cf_refine": ((a, am, u, um, idx, valid), {"shrink": 8.0}),
        "cf_aggregate": (cf_aggregate_args(u, um, th(np.array(
            [2, 0, 2, 1, 2, 0, 2, 1, 0, 2], np.int32)), 3), {}),
    }


def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launch_counts()
    for name, (args, kwargs) in _small_args().items():
        got = getattr(ops, name)(*args, **kwargs)
        want = getattr(ref, name)(*args, **kwargs)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("name", ["knn_distance", "distance_topk",
                                  "candidate_topk", "refine_distances",
                                  "lsh_hash", "cf_weights", "cf_refine",
                                  "cf_aggregate"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    args, kwargs = _small_args()[name]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.KERNELS[name](*args, **kwargs)
    assert ops.launch_counts()[name] == 0


def test_lsh_bucket_ids_wrapper_refuses_cpu_tensors():
    args, kwargs = _small_args()["lsh_bucket_ids"]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.lsh_bucket_ids_cuda(*args, **kwargs)
    assert ops.launch_counts()["lsh_hash"] == 0


@pytest.mark.parametrize("k", [0, 33])
def test_selection_wrappers_refuse_k_out_of_range(k):
    """k < 1 for both; k > MAX_K for candidate_topk only: distance_topk
    takes a wider k in rounds, so at 33 it refuses just the CPU tensors."""
    args, _ = _small_args()["distance_topk"]
    with pytest.raises(ValueError, match="k=" if k < 1 else "CUDA"):
        distance_topk_cuda(*args, k=k)
    args, _ = _small_args()["candidate_topk"]
    with pytest.raises(ValueError, match="k="):
        candidate_topk_cuda(*args, k=k)


def test_probe_sees_every_op_call():
    class Recorder:
        def __init__(self):
            self.ops = []

        def timed(self, op, fn, args, kwargs):
            self.ops.append(op)
            return fn(*args, **kwargs)

    rec = Recorder()
    ops.set_probe(rec)
    try:
        assert ops.get_probe() is rec
        for name, (args, kwargs) in _small_args().items():
            getattr(ops, name)(*args, **kwargs)
    finally:
        ops.set_probe(None)
    # the ids epilogue is the lsh_hash kernel: probed under its name
    assert rec.ops == [{"lsh_bucket_ids": "lsh_hash"}.get(n, n)
                       for n in _small_args()]
    assert ops.get_probe() is None


# ---------------------------------------------------------------------------
# decode attention: agg_refine_attention, aggregated_attention_decode
# (the reference's attention tolerance, tests/test_kernels.py:108 and
# tests/test_decode.py:255)
# ---------------------------------------------------------------------------

ATTN_TOL = 1e-5


def _agg_refine_inputs(seed, b=3, kb=8, cap=4, hkv=2, g=2, dk=16, dv=16,
                       r=3):
    """tests/test_decode.py:239's shapes: counts run past the capacity,
    selections repeat and ``use`` masks some."""
    x = rng(seed)
    return (normal(x, b, hkv, g, dk), normal(x, b, kb, cap, hkv, dk),
            normal(x, b, kb, cap, hkv, dv),
            x.integers(0, cap + 3, (b, kb)).astype(np.int32),
            x.integers(0, kb, (b, r)).astype(np.int32),
            x.integers(0, 2, (b, r)).astype(np.int32))


@pytest.mark.parametrize("force", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("seed,shape", [
    (1, {}), (2, dict(b=2, kb=6, cap=8, hkv=1, g=4, dk=32, dv=24, r=5)),
])
def test_agg_refine_attention_parity(force, seed, shape):
    args = _agg_refine_inputs(seed, **shape)
    want = jops.agg_refine_attention(*(jx(a) for a in args), scale=0.25,
                                     force=force)
    got = ops.agg_refine_attention(*(th(a) for a in args[:5]),
                                   th(args[5]) != 0, scale=0.25)
    for name, a, w in zip(("m", "l", "acc"), got, want):
        assert_close(a, w, rtol=ATTN_TOL, atol=ATTN_TOL, err_msg=name)


def test_agg_refine_attention_fully_masked_is_the_empty_partial():
    args = _agg_refine_inputs(3)
    use = np.zeros_like(args[5])
    m, l, acc = ops.agg_refine_attention(*(th(a) for a in args[:5]),
                                         th(use) != 0, scale=0.25)
    want = jops.agg_refine_attention(*(jx(a) for a in args[:5]), jx(use),
                                     scale=0.25, force="pallas_interpret")
    assert float(m.max()) <= ref.NEG / 2
    assert (np_of(l) == 0).all() and (np_of(acc) == 0).all()
    assert_close(m, want[0], rtol=0, atol=0)


def _agg_attn_inputs(seed, b, s, kb, hq, hkv, dk, dv, refine_frac=0.3):
    """tests/test_kernels.py:72's construction: random buckets, their means
    and counts, the first refine_frac of the buckets refined (non-empty
    ones only)."""
    x = rng(seed)
    k_cache = normal(x, b, s, hkv, dk)
    v_cache = normal(x, b, s, hkv, dv)
    bucket_of = x.integers(0, kb, (b, s)).astype(np.int32)
    counts = np.stack([np.bincount(r, minlength=kb) for r in bucket_of])
    mean_k = np.zeros((b, kb, hkv, dk), np.float32)
    mean_v = np.zeros((b, kb, hkv, dv), np.float32)
    for i in range(b):
        np.add.at(mean_k[i], bucket_of[i], k_cache[i])
        np.add.at(mean_v[i], bucket_of[i], v_cache[i])
    mean_k /= np.maximum(counts, 1)[:, :, None, None]
    mean_v /= np.maximum(counts, 1)[:, :, None, None]
    n_ref = max(1, int(refine_frac * kb))
    refined = (np.arange(kb) < n_ref)[None, :] & (counts > 0)
    return [normal(x, b, hq, dk), k_cache, v_cache, bucket_of, mean_k,
            mean_v, counts.astype(np.int32), refined]


def _pallas_batch(case, scale, valid_len):
    """The JAX kernel in interpret mode, one sequence at a time (the JAX
    package vmaps it over the batch)."""
    return np.stack([np.asarray(aggregated_attention_pallas(
        *(jx(a[i]) for a in case), scale=scale, valid_len=int(valid_len[i]),
        tile=64, interpret=True)) for i in range(case[0].shape[0])])


@pytest.mark.parametrize("s,kb,hq,hkv,dk,dv", [
    (64, 8, 4, 2, 16, 16),
    (200, 16, 8, 8, 32, 32),
    (128, 10, 8, 1, 64, 48),   # MQA + dv != dk (MLA latent shape)
])
def test_aggregated_attention_decode_parity(s, kb, hq, hkv, dk, dv):
    case = _agg_attn_inputs(s + kb, 2, s, kb, hq, hkv, dk, dv)
    scale = 1.0 / np.sqrt(dk)
    valid_len = np.asarray([s - 3, s // 2], np.int32)
    want = _pallas_batch(case, scale, valid_len)
    got = ops.aggregated_attention_decode(
        *(th(a) for a in case), scale=scale, valid_len=th(valid_len))
    assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    # the JAX plain version (the oracle the JAX model calls on the CPU)
    oracle = np.stack([np.asarray(_jref.aggregated_attention_decode(
        *(jx(a[i]) for a in case), scale, int(valid_len[i])))
        for i in range(2)])
    assert_close(got, oracle, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_aggregated_attention_all_refined_equals_exact():
    """Every non-empty bucket refined: plain softmax attention over the
    cache (tests/test_kernels.py:116)."""
    s, kb, hq, hkv, dk = 96, 12, 4, 2, 16
    case = _agg_attn_inputs(0, 2, s, kb, hq, hkv, dk, dk)
    case[7] = case[6] > 0
    scale = 1.0 / np.sqrt(dk)
    got = np_of(ops.aggregated_attention_decode(*(th(a) for a in case),
                                                scale=scale))
    q, k_cache, v_cache = case[0], case[1], case[2]
    g = hq // hkv
    for i in range(2):
        for h in range(hq):
            logits = k_cache[i, :, h // g] @ q[i, h] * scale
            p = np.exp(logits - logits.max())
            want = (p / p.sum()) @ v_cache[i, :, h // g]
            np.testing.assert_allclose(got[i, h], want, rtol=2e-5, atol=2e-5)
    assert_close(got, _pallas_batch(case, scale, np.full(2, s)),
                 rtol=ATTN_TOL, atol=ATTN_TOL)


def test_aggregated_attention_all_empty_cache_gives_zeros():
    s, kb, hq, hkv, dk = 32, 4, 4, 2, 16
    case = _agg_attn_inputs(5, 2, s, kb, hq, hkv, dk, dk)
    case[6] = np.zeros_like(case[6])           # every bucket empty
    case[7] = np.zeros_like(case[7])
    valid_len = np.zeros(2, np.int32)           # nothing written
    got = np_of(ops.aggregated_attention_decode(
        *(th(a) for a in case), scale=0.25, valid_len=th(valid_len)))
    assert np.isfinite(got).all() and (got == 0).all()
    want = _pallas_batch(case, 0.25, valid_len)
    assert np.isfinite(want).all()
    assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("hkv,g,t,dk,dv", [(2, 2, 40, 16, 16),
                                           (1, 8, 70, 64, 48)])
def test_masked_decode_attention_parity(hkv, g, t, dk, dv):
    x = rng(t + dv)
    q, keys, values = (normal(x, hkv, g, dk), normal(x, hkv, t, dk),
                       normal(x, hkv, t, dv))
    bias = np.where(x.random(t) < 0.6, np.log(x.integers(1, 9, t)),
                    ref.NEG).astype(np.float32)
    want = masked_decode_attention(jx(q), jx(keys), jx(values), jx(bias),
                                   scale=0.3, tile=64, interpret=True)
    got = ref.masked_decode_attention(th(q), th(keys), th(values), th(bias),
                                      scale=0.3)
    for name, a, w in zip(("m", "l", "acc"), got, want):
        assert_close(a, w, rtol=ATTN_TOL, atol=ATTN_TOL, err_msg=name)


def test_merge_partials_and_segment_mean_parity():
    x = rng(11)
    parts = [normal(x, 3, 2), np.abs(normal(x, 3, 2)), normal(x, 3, 2, 5)]
    empty = [np.full((3, 2), ref.NEG, np.float32),
             np.zeros((3, 2), np.float32), np.zeros((3, 2, 5), np.float32)]
    other_parts = [normal(x, 3, 2), np.abs(normal(x, 3, 2)),
                   normal(x, 3, 2, 5)]
    for other in (other_parts, empty):
        want = _jref.merge_partials(*(jx(a) for a in parts + other))
        got = ref.merge_partials(*(th(a) for a in parts + other))
        for a, w in zip(got, want):
            assert_close(a, w, rtol=ATTN_TOL, atol=ATTN_TOL)
    both_empty = ref.merge_partials(*(th(a) for a in empty + empty))
    assert (np_of(both_empty[0]) == np.float32(ref.NEG)).all()
    assert (np_of(both_empty[1]) == 0).all()
    data, ids = normal(x, 40, 12), x.integers(0, 7, 40).astype(np.int32)
    ids[ids == 5] = 6                            # one empty segment
    want_m, want_c = _jref.segment_mean(jx(data), jx(ids), 8)
    got_m, got_c = ref.segment_mean(th(data), th(ids), 8)
    assert_close(got_m, want_m, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_array_equal(np_of(got_c), np.asarray(want_c))
