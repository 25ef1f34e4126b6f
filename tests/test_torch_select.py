"""The batched ``distance_topk`` selection against the JAX package.

On the CPU the port's ``kernels.ops.distance_topk`` runs its plain version;
a leading batch dimension selects each item on its own, as ``jax.vmap`` of
the reference does (``src/repro/models/aggregated_kv.py:select_buckets``
vmaps one call per sequence).  Each case is held exactly to B separate 2-D
calls, and to the vmapped JAX reference within the kernel tolerance (1e-4),
labels equal except at named near-ties.  The CUDA kernel itself is held
against the plain version by ``test_torch_cuda.py``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import (
    BATCHED_TOPK_CASES, assert_topk_match, batched_inputs, normal, np_of, rng,
    th,
)
from repro.kernels import ref as _jref
from repro.models import aggregated_kv as jakv
from repro_torch.kernels import distance_topk as dt_wrapper
from repro_torch.kernels import ops
from repro_torch.models import aggregated_kv as akv

jx = jax.numpy.asarray


def _vmapped_reference(qs, ps, labels, valid, *, k, metric):
    """jax.vmap of the JAX package's plain distance_topk over the items."""
    fn = jax.jit(jax.vmap(
        lambda q, p, lab, v: _jref.distance_topk(q, p, lab, v, k=k,
                                                 metric=metric),
        in_axes=(0, 0, 0 if labels.ndim == 2 else None, 0)))
    return fn(jx(qs), jx(ps), jx(labels), jx(valid))


@pytest.mark.parametrize("b,q,n,d,k,metric,valid_frac,ties,per_item",
                         BATCHED_TOPK_CASES)
def test_batched_distance_topk_matches_separate_calls_and_vmap(
        b, q, n, d, k, metric, valid_frac, ties, per_item):
    qs, ps, labels, valid = batched_inputs(b * 1000 + n + k, b, q, n, d,
                                           valid_frac, ties=ties,
                                           per_item_labels=per_item)
    got_d, got_l = ops.distance_topk(th(qs), th(ps), th(labels), th(valid),
                                     k=k, metric=metric)
    assert got_d.dtype == torch.float32 and got_l.dtype == torch.int32
    assert got_d.shape == got_l.shape == (b, q, k)
    item = (lambda i: labels[i]) if per_item else (lambda i: labels)
    one_d, one_l = zip(*(
        ops.distance_topk(th(qs[i]), th(ps[i]), th(item(i)), th(valid[i]),
                          k=k, metric=metric) for i in range(b)))
    assert torch.equal(got_d, torch.stack(one_d))
    assert torch.equal(got_l, torch.stack(one_l))

    want_d, want_l = _vmapped_reference(qs, ps, labels, valid, k=k,
                                        metric=metric)
    next_d = ops.distance_topk(th(qs), th(ps), th(labels), th(valid),
                               k=k + 1, metric=metric)[0][..., k]
    flat = (lambda a: np_of(a).reshape(b * q, -1))
    # the plain versions agree on every slot, padding labels included
    assert_topk_match(flat(got_d), flat(got_l), flat(want_d), flat(want_l),
                      np_of(next_d).reshape(b * q), real_only=False)
    if valid_frac == 0.0:
        assert (np_of(got_d) >= 1.5e38).all()


@pytest.mark.parametrize("b,n_refine,kb", [(1, 64, 64), (4, 4, 64),
                                           (4, 16, 64), (3, 40, 70)])
def test_select_buckets_makes_one_selection_call(b, n_refine, kb):
    """One ``distance_topk`` call for the B sequences of a layer, seen
    through the ops probe, and the reference's choice of buckets."""
    class Counter:
        def __init__(self):
            self.calls = []

        def timed(self, op, fn, args, kwargs):
            self.calls.append((op, tuple(args[0].shape), kwargs["k"]))
            return fn(*args, **kwargs)

    x = rng(b * 100 + n_refine)
    qg, mean_k = normal(x, b, 2, 2, 8), normal(x, b, kb, 2, 8)
    counts = x.integers(0, 4, (b, kb)).astype(np.int32)
    probe = Counter()
    ops.set_probe(probe)
    try:
        got_idx, got_use = akv.select_buckets(th(qg), th(mean_k), th(counts),
                                              n_refine=n_refine)
    finally:
        ops.set_probe(None)
    assert probe.calls == [("distance_topk", (b, 1, 16), n_refine)]
    want_idx, want_use = jakv.select_buckets(jx(qg), jx(mean_k), jx(counts),
                                             n_refine=n_refine)
    use = np.asarray(want_use)
    np.testing.assert_array_equal(np_of(got_use), use)
    np.testing.assert_array_equal(np_of(got_idx)[use],
                                  np.asarray(want_idx)[use])


@pytest.mark.parametrize("nq,n", [(1024, 287_500), (1024, 28_750),
                                  (1024, 2875), (1, 1025), (130, 5000),
                                  (1, 287_500), (2048, 2875), (1025, 1025),
                                  (40_000, 287_500)])
def test_wide_chunking_covers_the_points_in_whole_tiles(nq, n):
    """The wide regime's chunks: whole 128-point tiles, in column order,
    covering every point, and no more blocks than one wave of two a SM."""
    cols, chunks = dt_wrapper._chunking(nq, n, 132)
    assert cols % 128 == 0 and chunks * cols >= n > (chunks - 1) * cols
    assert -(-nq // 128) * chunks <= 2 * 132 or chunks == 1

