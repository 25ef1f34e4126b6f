"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs are made once with numpy from a seed and handed to the JAX package and
to the port, so both sides see the same bits; outputs come back as numpy.
Tolerances are those of the reference's own kernel tests
(``tests/test_kernels.py``): 1e-4 relative and absolute on distances, 2e-4
on CF weights and sums.
Integer outputs must be equal, except where two candidates' distances are
within that tolerance of each other (a near-tie: summation order alone can
swap them); such slots are returned by name so a test can bound them.
"""
from __future__ import annotations

import numpy as np
import torch

RTOL = ATOL = 1e-4
BIG = 3.0e38


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def th(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def normal(r: np.random.Generator, *shape) -> np.ndarray:
    return r.standard_normal(shape).astype(np.float32)


def topk_inputs(seed, q, n, d, valid_frac, n_labels=11):
    """Queries, points, labels and a validity mask for distance_topk."""
    r = rng(seed)
    return (normal(r, q, d), normal(r, n, d),
            r.integers(0, n_labels, n).astype(np.int32),
            r.random(n) < valid_frac)


def batched_inputs(seed, b, q, n, d, valid_frac, *, ties=False,
                   per_item_labels=False):
    """[B,Q,D] queries, [B,N,D] points, labels ([N] or [B,N]) and a [B,N]
    mask.  With ``ties`` the points are small integers and the second half
    repeats the first, so scores tie exactly."""
    r = rng(seed)
    if ties:
        ps = r.integers(-2, 3, (b, n, d)).astype(np.float32)
        ps[:, n // 2:] = ps[:, :n - n // 2]
        qs = r.integers(-2, 3, (b, q, d)).astype(np.float32)
    else:
        qs, ps = normal(r, b, q, d), normal(r, b, n, d)
    shape = (b, n) if per_item_labels else (n,)
    labels = r.integers(0, 1000, shape).astype(np.int32)
    return qs, ps, labels, r.random((b, n)) < valid_frac


# (B, Q, N, D, k, metric, valid_frac, ties, per-item labels) of the batched
# distance_topk tests, on the CPU and on the card
BATCHED_TOPK_CASES = [
    # the LM selection: B sequences, one pooled query, K = 64 buckets of
    # D = 1024, k at rf 0.05, 0.25 and 1.0, some buckets empty
    (4, 1, 64, 1024, 4, "dot", 0.8, False, False),
    (4, 1, 64, 1024, 16, "dot", 0.8, False, False),
    (4, 1, 64, 1024, 64, "dot", 0.8, False, False),
    (1, 1, 64, 1024, 64, "dot", 0.9, False, False),   # a prefill token
    # deepseek-v2-236b's MLA selection: the pooled latent query, D = 576
    (4, 1, 64, 576, 16, "dot", 0.8, False, False),
    (4, 1, 64, 576, 64, "dot", 0.8, False, False),
    (3, 2, 10, 8, 14, "dot", 0.7, False, True),       # k > N: padding
    (2, 1, 20, 16, 5, "dot", 0.0, False, False),      # every point masked
    (2, 3, 30, 4, 12, "l2", 1.0, True, False),        # exact ties
    (3, 5, 40, 24, 6, "l2", 0.8, False, True),        # l2 at a small N
]


def candidates(seed, q, m, k, seeded):
    """[q, m] candidates (a tenth pre-masked to BIG) and, if ``seeded``, a
    sorted [q, k] seed, for candidate_topk."""
    r = rng(seed)
    d = (r.random((q, m)) * 10).astype(np.float32)
    d = np.where(r.random((q, m)) < 0.9, d, np.float32(BIG)).astype(np.float32)
    lab = r.integers(0, 7, (q, m)).astype(np.int32)
    if not seeded:
        return d, lab, None, None
    init_d = np.sort((r.random((q, k)) * 10).astype(np.float32), axis=1)
    return d, lab, init_d, r.integers(0, 7, (q, k)).astype(np.int32)


def cf_inputs(seed, qn, un, ni, density=0.3):
    """Active and neighbour ratings (0..5 stars where rated) and 0/1
    masks, as the reference's CF kernel tests make them."""
    r = rng(seed)
    stars = r.integers(0, 6, (qn + un, ni)).astype(np.float32)
    m = (r.random((qn + un, ni)) < density).astype(np.float32)
    x = stars * m
    return x[:qn], m[:qn], x[qn:], m[qn:]


def assert_close(got, want, *, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def near_tie_slots(want_d: np.ndarray, next_d: np.ndarray | None = None,
                   *, rtol=RTOL, atol=ATOL) -> np.ndarray:
    """[Q,k] bool: slot j of row q ties, within tolerance, with slot j-1 or
    j+1 of the reference ranking (``next_d`` [Q] is the (k+1)-th
    distance, so that the last slot can tie with the first one left out)."""
    ext = want_d if next_d is None else np.concatenate(
        [want_d, np.asarray(next_d)[:, None]], axis=1)
    close = np.abs(np.diff(ext, axis=1)) <= atol + rtol * np.abs(ext[:, 1:])
    k = want_d.shape[1]
    tie = np.zeros(want_d.shape, bool)
    tie[:, 1:] |= close[:, : k - 1]               # ties with the slot before
    m = min(k, close.shape[1])
    tie[:, :m] |= close[:, :m]                    # ties with the slot after
    return tie


def assert_topk_match(got_d, got_l, want_d, want_l, next_d=None, *,
                      real_only: bool = True, rtol=RTOL, atol=ATOL) -> list:
    """Top-k (distances, labels) agree: distances within tolerance, the same
    padding slots, labels equal except at named near-ties.  With
    ``real_only`` labels of BIG padding slots are not compared (the Pallas
    and CUDA kernels give them label 0, the plain versions the label of the
    masked candidate).  Returns the near-tie slots where labels differ."""
    gd, gl, wd, wl = (np_of(a) for a in (got_d, got_l, want_d, want_l))
    np.testing.assert_array_equal(gd >= BIG / 2, wd >= BIG / 2,
                                  err_msg="padding slots differ")
    real = wd < BIG / 2
    np.testing.assert_allclose(gd[real], wd[real], rtol=rtol, atol=atol)
    differ = gl != wl
    if real_only:
        differ &= real
    tie = near_tie_slots(wd, None if next_d is None else np_of(next_d),
                         rtol=rtol, atol=atol)
    unexplained = differ & ~tie
    assert not unexplained.any(), (
        f"labels differ away from near-ties at {np.argwhere(unexplained)[:5]}"
    )
    return [(int(q), int(j), float(wd[q, j])) for q, j in np.argwhere(differ)]


# (Q, U, I, density, skew, mask values) of the card tests of the two CF
# kernels: no ratings, every item rated, uniform, make_netflix_like's Zipf
# skew (popular items first), mask values other than 0 and 1, the path's
# I = 17,700 with few users, I not a multiple of 4, more active users than
# one group of the cf_weights grid takes, and enough pairs for its grid to
# need no split of the items
CF_SPARSE_CASES = [
    (16, 40, 300, 0.0, 0.0, (1.0,)),
    (16, 40, 300, 1.0, 0.0, (1.0,)),
    (33, 70, 1001, 0.3, 0.0, (1.0,)),
    (64, 200, 2000, 0.05, 0.8, (1.0,)),
    (20, 50, 517, 0.3, 0.0, (0.5, 1.0, 2.0)),
    (3, 5, 17_700, 0.012, 0.8, (1.0,)),
    (9, 37, 2003, 0.2, 0.8, (1.0,)),
    (300, 70, 700, 0.1, 0.8, (1.0,)),
    (640, 1700, 700, 0.05, 0.8, (1.0,)),
]


def cf_sparse_inputs(seed, qn, un, ni, density, skew=0.0,
                     mask_values=(1.0,)):
    """Active and neighbour ratings (1..5 stars where rated, 0 elsewhere)
    and masks at ``density``; with ``skew`` item i is rated with a
    probability proportional to (1 + i) ** -skew, as make_netflix_like
    draws it (clipped at 0.95); without, every item at ``density``.  Mask values are drawn from
    ``mask_values``.  Row 0 of each side (when it has two rows) rates every
    item it rates with 3 stars and a mask of 1, so its centred ratings are
    exactly 0; row 1 rates nothing."""
    r = rng(seed)
    n = qn + un
    pop = np.full(ni, density)
    if skew:
        pop = (1.0 + np.arange(ni)) ** -skew
        pop = np.clip(pop / pop.mean() * density, 0.0, 0.95)
    rated = r.random((n, ni)) < pop[None, :]
    m = np.where(rated, r.choice(np.asarray(mask_values, np.float32),
                                 (n, ni)), 0.0).astype(np.float32)
    x = np.where(rated, r.integers(1, 6, (n, ni)), 0).astype(np.float32)
    for first, rows in ((0, qn), (qn, un)):
        if rows >= 2:
            x[first] = np.where(rated[first], 3.0, 0.0)
            m[first] = rated[first].astype(np.float32)
            x[first + 1] = 0.0
            m[first + 1] = 0.0
    return x[:qn], m[:qn], x[qn:], m[qn:]


# (users, items, buckets, layout) of the cf_aggregate tests.  Layouts of
# the bucket ids: drawn at random; even buckets only (the odd ones empty);
# every user in one bucket; one user a bucket; over half the users in
# bucket 0.  Item counts on and off a multiple of 4 and of the kernel's
# 128-item tile; a single user.
CF_AGGREGATE_CASES = [
    (300, 700, 16, "random"), (257, 1001, 40, "empty"), (97, 130, 8, "one"),
    (64, 515, 64, "each"), (1, 33, 3, "random"), (1, 128, 1, "one"),
    (2000, 257, 20, "skewed"),
]


def cf_aggregate_inputs(seed, nu, ni, k, layout):
    """Ratings, masks (values 0.5, 1 and 2; ``cf_sparse_inputs``' special
    rows 0 and 1) and [nu] bucket ids in [0, k) of ``layout``."""
    r = rng(seed)
    _, _, x, m = cf_sparse_inputs(seed, 0, nu, ni, 0.2, 0.8,
                                  (0.5, 1.0, 2.0))
    ids = {
        "random": lambda: r.integers(0, k, nu),
        "empty": lambda: 2 * r.integers(0, (k + 1) // 2, nu),
        "one": lambda: np.full(nu, k // 2),
        "each": lambda: np.arange(nu) % k,
        "skewed": lambda: np.where(r.random(nu) < 0.6, 0,
                                   r.integers(0, k, nu)),
    }[layout]()
    return x, m, ids.astype(np.int32)


def cf_aggregate_args(ratings, mask, ids, k):
    """The arguments of ``ops.cf_aggregate`` as the CF map task makes them
    from [U,I] ratings and masks and [U] bucket ids (tensors): the users'
    means, the stable bucket order and the bucket starts, int32."""
    from repro_torch.core import aggregate as agg_lib
    from repro_torch.kernels import ref

    order, counts = agg_lib._bucket_order(ids, k)
    return (ratings, mask, ref._user_means(ratings, mask),
            order.to(torch.int32), agg_lib.bucket_offsets(counts))


# ---------------------------------------------------------------------------
# chip_smoke.py's phases rehearsed on the CPU
# ---------------------------------------------------------------------------

class CountingPlain:
    """Stands in for a kernel's wrapper: counts its calls, runs the plain
    version."""

    def __init__(self, fn):
        self.fn, self.launches = fn, 0

    def __call__(self, *args, **kwargs):
        self.launches += 1
        return self.fn(*args, **kwargs)


def plain_kernels(monkeypatch):
    """Replace every kernel wrapper of ``repro_torch.kernels.ops`` by a
    counting plain version and make ``ops`` take the kernels' path on CPU
    tensors; stub the card's synchronisation and memory statistics.
    Returns the wrappers by op."""
    from repro_torch.kernels import ops, ref

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
    wrappers = {name: CountingPlain(fn) for name, fn in plain.items()}
    for name, w in wrappers.items():
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
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    return wrappers


def chip_smoke():
    """``chip_smoke.py`` as a module (it sits at the repository root)."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    return cs
