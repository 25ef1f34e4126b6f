#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: Algorithm 1 on one card.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

What it does, in order:

1. builds the seven CUDA kernels from ``src/repro_torch/csrc`` with nvcc
   (one process per source, in parallel) and prints each kernel's register
   and spill count from ``-Xptxas=-v``;
2. drives the port's two main paths through their entry points, each at the
   scale of the paper's dataset, with every kernel's launch count set to 0
   just before the path and read just after; a kernel of the path that
   never launched fails the run:

   * kNN (mfeat-factors: 2.3 M points x 217 features x 10 classes; 1024
     test queries; 8 map shards): ``run_exact``, ``run_sampled``,
     ``run_accurateml`` at compression 100 with eps_max 0 and 0.01, and one
     ``accurateml_map(..., with_bound=True)`` batch through
     ``MapReduce(mesh=None)`` with the all-gather merge + vote combine;
   * user-based CF (the Netflix subset: 48,019 neighbourhood users x 17,700
     items, density 0.012; 1024 active users; 8 map shards): ``run_exact``,
     ``run_sampled`` at the equal-work fraction 1/20 + 0.05,
     ``run_accurateml`` at compression 20 with eps_max 0 and 0.05, each
     cold and once warm, and one ``accurateml_map(..., with_bound=True)``
     batch through ``MapReduce(mesh=None)`` with the psum combine;
   * the LSH hash phase: ``ops.lsh_hash`` on both paths' hash inputs (kNN
     shard 0's rows, CF shard 0's centred profiles);
3. holds each kernel against its plain PyTorch version (``kernels/ref.py``)
   on the very inputs the paths gave it, at every shape it was called with,
   and times kernel, plain version and, where one PyTorch call computes the
   same function, that call (``library_ms``);
4. checks the end-to-end answers of both applications on a small input
   against the same functions run on the CPU, and that aggregation gives
   identical bits on two runs;
5. prints the accuracies and RMSEs, one JSON line ``{"kernels": [...]}``,
   the card's name and power limit from nvidia-smi, and as its last line
   ``{"ok": true, "device": {...}}``.

Tolerances: kNN distances agree within rtol 1e-4 plus atol 1e-4 (fp32 sums
in another order; the JAX package's own kernel tests use the same).  Labels
agree exactly except at near-ties: a slot whose plain distance has a
neighbour in the plain ranking (the (k+1)-th included) within that
tolerance; each one is counted and the first few are named.  CF weights and
sums agree within rtol 2e-4 plus atol 2e-4, the JAX package's CF kernel
tolerance.  LSH hashes may differ by one on under 0.1 % of entries, where a
projection lies on a bucket border (the JAX package's own rule).  The
full-scale CF answers: under 0.1 % of the predictions more than half a star
outside [1, 5]; every RMSE at least the ratings' noise (0.5) and below that
of predicting each user's mean; the approximate jobs' RMSE loss under 6 %.

It exits non-zero, printing no result, when there is no CUDA device, when
the package is not beside it, or when any check fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

N_TRAIN = 2_300_000   # mfeat-factors: 2.3 M points (src/repro/data/synthetic.py)
N_FEATURES = 217
N_CLASSES = 10
N_QUERY = 1024
K = 5
N_SHARDS = 8
RATIO = 100.0
EPS_LEVELS = (0.0, 0.01)
SAMPLE_FRAC = 0.1
RTOL = ATOL = 1e-4

# The Netflix subset of src/repro/data/synthetic.py:10-13, generated by
# make_netflix_like with its other defaults; the first CF_ACTIVE users are
# the active users (train ratings in, held-out ratings for RMSE).
CF_USERS = 48_019
CF_ACTIVE = 1024
CF_ITEMS = 17_700
CF_DENSITY = 0.012
CF_RATIO = 20.0       # examples/cf_recommend.py:35, tests/test_apps.py:108
CF_EPS_LEVELS = (0.0, 0.05)
CF_SAMPLE_FRAC = 1.0 / CF_RATIO + 0.05   # equal work, tests/test_apps.py:125
CF_TOL = 2e-4         # tests/test_kernels.py:63,317
CF_CHECK_QUERIES = 128  # the plain cf_refine gathers [Q, B, I]: 21.8 GB per
                        # tensor at the full batch, so it runs in slices
# Two buckets whose stage-1 weights lie this close can swap ranks between
# the card and the CPU (fp32 sums in another order; the weights differ by
# about 1e-6), and so change which users a query refines.
RANK_TIE_TOL = 1e-5
# A prediction more than half a star (the rounding of the 1..5 scale) outside
# [1, 5] is that far from any rating; on this data under 1e-3 of them are.
PRED_SLACK = 0.5
PRED_OUT_SHARE = 1e-3
# The ratings' noise (make_netflix_like: 0.5 stars) is a floor no job's RMSE
# reaches without the held-out ratings; every job must beat each user's mean
# rating; and AccurateML's and the sampled job's loss against exact stays
# under the reference's 6 % (tests/test_apps.py:102-112).
RMSE_FLOOR = 0.5
RMSE_LOSS_MAX = 0.06

KNN_KERNELS = ("distance_topk", "candidate_topk", "knn_distance",
               "refine_distances")
CF_KERNELS = ("cf_weights", "cf_refine")
LSH_KERNELS = ("lsh_hash",)

# Published peaks of one H100 SXM (NVIDIA data sheet): fp32 on the CUDA
# cores and HBM3 bandwidth, both at the full 700 W power limit.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

REPLACES = {
    "distance_topk": "src/repro/kernels/distance_topk.py:84",
    "candidate_topk": "src/repro/kernels/topk_stream.py:118",
    "knn_distance": "src/repro/kernels/knn_distance.py:51",
    "refine_distances": "src/repro/kernels/refine_distances.py:66",
    "lsh_hash": "src/repro/kernels/lsh_hash.py:50",
    "cf_weights": "src/repro/kernels/cf_weights.py:70",
    "cf_refine": "src/repro/kernels/cf_refine.py:115",
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# capturing the main path's kernel inputs
# ---------------------------------------------------------------------------

class CaptureProbe:
    """An ops probe that keeps the first call of each op at each distinct
    set of argument shapes, and otherwise just forwards the call."""

    def __init__(self, torch):
        self.torch = torch
        self.calls: dict[str, dict] = {}

    def _sig(self, a):
        return tuple(a.shape) if isinstance(a, self.torch.Tensor) else a

    def timed(self, op, fn, args, kwargs):
        key = tuple(self._sig(a) for a in args) + tuple(
            sorted((k, self._sig(v)) for k, v in kwargs.items())
        )
        self.calls.setdefault(op, {}).setdefault(key, (args, kwargs))
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def bench_ms(torch, fn, flush) -> float:
    """Median CUDA-event time of fn(), the L2 cache flushed before each run
    (the main path finds its large inputs cold)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    reps = max(3, min(20, int(2000.0 / max(first, 1e-3))))
    times = []
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def work(torch, op, args, kwargs):
    """(flops, bytes) the op must do and move on these inputs: each input
    read once, each output written once."""
    k = kwargs.get("k")
    if op == "distance_topk":
        q, p, labels = args[:3]
        valid = args[3] if len(args) > 3 else kwargs.get("valid")
        nq, d = q.shape
        n = p.shape[0]
        nbytes = 4 * (nq * d + n * d + n) + (n if valid is not None else 0)
        return 2.0 * nq * n * d, nbytes + 8 * nq * k
    if op == "candidate_topk":
        dists = args[0]
        nq, m = dists.shape
        seeded = len(args) > 2 and args[2] is not None
        return 0.0, 8 * nq * m + (8 * nq * k if seeded else 0) + 8 * nq * k
    if op == "knn_distance":
        q, p = args
        nq, d = q.shape
        n = p.shape[0]
        return 2.0 * nq * n * d, 4 * (nq * d + n * d + nq * n)
    if op == "refine_distances":
        q, x, idx, valid = args
        nq, d = q.shape
        nb = idx.shape[1]
        n_valid = int(valid.sum())
        rows = int(torch.unique(idx[valid]).numel())
        return (4.0 * n_valid * d,
                4 * nq * d + 4 * rows * d + 4 * nq * nb + nq * nb + 4 * nq * nb)
    if op == "lsh_hash":
        x, a = args[:2]
        n, d = x.shape
        h = a.shape[1]
        return 2.0 * n * d * h, 4 * (n * d + d * h + h + n * h)
    if op == "cf_weights":
        a, _, u, _ = args
        nq, ni = a.shape
        nu = u.shape[0]
        return 6.0 * nq * nu * ni, 4 * (2 * nq * ni + 2 * nu * ni + nq * nu)
    if op == "cf_refine":
        # per used slot and item: four multiply-adds for the four sums and
        # two for the accumulations (12 operations); the squares of the
        # centred ratings once per query and per distinct used row.  Each
        # distinct used row read once; w written once.
        a, _, _, _, idx, use = args
        nq, ni = a.shape
        nb = idx.shape[1]
        rows = int(torch.unique(idx[use]).numel())
        return (12.0 * int(use.sum()) * ni + (nq + rows) * ni,
                4 * 4 * nq * ni + 8 * rows * ni + 9 * nq * nb)
    raise ValueError(op)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def compare_topk(torch, big, got_d, got_l, want_d, want_l, next_d):
    """Kernel (got) vs plain (want) top-k.  ``next_d`` is the plain
    ranking's (k+1)-th distance per row, for the near-tie test.  Returns
    (max_abs_err, mismatches, near_ties, examples, tie_rows)."""
    got_pad = got_d >= big / 2
    want_pad = want_d >= big / 2
    if not torch.equal(got_pad, want_pad):
        fail(f"padding slots differ at {int((got_pad != want_pad).sum())} "
             "places")
    real = ~want_pad
    err = (got_d - want_d).abs()
    max_err = float(err[real].max()) if bool(real.any()) else 0.0
    tol = ATOL + RTOL * want_d.abs()
    if bool((err > tol)[real].any()):
        bad = int((err > tol)[real].sum())
        fail(f"{bad} distances beyond tolerance (max err {max_err:.3e})")
    ext = torch.cat([want_d, next_d[:, None]], dim=1)
    close = ((ext[:, 1:] - ext[:, :-1]).abs()
             <= ATOL + RTOL * ext[:, 1:].abs())          # [Q, k]
    tie = torch.zeros_like(real)
    tie[:, 1:] |= close[:, :-1]      # ties with the slot before
    tie |= close                     # ties with the slot after
    mism = real & (got_l != want_l)
    unexplained = mism & ~tie
    if bool(unexplained.any()):
        q, j = [int(v) for v in unexplained.nonzero()[0]]
        fail(f"{int(unexplained.sum())} label mismatches with no near-tie, "
             f"first at query {q} slot {j}: kernel ({float(got_d[q, j])}, "
             f"{int(got_l[q, j])}) vs plain ({float(want_d[q, j])}, "
             f"{int(want_l[q, j])})")
    examples = [
        f"q{int(q)}/slot{int(j)} d={float(want_d[q, j]):.6g}"
        for q, j in mism.nonzero()[:3]
    ]
    return max_err, int(mism.sum()), int((mism & tie).sum()), examples, \
        mism.any(dim=1)


def cf_refine_slice(args, lo, hi):
    """The cf_refine arguments of queries [lo, hi)."""
    a, am, r, m, idx, use = args
    return (a[lo:hi], am[lo:hi], r, m, idx[lo:hi], use[lo:hi])


def check_kernel(torch, ref, topk_stream, op, wrapper, args, kwargs):
    """Run kernel and plain version on the captured inputs; return the
    comparison summary."""
    big = topk_stream.BIG
    none = {"label_mismatch": 0, "near_ties": 0, "near_tie_examples": []}
    if op == "cf_refine":
        args = cf_refine_slice(args, 0, CF_CHECK_QUERIES)
    got = wrapper(*args, **kwargs)
    want = getattr(ref, op)(*args, **kwargs)
    torch.cuda.synchronize()
    if op == "lsh_hash":
        diff = (got.long() - want.long()).abs()
        flipped = float((diff > 0).float().mean())
        if int(diff.max()) > 1 or flipped >= 1e-3:
            fail(f"lsh_hash: max diff {int(diff.max())}, {flipped:.2e} of "
                 "hashes differ (allowed: 1, under 1e-3)")
        return {"max_abs_err": float(diff.max()), "flipped_share": flipped,
                **none}
    if op in CF_KERNELS:
        outs = (zip(("w", "num", "den"), got, want) if op == "cf_refine"
                else [("w", got, want)])
        max_err = 0.0
        for name, g, w in outs:
            err = (g - w).abs()
            max_err = max(max_err, float(err.max()) if err.numel() else 0.0)
            if not bool(torch.isfinite(g).all()) or bool(
                    (err > CF_TOL + CF_TOL * w.abs()).any()):
                fail(f"{op} {name}: beyond tolerance (max err "
                     f"{float(err.max()):.3e})")
        return {"max_abs_err": max_err, **none}
    if op in ("distance_topk", "candidate_topk"):
        k = kwargs["k"]
        ext_d, _ = getattr(ref, op)(*args, **{**kwargs, "k": k + 1})
        err, mism, ties, ex, _ = compare_topk(
            torch, big, got[0], got[1], want[0], want[1], ext_d[:, k]
        )
        return {"max_abs_err": err, "label_mismatch": mism,
                "near_ties": ties, "near_tie_examples": ex}
    pad_got, pad_want = got >= big / 2, want >= big / 2
    if not torch.equal(pad_got, pad_want):
        fail(f"{op}: BIG slots differ")
    real = ~pad_want
    err = (got - want).abs()
    max_err = float(err[real].max()) if bool(real.any()) else 0.0
    if bool((err > ATOL + RTOL * want.abs())[real].any()):
        fail(f"{op}: distances beyond tolerance (max err {max_err:.3e})")
    return {"max_abs_err": max_err, "label_mismatch": 0, "near_ties": 0,
            "near_tie_examples": []}


def plain_call(ref, op, args, kwargs):
    """The plain version on the captured inputs, as one timed function.
    The plain cf_refine runs in slices of CF_CHECK_QUERIES queries, the most
    whose [Q, B, I] gathers fit beside the path's data."""
    plain = getattr(ref, op)
    if op != "cf_refine":
        return lambda: plain(*args, **kwargs)
    nq = args[0].shape[0]
    return lambda: [plain(*cf_refine_slice(args, lo, lo + CF_CHECK_QUERIES),
                          **kwargs)
                    for lo in range(0, nq, CF_CHECK_QUERIES)]


def library_call(torch, op, args, kwargs):
    """One PyTorch call computing the same function, where there is one.
    Timed as a yardstick only; the port never calls it.  None for
    distance_topk, refine_distances, lsh_hash (a product, then a floor),
    cf_weights (three masked products) and cf_refine (a gather, then
    reductions)."""
    if op == "knn_distance":
        q, p = args
        return lambda: torch.cdist(q, p)
    if op == "candidate_topk":
        dists, labels = args[:2]
        cat = dists
        if len(args) > 2 and args[2] is not None:
            cat = torch.cat([args[2], dists], dim=1)
        return lambda: torch.topk(cat, kwargs["k"], dim=1, largest=False)
    return None


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_kernels(build):
    t0 = time.perf_counter()
    out_dir = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{out_dir.relative_to(Path(__file__).resolve().parent)}")
    for log in sorted(out_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")


def _host_ms(torch, fn):
    """(fn(), its time on the host clock up to a synchronise, in ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _timed_job(torch, ops, jobs, name, fn, kernels=KNN_KERNELS):
    """Run one job of a path once (cold), on the host clock up to a
    synchronise, and note the launches it made of the path's kernels."""
    before = ops.launch_counts()
    out, ms = _host_ms(torch, fn)
    after = ops.launch_counts()
    launches = {op: after[op] - before[op] for op in kernels}
    jobs[name] = {"ms": ms, "launches": launches}
    print(f"{name}: {ms:.1f} ms, launches {launches}")
    return out


def make_data(torch, make_mfeat_like):
    """(train_x, train_y, test_x, test_y) on the card at mfeat-factors
    scale, from seed 0."""
    x, y = make_mfeat_like(
        torch.Generator("cuda").manual_seed(0), n_points=N_TRAIN + N_QUERY,
        n_features=N_FEATURES, n_classes=N_CLASSES, modes_per_class=96,
        mode_scale=0.5, device="cuda",
    )
    return x[N_QUERY:], y[N_QUERY:], x[:N_QUERY], y[:N_QUERY]


def knn_jobs(torch, knn, train_x, train_y, test_x) -> dict:
    """The main path's jobs by name, each a call returning [Q] labels."""
    common = dict(k=K, n_classes=N_CLASSES, n_shards=N_SHARDS, device="cuda")
    jobs = {
        "run_exact": lambda: knn.run_exact(train_x, train_y, test_x,
                                           **common),
        "run_sampled": lambda: knn.run_sampled(
            train_x, train_y, test_x, sample_frac=SAMPLE_FRAC,
            sample_generator=torch.Generator("cuda").manual_seed(3),
            **common),
    }
    for eps in EPS_LEVELS:
        jobs[f"run_accurateml eps={eps}"] = (
            lambda eps=eps: knn.run_accurateml(
                train_x, train_y, test_x, compression_ratio=RATIO,
                eps_max=eps,
                lsh_generator=torch.Generator("cuda").manual_seed(1),
                **common))
    return jobs


def knn_path(torch, knn, engine, lsh, refine, ops, probe, train_x, train_y,
             test_x, test_y):
    """The port's kNN path, its kernel calls captured by ``probe``; returns
    (accuracies, shuffle_bytes, launch counts, per-job times and
    launches)."""
    ops.set_probe(probe)
    ops.reset_launch_counts()
    acc = {}
    jobs = {}
    timed_job = partial(_timed_job, torch, ops, jobs)
    for name, fn in knn_jobs(torch, knn, train_x, train_y, test_x).items():
        pred = timed_job(name, fn)
        acc[name] = knn.accuracy(pred, test_y)
        if pred.shape != (N_QUERY,) or not bool(
                ((pred >= 0) & (pred < N_CLASSES)).all()):
            fail(f"{name}: bad predictions")

    # One with_bound batch through the engine, on shard 0.
    n_s = train_x.shape[0] // N_SHARDS
    sx, sy = train_x[:n_s], train_y[:n_s]
    cfg = lsh.config_for_compression(n_s, RATIO)
    params = lsh.init_lsh(torch.Generator("cuda").manual_seed(2), N_FEATURES,
                          cfg)
    prepared = knn.build_knn_aggregates(sx, sy, params, N_CLASSES)
    budget = refine.eps_to_budget(n_s, EPS_LEVELS[-1])

    def reduce_fn(g):
        d, lab = knn.merge_topk(g[0], g[1], K)
        return d, lab, knn.majority_vote(d, lab, N_CLASSES), g[2].max(0).values

    mr = engine.MapReduce(mesh=None)
    out = timed_job("MapReduce accurateml_map with_bound", lambda: mr.run(
        partial(knn.accurateml_map, k=K, refine_budget=budget,
                with_bound=True),
        engine.CombineSpec(mode="all_gather", reduce_fn=reduce_fn),
        sx, sy, replicated_args=(prepared, test_x)))
    counts = ops.launch_counts()
    ops.set_probe(None)
    d, lab, vote, bound = out
    if d.shape != (N_QUERY, K) or bound.shape != (N_QUERY,):
        fail("with_bound batch: bad output shapes")
    if not bool(torch.isfinite(d).all()) or not bool(
            ((bound >= 0) & (bound <= 1)).all()):
        fail("with_bound batch: non-finite distances or bound outside [0,1]")
    acc["with_bound shard 0"] = knn.accuracy(vote, test_y)
    print(f"with_bound: mean bound {float(bound.mean()):.4f}, "
          f"budget {budget} originals per query")
    return acc, mr.last_shuffle_bytes, counts, jobs


def make_cf_data(torch, make_netflix_like, holdout_split):
    """(neighbourhood ratings, mask, active ratings, active mask, truth,
    test mask) on the card at the Netflix subset's scale, from seed 1: the
    split of benchmarks/common.py:52-66 (20 % held out, train ratings in)."""
    ratings, mask = make_netflix_like(
        torch.Generator("cuda").manual_seed(1), n_users=CF_USERS + CF_ACTIVE,
        n_items=CF_ITEMS, density=CF_DENSITY, device="cuda")
    train_mask, test_mask = holdout_split(
        torch.Generator("cuda").manual_seed(2), mask, 0.2, device="cuda")
    print(f"CF ratings: density {float(mask.mean()):.5f} (the generator "
          "clips the most popular items' rate at 0.95)")
    del mask
    train_r = ratings * train_mask
    a = CF_ACTIVE
    truth, test_mask = ratings[:a].clone(), test_mask[:a].clone()
    del ratings
    return (train_r[a:], train_mask[a:], train_r[:a], train_mask[:a], truth,
            test_mask)


def cf_jobs(torch, cf, nr, nm, a, am) -> dict:
    """The CF path's jobs by name, each a call returning [Q, I]
    predictions."""
    common = dict(n_shards=N_SHARDS, device="cuda")
    jobs = {
        "cf.run_exact": lambda: cf.run_exact(nr, nm, a, am, **common),
        "cf.run_sampled": lambda: cf.run_sampled(
            nr, nm, a, am, sample_frac=CF_SAMPLE_FRAC,
            sample_generator=torch.Generator("cuda").manual_seed(13),
            **common),
    }
    for eps in CF_EPS_LEVELS:
        jobs[f"cf.run_accurateml eps={eps}"] = (
            lambda eps=eps: cf.run_accurateml(
                nr, nm, a, am, compression_ratio=CF_RATIO, eps_max=eps,
                lsh_generator=torch.Generator("cuda").manual_seed(11),
                **common))
    return jobs


def check_predictions(torch, name, pred):
    if pred.shape != (CF_ACTIVE, CF_ITEMS) or not bool(
            torch.isfinite(pred).all()):
        fail(f"{name}: predictions not finite or of shape "
             f"{tuple(pred.shape)}")
    out = float(((pred < 1.0 - PRED_SLACK) | (pred > 5.0 + PRED_SLACK))
                .float().mean())
    if out >= PRED_OUT_SHARE:
        fail(f"{name}: {out:.2e} of the predictions lie outside [1, 5] +- "
             f"{PRED_SLACK} (allowed: under {PRED_OUT_SHARE}); range "
             f"[{float(pred.min())}, {float(pred.max())}]")
    return out


def check_rmse(cf, rmse, baseline):
    """Each job's RMSE between the noise floor and the user-mean baseline;
    the approximate jobs' loss against exact under RMSE_LOSS_MAX."""
    for name, r in rmse.items():
        if not (math.isfinite(r) and RMSE_FLOOR <= r < baseline):
            fail(f"{name}: RMSE {r} outside [{RMSE_FLOOR}, {baseline}) (the "
                 "noise floor, the user-mean baseline)")
        loss = cf.rmse_loss(rmse["cf.run_exact"], r)
        if name.startswith("cf.run_") and loss >= RMSE_LOSS_MAX:
            fail(f"{name}: RMSE loss {loss:.4f} against exact, not under "
                 f"{RMSE_LOSS_MAX}")


def cf_path(torch, cf, engine, lsh, refine, ops, probe, data):
    """The port's CF path, its kernel calls captured by ``probe``; every job
    runs cold, then once warm.  Returns (RMSEs, shuffle_bytes, launch
    counts, per-job times and launches)."""
    nr, nm, a, am, truth, tmask = data
    ops.set_probe(probe)
    ops.reset_launch_counts()
    rmse = {}
    jobs = {}
    for name, fn in cf_jobs(torch, cf, nr, nm, a, am).items():
        pred = _timed_job(torch, ops, jobs, name, fn, CF_KERNELS)
        out = check_predictions(torch, name, pred)
        rmse[name] = cf.rmse(pred, truth, tmask)
        warm, jobs[name]["warm_ms"] = _host_ms(torch, fn)
        if bool(((warm - pred).abs() > CF_TOL + CF_TOL * pred.abs()).any()):
            fail(f"{name}: the warm run gave other predictions")
        print(f"{name}: warm {jobs[name]['warm_ms']:.1f} ms, "
              f"RMSE {rmse[name]:.6f}, predictions in "
              f"[{float(pred.min()):.3f}, {float(pred.max()):.3f}], {out:.2e} "
              f"of them outside [1, 5] +- {PRED_SLACK}")

    # One with_bound batch through the engine, on shard 0: the psum combine
    # and the reduce of the serving adapter (src/repro/apps/cf.py:CFServable).
    n_s = nr.shape[0] // N_SHARDS
    sr, sm = nr[:n_s], nm[:n_s]
    cfg = lsh.config_for_compression(n_s, CF_RATIO, n_hashes=4,
                                     bucket_width=8.0)
    params = lsh.init_lsh(torch.Generator("cuda").manual_seed(12), CF_ITEMS,
                          cfg)
    prepared = cf.build_cf_aggregates(sr, sm, params)
    budget = refine.eps_to_budget(n_s, CF_EPS_LEVELS[-1])

    def reduce_fn(nd):
        pred = cf.predict(nd[0], nd[1], a, am)
        stderr = torch.where(nd[1] > 1e-8,
                             nd[2].sqrt() / torch.clamp_min(nd[1], 1e-8), 0.0)
        return pred, cf.CF_BOUND_Z * stderr.mean(dim=-1)

    mr = engine.MapReduce(mesh=None)
    pred, bound = _timed_job(
        torch, ops, jobs, "cf MapReduce accurateml_map with_bound",
        lambda: mr.run(
            partial(cf.accurateml_map, refine_budget=budget, with_bound=True),
            engine.CombineSpec(mode="psum", reduce_fn=reduce_fn),
            sr, sm, replicated_args=(prepared, a, am)),
        CF_KERNELS)
    counts = ops.launch_counts()
    ops.set_probe(None)
    check_predictions(torch, "cf with_bound batch", pred)
    if bound.shape != (CF_ACTIVE,) or not bool(
            (torch.isfinite(bound) & (bound >= 0)).all()):
        fail("cf with_bound batch: bound not finite and >= 0")
    rmse["cf with_bound shard 0"] = cf.rmse(pred, truth, tmask)
    print(f"cf with_bound: mean bound {float(bound.mean()):.4f} stars, "
          f"budget {budget} users per query, RMSE "
          f"{rmse['cf with_bound shard 0']:.6f}")
    baseline = cf.rmse(cf.predict(torch.zeros_like(a), torch.zeros_like(a),
                                  a, am), truth, tmask)
    print(f"CF user-mean baseline RMSE {baseline:.6f}")
    check_rmse(cf, rmse, baseline)
    return rmse, mr.last_shuffle_bytes, counts, jobs


def lsh_phase(torch, ref, lsh, ops, probe, knn_rows, cf_ratings, cf_mask):
    """ops.lsh_hash on the hash inputs of both paths: kNN shard 0's rows
    and CF shard 0's centred profiles, each with its path's LSH config."""
    ops.set_probe(probe)
    ops.reset_launch_counts()
    for name, x, cfg in (
        ("kNN shard 0", knn_rows,
         lsh.config_for_compression(knn_rows.shape[0], RATIO)),
        ("CF shard 0", ref._centred(cf_ratings, cf_mask),
         lsh.config_for_compression(cf_ratings.shape[0], CF_RATIO,
                                    n_hashes=4, bucket_width=8.0)),
    ):
        params = lsh.init_lsh(torch.Generator("cuda").manual_seed(14),
                              x.shape[1], cfg)
        h, ms = _host_ms(torch, lambda: ops.lsh_hash(x, params.a, params.b,
                                                     cfg.bucket_width))
        print(f"lsh_hash on {name} {tuple(x.shape)}: {tuple(h.shape)} "
              f"hashes, {ms:.2f} ms cold")
    counts = ops.launch_counts()
    ops.set_probe(None)
    return counts


def _to_cuda(dc):
    return type(dc)(**{f.name: getattr(dc, f.name).cuda()
                       for f in dataclasses.fields(dc)})


def small_check(torch, knn, lsh, refine, make_mfeat_like):
    """End-to-end answers on the card against the same functions on the CPU
    (the plain versions), on a small input and the same aggregates."""
    from repro_torch.kernels import topk_stream

    gen = torch.Generator("cuda").manual_seed(5)
    x, y = make_mfeat_like(gen, n_points=40_000 + 256,
                           n_features=N_FEATURES, n_classes=N_CLASSES,
                           modes_per_class=96, mode_scale=0.5, device="cuda")
    tx, ty, qx = x[256:], y[256:], x[:256]
    cpu = [t.cpu() for t in (tx, ty, qx)]
    big = topk_stream.BIG

    # exact map + merge over 2 shards
    n2 = tx.shape[0] // 2
    outs = {}
    for dev, (a, b, q) in (("cuda", (tx, ty, qx)), ("cpu", cpu)):
        parts = [knn.exact_map(a[s * n2:(s + 1) * n2], b[s * n2:(s + 1) * n2],
                               q, k=K + 1) for s in range(2)]
        outs[dev] = knn.merge_topk(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]), K + 1)
    gd, gl = outs["cuda"]
    wd, wl = outs["cpu"]
    _, mism, ties, _, tie_rows = compare_topk(
        torch, big, gd[:, :K].cpu(), gl[:, :K].cpu(), wd[:, :K], wl[:, :K],
        wd[:, K])
    vg = knn.majority_vote(gd[:, :K], gl[:, :K], N_CLASSES).cpu()
    vw = knn.majority_vote(wd[:, :K], wl[:, :K], N_CLASSES)
    if bool((vg != vw)[~tie_rows].any()):
        fail("small exact: votes differ on rows without a near-tie")
    print(f"small exact (2 shards, cuda vs cpu): {mism} label mismatches, "
          f"all {ties} at near-ties; votes equal on "
          f"{int((vg == vw).sum())}/{vg.numel()}")

    # accurateml_map with_bound on the same aggregates, budget 0 and > 0
    cfg = lsh.config_for_compression(tx.shape[0], RATIO)
    params = lsh.init_lsh(torch.Generator().manual_seed(9), N_FEATURES, cfg,
                          device="cpu")
    agg_cpu = knn.build_knn_aggregates(cpu[0], cpu[1], params, N_CLASSES)
    agg_gpu = knn.KNNAggregates(
        agg=_to_cuda(agg_cpu.agg), bucket_labels=agg_cpu.bucket_labels.cuda(),
        spread=agg_cpu.spread.cuda(), dispersion=agg_cpu.dispersion.cuda())
    for budget in (0, refine.eps_to_budget(tx.shape[0], EPS_LEVELS[-1])):
        g = knn.accurateml_map(tx, ty, agg_gpu, qx, k=K,
                               refine_budget=budget, with_bound=True)
        w = knn.accurateml_map(*cpu[:2], agg_cpu, cpu[2], k=K,
                               refine_budget=budget, with_bound=True)
        # plain ranking at k+1 for the near-tie test
        w_ext = knn.accurateml_map(*cpu[:2], agg_cpu, cpu[2], k=K + 1,
                                   refine_budget=budget)
        _, mism, ties, _, tie_rows = compare_topk(
            torch, big, g[0].cpu(), g[1].cpu(), w[0], w[1], w_ext[0][:, K])
        berr = (g[2].cpu() - w[2]).abs()[~tie_rows]
        if bool((berr > 1e-4).any()):
            fail(f"small accurateml budget {budget}: bound differs by "
                 f"{float(berr.max()):.3e}")
        print(f"small accurateml_map with_bound budget {budget} (cuda vs "
              f"cpu): {mism} label mismatches, all {ties} at near-ties; "
              f"bound max err {float(berr.max()) if berr.numel() else 0:.2e}")

    # aggregation gives the same bits twice on the card
    params_gpu = lsh.LSHParams(a=params.a.cuda(), b=params.b.cuda(),
                               config=params.config)
    a1 = knn.build_knn_aggregates(tx, ty, params_gpu, N_CLASSES)
    a2 = knn.build_knn_aggregates(tx, ty, params_gpu, N_CLASSES)
    for one, two in ((a1.agg, a2.agg), (a1, a2)):
        for f in dataclasses.fields(one):
            a, b = getattr(one, f.name), getattr(two, f.name)
            if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                fail(f"aggregation not deterministic: {f.name}")
    print("aggregation: identical bits on two runs")


def _stage1_tie_rows(torch, cf, ops, agg, a, am, budget):
    """[Q] bool: queries whose stage-1 ranking has two neighbouring buckets
    within RANK_TIE_TOL of each other among the ranks the budget reaches
    (the covered ones and the first one left out).  Computed with the plain
    versions (CPU tensors)."""
    w = ops.cf_weights(a, am, agg.profile, agg.profile_mask)
    w = cf.shrink_weights(w, am @ agg.profile_mask.T).abs()
    w = torch.where(agg.agg.counts[None, :] > 0, w, -1.0)
    vals, order = torch.sort(w, dim=1, descending=True, stable=True)
    reach = torch.cumsum(agg.agg.counts.long()[order], dim=1) <= budget
    reach[:, 1:] |= reach[:, :-1].clone()          # one rank past the last
    close = (vals[:, :-1] - vals[:, 1:]).abs() <= RANK_TIE_TOL
    return (close & reach[:, 1:]).any(dim=1)


def cf_small_check(torch, cf, lsh, refine, ops, make_netflix_like,
                   holdout_split):
    """CF answers on the card against the same functions on the CPU (the
    plain versions), on 4,000 users x 2,000 items and the same aggregates;
    aggregation gives the same bits twice on the card."""
    n_users, n_act, n_items = 4000, 128, 2000
    r, m = make_netflix_like(torch.Generator("cuda").manual_seed(6),
                             n_users=n_users + n_act, n_items=n_items,
                             density=0.05, device="cuda")
    tr, te = holdout_split(torch.Generator("cuda").manual_seed(7), m, 0.2,
                           device="cuda")
    trr = r * tr
    gpu = (trr[n_act:], tr[n_act:], trr[:n_act], tr[:n_act])
    cpu = [t.cpu() for t in gpu]
    truth, tmask = r[:n_act], te[:n_act]

    def close(name, got, want, ties=None):
        """Every row within tolerance, or excused by a near-tie; returns
        the number of rows excused."""
        excused = 0
        for i, (g, w) in enumerate(zip(got, want)):
            bad = ((g.cpu() - w).abs() > CF_TOL + CF_TOL * w.abs()).any(1)
            if ties is not None:
                excused = max(excused, int((bad & ties).sum()))
                bad &= ~ties
            if bool(bad.any()):
                fail(f"small CF {name} output {i}: {int(bad.sum())} rows "
                     "differ beyond tolerance")
        return excused

    close("exact_map", cf.exact_map(*gpu), cf.exact_map(*cpu))
    pred_g = cf.run_exact(*gpu, n_shards=2, device="cuda")
    pred_w = cf.run_exact(*cpu, n_shards=2, device="cpu")
    err = abs(cf.rmse(pred_g, truth, tmask)
              - cf.rmse(pred_w, truth.cpu(), tmask.cpu()))
    if err > 1e-4:
        fail(f"small CF run_exact: RMSE differs by {err:.2e}")

    cfg = lsh.config_for_compression(n_users, CF_RATIO, n_hashes=4,
                                     bucket_width=8.0)
    params = lsh.init_lsh(torch.Generator().manual_seed(9), n_items, cfg,
                          device="cpu")
    agg_cpu = cf.build_cf_aggregates(cpu[0], cpu[1], params)
    agg_gpu = cf.CFAggregates(
        agg=_to_cuda(agg_cpu.agg),
        **{f.name: getattr(agg_cpu, f.name).cuda()
           for f in dataclasses.fields(agg_cpu) if f.name != "agg"})
    for budget in (0, refine.eps_to_budget(n_users, CF_EPS_LEVELS[-1])):
        g = cf.accurateml_map(*gpu[:2], agg_gpu, *gpu[2:],
                              refine_budget=budget, with_bound=True)
        w = cf.accurateml_map(*cpu[:2], agg_cpu, *cpu[2:],
                              refine_budget=budget, with_bound=True)
        ties = _stage1_tie_rows(torch, cf, ops, agg_cpu, cpu[2], cpu[3],
                                budget) if budget else None
        excused = close(f"accurateml_map budget {budget}", g, w, ties)
        print(f"small CF accurateml_map with_bound budget {budget} (cuda vs "
              f"cpu): num/den/varsum within {CF_TOL} on every row but "
              f"{excused}, each at a stage-1 near-tie "
              f"({0 if ties is None else int(ties.sum())} of {n_act} "
              "queries have one)")
    print(f"small CF run_exact (cuda vs cpu): RMSE differs by {err:.2e}")

    params_gpu = lsh.LSHParams(a=params.a.cuda(), b=params.b.cuda(),
                               config=params.config)
    a1 = cf.build_cf_aggregates(*gpu[:2], params_gpu)
    a2 = cf.build_cf_aggregates(*gpu[:2], params_gpu)
    for one, two in ((a1.agg, a2.agg), (a1, a2)):
        for f in dataclasses.fields(one):
            x, y = getattr(one, f.name), getattr(two, f.name)
            if isinstance(x, torch.Tensor) and not torch.equal(x, y):
                fail(f"CF aggregation not deterministic: {f.name}")
    print("CF aggregation: identical bits on two runs")


def _shape(args, kwargs) -> str:
    shape = " ".join("x".join(str(d) for d in a.shape) for a in args
                     if hasattr(a, "shape"))
    return shape + (f" k={kwargs['k']}" if "k" in kwargs else "")


TOLS = {
    **dict.fromkeys(KNN_KERNELS, f"rtol {RTOL} + atol {ATOL} on distances; "
                    "labels exact except near-ties"),
    "cf_weights": f"rtol {CF_TOL} + atol {CF_TOL} on the weights",
    "cf_refine": f"rtol {CF_TOL} + atol {CF_TOL} on w, num and den, on the "
                 f"first {CF_CHECK_QUERIES} queries of each call",
    "lsh_hash": "off by at most 1 on under 0.1 % of hashes",
}


def kernel_row(torch, ref, topk_stream, ops, op, calls, counts, jobs, flush):
    """Check the kernel at every captured shape and time it at the shape
    with the largest least time (lsh_hash and cf_weights, whose shapes are
    different stages: at each shape); the row of the ``{"kernels": [...]}``
    line."""
    wrapper = ops.KERNELS[op]
    summaries = [check_kernel(torch, ref, topk_stream, op, wrapper, args,
                              kwargs)
                 for args, kwargs in calls.values()]
    ranked = sorted(calls.values(),
                    key=lambda c: -bound_ms(*work(torch, op, *c))[0])
    timed = []
    every = op in ("lsh_hash", "cf_weights")
    for args, kwargs in ranked if every else ranked[:1]:
        b_ms, b_by = bound_ms(*work(torch, op, args, kwargs))
        lib = library_call(torch, op, args, kwargs)
        timed.append({
            "shape": _shape(args, kwargs),
            "ms": bench_ms(torch, lambda: wrapper(*args, **kwargs), flush),
            "plain_ms": bench_ms(torch, plain_call(ref, op, args, kwargs),
                                 flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": bench_ms(torch, lib, flush) if lib else None,
        })
    top = timed[0]
    row = {
        "name": op, "route": "cuda", "source": f"src/repro_torch/csrc/{op}.cu",
        "replaces": REPLACES[op], "launches": counts[op],
        "launches_per_job": {job: j["launches"][op] for job, j in jobs.items()
                             if op in j["launches"]},
        "max_abs_err": max(s["max_abs_err"] for s in summaries),
        **{key: top[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "timed_shape": top["shape"],
        "shapes_checked": len(summaries),
        "label_mismatch": sum(s["label_mismatch"] for s in summaries),
        "near_ties": sum(s["near_ties"] for s in summaries),
        "near_tie_examples": [e for s in summaries
                              for e in s["near_tie_examples"]][:3],
        "tol": TOLS[op],
    }
    if len(timed) > 1:
        row["other_shapes"] = timed[1:]
    print(f"{op}: {top['ms']:.3f} ms (plain {top['plain_ms']:.3f}, bound "
          f"{top['bound_ms']:.4f} by {top['bound_by']}, library "
          f"{top['library_ms']}) over {len(summaries)} shapes")
    return row


def check_launched(path, counts, kernels):
    print(f"launches on the {path} path: "
          f"{ {op: counts[op] for op in kernels} }")
    missing = [op for op in kernels if counts[op] == 0]
    if missing:
        fail(f"kernels never launched on the {path} path: {missing}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.apps import cf, knn
    from repro_torch.core import engine, lsh, refine
    from repro_torch.data.synthetic import (
        holdout_split, make_mfeat_like, make_netflix_like,
    )
    from repro_torch.kernels import _build, ops, ref, topk_stream

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    build_kernels(_build)
    probe = CaptureProbe(torch)

    # ---- kNN path ----
    t0 = time.perf_counter()
    train_x, train_y, test_x, test_y = make_data(torch, make_mfeat_like)
    torch.cuda.synchronize()
    print(f"data: {N_TRAIN} x {N_FEATURES} train, {N_QUERY} queries, "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    acc, shuffle_bytes, counts_knn, jobs = knn_path(
        torch, knn, engine, lsh, refine, ops, probe, train_x, train_y, test_x,
        test_y)
    for name, a in acc.items():
        print(f"accuracy {name}: {a:.4f}")
    for eps in EPS_LEVELS:
        loss = knn.accuracy_loss(acc["run_exact"],
                                 acc[f"run_accurateml eps={eps}"])
        print(f"accuracy loss accurateml eps={eps} vs exact: {loss:.4f}")
    print(f"shuffle_bytes: {shuffle_bytes}")
    print(json.dumps({"jobs": jobs, "accuracy": acc,
                      "shuffle_bytes": shuffle_bytes}))
    check_launched("kNN", counts_knn, KNN_KERNELS)
    if acc["run_exact"] < 0.9:
        fail(f"exact accuracy {acc['run_exact']:.4f} < 0.9 on mixture data")

    # ---- CF path ----
    t0 = time.perf_counter()
    cf_data = make_cf_data(torch, make_netflix_like, holdout_split)
    torch.cuda.synchronize()
    print(f"CF data: {CF_USERS} x {CF_ITEMS} neighbourhood, {CF_ACTIVE} "
          f"active users, {(time.perf_counter() - t0) * 1e3:.0f} ms; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rmse, cf_shuffle_bytes, counts_cf, cf_jobs_out = cf_path(
        torch, cf, engine, lsh, refine, ops, probe, cf_data)
    loss = {name: cf.rmse_loss(rmse["cf.run_exact"], rmse[name])
            for name in rmse if name != "cf.run_exact"}
    for name, r in rmse.items():
        print(f"RMSE {name}: {r:.6f}" + (f", RMSE loss vs exact "
                                         f"{loss[name]:.6f}"
                                         if name in loss else ""))
    print(json.dumps({"cf_jobs": cf_jobs_out, "rmse": rmse,
                      "rmse_loss": loss, "shuffle_bytes": cf_shuffle_bytes}))
    check_launched("CF", counts_cf, CF_KERNELS)

    # ---- LSH hash phase ----
    n_s = train_x.shape[0] // N_SHARDS
    cf_n_s = cf_data[0].shape[0] // N_SHARDS
    counts_lsh = lsh_phase(torch, ref, lsh, ops, probe, train_x[:n_s],
                           cf_data[0][:cf_n_s], cf_data[1][:cf_n_s])
    check_launched("LSH hash", counts_lsh, LSH_KERNELS)

    # ---- every kernel against its plain version ----
    counts = {**counts_knn, **{op: counts_cf[op] for op in CF_KERNELS},
              **{op: counts_lsh[op] for op in LSH_KERNELS}}
    all_jobs = {**jobs, **cf_jobs_out,
                "lsh phase": {"launches": {op: counts_lsh[op]
                                           for op in LSH_KERNELS}}}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = [kernel_row(torch, ref, topk_stream, ops, op, probe.calls[op],
                       counts, all_jobs, flush)
            for op in ops.KERNELS]
    del flush, cf_data

    small_check(torch, knn, lsh, refine, make_mfeat_like)
    cf_small_check(torch, cf, lsh, refine, ops, make_netflix_like,
                   holdout_split)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after start, "
          "the build included")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
