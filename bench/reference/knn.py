"""kNN classification by AccurateML (paper §III-D, application 1) and by an
exact scan, in plain PyTorch.

A map task holds a contiguous shard of the training set.  AccurateML
buckets the shard by p-stable LSH, aggregates each bucket into its
centroid (labelled by its most frequent class, the lower class on a tie),
and answers each query from the k nearest of [the centroids of the live
buckets it did not refine, the originals it refined]; with eps_max 0 from
the centroids alone.  A query refines the buckets nearest to it, each
bucket's originals in index order, until ceil(eps_max N) originals are
taken; only buckets taken whole drop their centroid.  The reduce keeps the
k nearest candidates over all map tasks and votes: the most frequent
class, the lower class on a tie.
"""
from __future__ import annotations

import dataclasses

import torch

from bench import data
from bench.reference import common


@dataclasses.dataclass
class Answer:
    dist: torch.Tensor     # [Q, k] merged k nearest squared distances
    labels: torch.Tensor   # [Q, k] their labels (int64)
    votes: torch.Tensor    # [Q] the job's answer (int64)
    shards: list           # per map task: the counts the work functions use


def sq_dists(q: torch.Tensor, x: torch.Tensor, precision: str
             ) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] squared L2 distances."""
    dt = common.dtype_of(precision)
    q, x = q.to(dt), x.to(dt)
    cross = common.mm(q, x.T, precision)
    return ((q * q).sum(1)[:, None] - 2.0 * cross
            + (x * x).sum(1)[None, :]).clamp_min(0.0)


def _k_smallest(d: torch.Tensor, lab: torch.Tensor, k: int):
    """The k smallest of each row (inf-padded), the lower column first on
    equal values."""
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, d.new_full((d.shape[0], pad), torch.inf)], 1)
        lab = torch.cat([lab, lab.new_zeros((lab.shape[0], pad))], 1)
    vals, pick = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], lab.gather(1, pick[:, :k])


def vote(dist: torch.Tensor, labels: torch.Tensor, n_classes: int
         ) -> torch.Tensor:
    """Majority class of the finite neighbours; the lower class on a tie."""
    onehot = torch.nn.functional.one_hot(labels, n_classes)
    onehot = onehot * torch.isfinite(dist)[..., None]
    return onehot.sum(1).argmax(1)


def _map_task(x, y, queries, a, b, *, k, n_classes, ratio, eps_max, width,
              precision):
    n = x.shape[0]
    nb = data.n_buckets(n, ratio)
    ids = common.bucket_ids(x, a, b, width, nb, precision)
    counts, order, offsets = common.bucket_order(ids, nb)
    dt = common.dtype_of(precision)
    sums = torch.zeros((nb, x.shape[1]), dtype=dt, device=x.device)
    sums.index_add_(0, ids, x.to(dt))
    means = sums / counts.clamp_min(1)[:, None].to(dt)
    hist = torch.bincount(ids * n_classes + y.long(),
                          minlength=nb * n_classes).reshape(nb, n_classes)
    bucket_label = hist.argmax(1)
    live = counts > 0
    d_cent = sq_dists(queries, means, precision)
    stats = {"n": n, "buckets": nb, "live": int(live.sum())}
    n_budget = common.budget(n, eps_max)
    if n_budget == 0:
        d = torch.where(live[None, :], d_cent, torch.inf)
        lab = bucket_label[None, :].expand_as(d)
        return _k_smallest(d, lab, k), stats
    idx, valid, covered = common.select(d_cent, live, counts, order,
                                        offsets, n_budget)
    d_ref = sq_dists(queries, x, precision).gather(1, idx)
    d_ref = torch.where(valid, d_ref, torch.inf)
    d_c = torch.where(live[None, :] & ~covered, d_cent, torch.inf)
    cand_d = torch.cat([d_c, d_ref], 1)
    cand_l = torch.cat([bucket_label[None, :].expand_as(d_c),
                        y.long()[idx]], 1)
    stats.update(budget=n_budget, refined=int(valid.sum()),
                 rows=int(torch.unique(idx[valid]).numel()))
    return _k_smallest(cand_d, cand_l, k), stats


def accurateml_job(train_x, train_y, queries, draws, *, k: int,
                   n_classes: int, ratio: float, eps_max: float,
                   width: float, precision: str = "float64") -> Answer:
    """The AccurateML kNN job over ``len(draws)`` map tasks, one LSH draw
    (a [D, H], b [H]) each."""
    parts, shards = [], []
    for (lo, hi), (a, b) in zip(
            data.shard_bounds(train_x.shape[0], len(draws)), draws):
        part, stats = _map_task(
            train_x[lo:hi], train_y[lo:hi], queries, a, b, k=k,
            n_classes=n_classes, ratio=ratio, eps_max=eps_max, width=width,
            precision=precision)
        parts.append(part)
        shards.append(stats)
    dist, labels = _k_smallest(torch.cat([p[0] for p in parts], 1),
                               torch.cat([p[1] for p in parts], 1), k)
    return Answer(dist, labels, vote(dist, labels, n_classes), shards)


def exact_job(train_x, train_y, queries, *, k: int, n_classes: int,
              n_shards: int, precision: str = "float64") -> torch.Tensor:
    """Exact kNN votes [Q]: every original scanned."""
    parts_d, parts_l = [], []
    for lo, hi in data.shard_bounds(train_x.shape[0], n_shards):
        d = sq_dists(queries, train_x[lo:hi], precision)
        vals, pick = torch.topk(d, k, dim=1, largest=False)
        parts_d.append(vals)
        parts_l.append(train_y[lo:hi].long()[pick])
    dist, labels = _k_smallest(torch.cat(parts_d, 1),
                               torch.cat(parts_l, 1), k)
    return vote(dist, labels, n_classes)
