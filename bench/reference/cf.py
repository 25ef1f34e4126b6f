"""User-based collaborative filtering by AccurateML (paper §III-D,
application 2) and exactly, in plain PyTorch.

    p(u, i) = mean_u + sum_v w(u, v) (r_vi - mean_v) / sum_v |w(u, v)| m_vi

with w the Pearson correlation over co-rated items, shrunk by co / (co +
8) for co co-rated items.  A map task holds a contiguous shard of users.
AccurateML buckets them by p-stable LSH of their centred rating profiles
and keeps per bucket the rating sums, the centred sums and the rater
counts; a bucket's whole contribution is its centroid's weight times its
centred sums (and counts).  A query refines its buckets of largest |w|,
each bucket's users in index order, until ceil(eps_max N) users are taken;
buckets taken whole contribute their users' exact terms instead of the
surrogate.  The reduce adds the map tasks' sums and predicts.
"""
from __future__ import annotations

import dataclasses

import torch

from bench import data
from bench.reference import common

SHRINK = 8.0


@dataclasses.dataclass
class Answer:
    pred: torch.Tensor     # [Q, I] the job's answer
    shards: list           # per map task: the counts the work functions use
    tasks: list            # the MapTasks, to take ambiguous hashes over
    parts: list            # their (num, den) sums
    mean: torch.Tensor     # [Q, 1] the active users' means


def _centred(r: torch.Tensor, m: torch.Tensor):
    """(ratings centred on each row's mean over its rated items, 0 where
    not rated; the means [rows, 1])."""
    mean = (r * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp_min(1)
    return (r - mean) * m, mean


def _pearson(ac, am, uc, um, precision):
    """Shrunk Pearson weights [Q, U] of centred active rows ``ac`` (mask
    ``am``) against centred rows ``uc`` (mask ``um``), over co-rated
    items; and the co-rated counts."""
    num = common.mm(ac, uc.T, precision)
    a_sq = common.mm(ac * ac, um.T, precision)
    u_sq = common.mm(am, (uc * uc).T, precision)
    w = num / torch.sqrt((a_sq * u_sq).clamp_min(1e-12))
    co = common.mm(am, um.T, precision)
    return w * (co / (co + SHRINK)), co


class MapTask:
    """One map task of the AccurateML CF job.  ``contribution`` gives its
    (numerator, denominator) sums [Q, I] with the LSH hashes as the
    reference computes them, or with some of the ``ambiguous`` ones (row,
    hash, the other side's value) taken to the other side of their bucket
    boundary, as a float32 program may round them."""

    def __init__(self, r, m, ac, am, a, b, *, ratio, eps_max, width,
                 precision):
        self.r, self.m, self.ac, self.am = r, m, ac, am
        self.eps_max, self.precision = eps_max, precision
        self.dt = common.dtype_of(precision)
        self.n = r.shape[0]
        self.nb = data.n_buckets(self.n, ratio)
        c_rows, _ = _centred(r.to(self.dt), m.to(self.dt))
        self.h, self.ambiguous = common.hashes(c_rows, a, b, width,
                                               precision)

    def contribution(self, flips=()):
        """((num, den), the counts the work functions use)."""
        h = self.h
        if flips:
            h = h.clone()
            for row, j, value in flips:
                h[row, j] = value
        ids = common.ids_of(h, self.nb)
        return self._sums(ids)

    def _sums(self, ids):
        ac, am, nb, dt, prec = self.ac, self.am, self.nb, self.dt, \
            self.precision
        r, m = self.r.to(dt), self.m.to(dt)
        c_rows, _ = _centred(r, m)
        counts, order, offsets = common.bucket_order(ids, nb)
        live = counts > 0

        def bucket_sum(v):
            return torch.zeros((nb, v.shape[1]), dtype=dt,
                               device=v.device).index_add_(0, ids, v)

        sr, s, c = bucket_sum(r * m), bucket_sum(c_rows), bucket_sum(m)
        profile_mask = (c > 0).to(dt)
        profile_c, _ = _centred(sr / c.clamp_min(1), profile_mask)
        w, _ = _pearson(ac, am, profile_c, profile_mask, prec)
        w = torch.where(live[None, :], w, 0.0)
        active_rated = am.sum(0)
        stats = {
            "n": self.n, "buckets": nb, "live": int(live.sum()),
            "rated": int(m.sum()),
            "profile_entries": int(profile_mask.sum()),
            "active_rated": int(active_rated.sum()),
            "stage1_co": int((active_rated * profile_mask.sum(0)).sum()),
        }
        n_budget = common.budget(self.n, self.eps_max)
        entries = profile_mask.sum(1)                # rated items a bucket
        if n_budget == 0:
            stats["surrogate_entries"] = int(ac.shape[0] * entries.sum())
            return (common.mm(w, s, prec),
                    common.mm(w.abs(), c, prec)), stats
        idx, valid, covered = common.select(-w.abs(), live, counts, order,
                                            offsets, n_budget)
        use = valid & covered.gather(1, ids[idx])
        w_ref, co = _pearson(ac, am, c_rows, m, prec)
        # A row's valid slots name distinct users; its padding slots all
        # name user 0 and add nothing.
        picked = torch.zeros_like(w_ref).scatter_add(
            1, idx, torch.where(use, w_ref.gather(1, idx), 0.0))
        w_unc = torch.where(covered, 0.0, w)
        num = (common.mm(w_unc, s, prec)
               + common.mm(picked, c_rows, prec))
        den = (common.mm(w_unc.abs(), c, prec)
               + common.mm(picked.abs(), m, prec))
        used_rows = idx[use]
        rated = m.sum(1)
        stats.update(
            budget=n_budget,
            surrogate_entries=int((~covered * entries[None, :]).sum()),
            used=int(use.sum()),
            rows=int(torch.unique(used_rows).numel()),
            refine_co=int(co.gather(1, idx)[use].sum()),
            refine_rated=int(rated[used_rows].sum()),
        )
        return (num, den), stats


def predict(num, den, mean):
    return torch.where(den > 1e-8, mean + num / den.clamp_min(1e-8), mean)


def accurateml_job(ratings, mask, active, active_mask, draws, *,
                   ratio: float, eps_max: float, width: float,
                   precision: str = "float64") -> Answer:
    """The AccurateML CF job over ``len(draws)`` map tasks, one LSH draw
    (a [I, H], b [H]) each: predictions [Q, I] for the active users."""
    dt = common.dtype_of(precision)
    am = active_mask.to(dt)
    ac, mean = _centred(active.to(dt), am)
    tasks, parts, shards = [], [], []
    for (lo, hi), (a, b) in zip(
            data.shard_bounds(ratings.shape[0], len(draws)), draws):
        task = MapTask(ratings[lo:hi], mask[lo:hi], ac, am, a, b,
                       ratio=ratio, eps_max=eps_max, width=width,
                       precision=precision)
        part, stats = task.contribution()
        tasks.append(task)
        parts.append(part)
        shards.append(stats)
    num = sum(p[0] for p in parts)
    den = sum(p[1] for p in parts)
    return Answer(predict(num, den, mean), shards, tasks, parts, mean)


def exact_job(ratings, mask, active, active_mask, *, n_shards: int,
              precision: str = "float64") -> torch.Tensor:
    """Exact CF predictions [Q, I]: every user of every shard weighted."""
    dt = common.dtype_of(precision)
    am = active_mask.to(dt)
    ac, mean = _centred(active.to(dt), am)
    num = den = 0.0
    for lo, hi in data.shard_bounds(ratings.shape[0], n_shards):
        r, m = ratings[lo:hi].to(dt), mask[lo:hi].to(dt)
        c_rows, _ = _centred(r, m)
        w, _ = _pearson(ac, am, c_rows, m, precision)
        num = num + common.mm(w, c_rows, precision)
        den = den + common.mm(w.abs(), m, precision)
    return predict(num, den, mean)


def rmse(pred: torch.Tensor, truth: torch.Tensor, test_mask: torch.Tensor
         ) -> float:
    err = (pred.double() - truth.double()) * test_mask.double()
    return float(torch.sqrt((err * err).sum() / test_mask.sum().clamp_min(1)))
