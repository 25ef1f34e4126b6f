"""The frozen work counts, on a two-shard toy worked out by hand, and the
reference's own selection counts where they are known in advance."""
from __future__ import annotations

import pytest
import torch

from bench import data, work
from bench.reference import cf as ref_cf
from bench.reference import knn as ref_knn

KNN_TOY = [dict(n=10, buckets=4, live=3, budget=2, refined=5, rows=4),
           dict(n=12, buckets=4, live=4, budget=2, refined=6, rows=5)]


def test_knn_launches_by_hand():
    got = work.knn_launches(KNN_TOY, q=3, d=2, h=2, k=2)
    assert got == [
        ("lsh_hash", 80.0, 144), ("knn_distance", 36.0, 84),
        ("refine_distances", 40.0, 110), ("candidate_topk", 0.0, 120),
        ("candidate_topk", 0.0, 120),
        ("lsh_hash", 96.0, 168), ("knn_distance", 48.0, 104),
        ("refine_distances", 48.0, 118), ("candidate_topk", 0.0, 120),
        ("candidate_topk", 0.0, 120),
        ("candidate_topk", 0.0, 120),          # the merge of 2 x k
    ]
    assert work.knn_job_flops(KNN_TOY, q=3, d=2, h=2) == 392.0


def test_knn_stage1_only_by_hand():
    shards = [dict(n=10, buckets=4, live=3)]
    got = work.knn_launches(shards, q=3, d=2, h=2, k=2)
    assert got[1] == ("distance_topk", 36.0, 116)
    assert got[2] == ("candidate_topk", 0.0, 4 * 3 * 2 + 4 * 3 * 2 + 48)


def test_cf_launches_by_hand():
    shard = dict(n=4, buckets=2, live=2, rated=7, profile_entries=6,
                 active_rated=3, stage1_co=8, surrogate_entries=10,
                 budget=2, used=3, rows=2, refine_co=4, refine_rated=5)
    got = work.cf_launches([shard], q=2, items=5, h=2)
    assert got == [("lsh_hash", 28.0, 144), ("cf_weights", 57.0, 176),
                   ("cf_refine", 52.0, 276)]
    assert work.cf_job_flops([shard], q=2, items=5, h=2) == 225.0


def test_least_time_takes_the_larger_bound():
    assert work.least_s(67e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(67e9, 3.35e12) == pytest.approx(1.0)


def test_reference_counts_at_a_full_budget():
    """eps_max 1: every query refines every original of its map task."""
    cpu = torch.device("cpu")
    x, y = data.mfeat_like(data.generator(cpu, 1, "x"), 400, 8, 3, 2, 1.0,
                           0.5)
    draws = data.lsh_draws(data.generator(cpu, 1, "lsh"), 8, 2, 4.0, 2)
    got = ref_knn.accurateml_job(x[16:], y[16:], x[:16], draws, k=3,
                                 n_classes=3, ratio=10.0, eps_max=1.0,
                                 width=4.0)
    assert [(s["budget"], s["refined"], s["rows"]) for s in got.shards] == [
        (192, 16 * 192, 192), (192, 16 * 192, 192)]
    r, m = data.netflix_like(data.generator(cpu, 2, "r"), 60, 40, 4, 0.3,
                             0.8, 0.5)
    draws = data.lsh_draws(data.generator(cpu, 2, "lsh"), 40, 2, 8.0, 2)
    got = ref_cf.accurateml_job(r[8:], m[8:], r[:8], m[:8], draws,
                                ratio=5.0, eps_max=1.0, width=8.0)
    assert [(s["used"], s["rows"]) for s in got.shards] == [
        (8 * 26, 26), (8 * 26, 26)]
    assert all(s["surrogate_entries"] == 0 for s in got.shards)
