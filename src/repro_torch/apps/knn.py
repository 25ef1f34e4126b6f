"""kNN classification, paper §III-D application 1, in PyTorch.

Three map-task variants share one reduce:

  * ``exact``      — scan all original points,
  * ``sampled``    — scan a uniform subset (the compared prior art, §IV-C),
  * ``accurateml`` — Algorithm 1: distances to the aggregated points first,
                     then exact distances for each query's top-correlated
                     buckets only.

Each map shard outputs its local top-k (distance, label) per test point and
the reduce merges the shards' sets into the global top-k, then
majority-votes.  The hot loops go through ``kernels.ops``: the CUDA kernels
for CUDA tensors, the plain versions for CPU tensors.  A job and its map
tasks open the launch-side stage spans of ``repro_torch.obs.trace``.  The same functions
as ``src/repro/apps/knn.py``, with the same outputs and dtypes, and its
serving adapter ``KNNServable``, whose aggregates come from the aggregate
store (``knn_mergeable_stats`` / ``knn_assemble``).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from repro_torch.core import aggregate as agg_lib
from repro_torch.core import correlation as corr_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import refine as refine_lib
from repro_torch.device import to_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.topk_stream import BIG
from repro_torch.obs.trace import current_tracer
from repro_torch.serve import servable as serve_servable
from repro_torch.serve.request import ErrorBound

# Chebyshev-style slack on the spread/gap displacement probability; see
# src/repro/apps/knn.py, calibrated by benchmarks/error_bounds.py there.
KNN_BOUND_SLACK = 1.0
KNN_BOUND_CONFIDENCE = 0.9


# ---------------------------------------------------------------------------
# distance + vote primitives
# ---------------------------------------------------------------------------

def pairwise_sq_dists(queries: torch.Tensor,
                      points: torch.Tensor) -> torch.Tensor:
    """[Q,D] x [N,D] -> [Q,N] squared L2 (the knn_distance kernel)."""
    return kernel_ops.knn_distance(queries, points)


def local_topk(
    dists: torch.Tensor, labels: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query k smallest distances + their labels, lowest index first on
    ties.  [Q,N],[N] (shared label row) or [Q,N],[Q,N] -> [Q,k] x2."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    idx = idx[..., :k]
    if labels.dim() == dists.dim():
        picked = labels.gather(-1, idx)
    else:
        picked = labels[idx]
    return vals[..., :k], picked


def majority_vote(
    topk_dists: torch.Tensor, topk_labels: torch.Tensor, n_classes: int
) -> torch.Tensor:
    """Majority class among valid (finite-distance) neighbours; the first
    class wins a tie, as ``jnp.argmax`` picks it."""
    valid = topk_dists < BIG / 2
    classes = torch.arange(n_classes, device=topk_labels.device)
    onehot = (topk_labels[..., None] == classes) & valid[..., None]
    return onehot.sum(dim=-2).argmax(dim=-1).to(torch.int32)


def merge_topk(
    gathered_dists: torch.Tensor, gathered_labels: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """[S,Q,k] shard-local top-k -> [Q,k] global top-k (the reduce).

    Shard 0's k-best seeds one streaming selection over shards 1..S-1 in
    order, read in place: the same answer as folding them pairwise, shard
    s's k-best into the running best of shards 0..s-1, which equals one
    top-k over the flattened candidates with the same tie rule.
    """
    s = gathered_dists.shape[0]
    d, lab = gathered_dists[0], gathered_labels[0]
    if s == 1 or d.shape[-1] != k:
        d, lab = local_topk(d, lab, k)  # sort/trim so the seed is a [Q,k] best
    if s == 1:
        return d, lab
    return kernel_ops.candidate_topk(
        gathered_dists[1:], gathered_labels[1:], d, lab, k=k
    )


# ---------------------------------------------------------------------------
# map-task variants
# ---------------------------------------------------------------------------

def exact_map(train_x, train_y, test_x, *, k: int):
    """Basic map task over all original points (paper Fig. 2a): the fused
    distance + running k-best, so the [Q, N] matrix is never written."""
    return kernel_ops.distance_topk(test_x, train_x, train_y, k=k)


def sampled_map(train_x, train_y, test_x, sample_idx, *, k: int,
                n_sample: int):
    """Prior-art approximation: a uniform subset of ``n_sample`` points."""
    take = sample_idx[:n_sample].long()
    return kernel_ops.distance_topk(test_x, train_x[take], train_y[take], k=k)


@dataclasses.dataclass(frozen=True)
class KNNAggregates:
    """Aggregated training shard: centroids + bucket-majority labels.

    ``spread`` and ``dispersion`` feed the per-query stage-1 error bound;
    both are +inf on empty buckets.
    """

    agg: agg_lib.AggregatedData
    bucket_labels: torch.Tensor  # [K] majority label per bucket (int32)
    spread: torch.Tensor         # [K] within-bucket E‖x − μ‖² (+inf if empty)
    dispersion: torch.Tensor     # [K] 1 − majority fraction (+inf if empty)


def label_histogram(
    labels: torch.Tensor, ids: torch.Tensor, n_buckets: int, n_classes: int
) -> torch.Tensor:
    """[N] labels, [N] bucket ids -> [K, C] float32 label counts (exact
    integer counts, so the same in any order)."""
    flat = ids.long() * n_classes + labels.long()
    hist = torch.bincount(flat, minlength=n_buckets * n_classes)
    return hist.reshape(n_buckets, n_classes).float()


def _knn_level(train_x, train_y, ids, n_buckets: int, n_classes: int):
    """The per-bucket counts, feature sums and sums of squares (one stable
    sort and gather) and label histogram, and the index of that sort:
    (stats, BucketIndex)."""
    agg, sums, sumsq = agg_lib.aggregate_with_moments(train_x, ids, n_buckets)
    stats = {
        "counts": agg.counts,
        "sums": sums,
        "sumsq": sumsq,
        "label_hist": label_histogram(train_y, ids, n_buckets, n_classes),
    }
    index = agg_lib.BucketIndex(perm=agg.perm, offsets=agg.offsets,
                                bucket_of=agg.bucket_of)
    return stats, index


def build_knn_aggregates(
    train_x: torch.Tensor, train_y: torch.Tensor,
    params: lsh_lib.LSHParams, n_classes: int,
) -> KNNAggregates:
    tracer = current_tracer()
    with tracer.span("map.lsh"):
        ids = lsh_lib.bucket_ids(train_x, params)
    n_buckets = params.config.n_buckets
    with tracer.span("map.aggregate", n_buckets=n_buckets):
        return knn_assemble(*_knn_level(train_x, train_y, ids, n_buckets,
                                        n_classes))


def knn_mergeable_stats(
    train_x: torch.Tensor, train_y: torch.Tensor, fine_ids: torch.Tensor,
    n_buckets: int, n_classes: int,
) -> dict[str, torch.Tensor]:
    """Additive per-bucket sufficient statistics for the aggregate store:
    int32 point counts, feature sums and sums of squares, and the label
    histogram, all additive under bucket union, so every coarser pyramid
    level merges exactly."""
    return _knn_level(train_x, train_y, fine_ids, n_buckets, n_classes)[0]


def knn_assemble(stats: dict, index: agg_lib.BucketIndex) -> KNNAggregates:
    """Statistics + index -> the prepared aggregates ``accurateml_map``
    uses.  Without a ``sumsq`` entry (a snapshot older than the second
    moments) the spread is +inf everywhere: maximum uncertainty, never 0.
    Labels are the histogram's first maximum, as ``jnp.argmax`` picks it."""
    counts = stats["counts"]
    means = stats["sums"] / torch.clamp_min(counts[:, None].float(), 1.0)
    agg = agg_lib.AggregatedData(
        means=means, counts=counts, perm=index.perm, offsets=index.offsets,
        bucket_of=index.bucket_of,
    )
    if "sumsq" in stats:
        spread = agg_lib.bucket_spread(stats["sums"], stats["sumsq"], counts)
    else:
        spread = torch.full(counts.shape, torch.inf, dtype=torch.float32,
                            device=counts.device)
    return KNNAggregates(
        agg=agg,
        bucket_labels=stats["label_hist"].argmax(dim=-1).to(torch.int32),
        spread=spread,
        dispersion=agg_lib.histogram_dispersion(stats["label_hist"]),
    )


def _vote_bound(
    d: torch.Tensor, lab: torch.Tensor, spread_sel: torch.Tensor,
    disp_sel: torch.Tensor, k: int, hidden: torch.Tensor | None = None,
) -> torch.Tensor:
    """[Q,k+1] selected distances/labels + per-candidate spread/dispersion
    -> [Q] claimed upper bound on the answer's label divergence from exact.

    Per kept neighbour: the displacement risk (its bucket's spread plus the
    first excluded candidate's, against the gap to that candidate, scaled
    by the label-disagreement rate) plus its bucket's dispersion.
    ``hidden`` ([Q], refined path) adds the risk that an unselected,
    unrefined bucket hides a true neighbour.  +inf spread or dispersion and
    BIG-padded slots saturate to 1.  See ``src/repro/apps/knn.py``.
    """
    gap = torch.clamp_min(d[:, k:k + 1] - d[:, :k], 0.0)      # [Q,k]
    sp, dp = spread_sel[:, :k], disp_sel[:, :k]
    valid = d < BIG / 2                                        # [Q,k+1]
    same = (lab[:, None, :] == lab[:, :, None]) & valid[:, None, :]
    n_valid = torch.clamp_min(valid.sum(dim=-1, keepdim=True), 1)
    label_diff = 1.0 - same.sum(dim=-1) / n_valid              # [Q,k+1]
    comp = spread_sel[:, k:k + 1]                              # [Q,1]
    comp = torch.where(valid[:, k:k + 1] & torch.isfinite(comp), comp, 0.0)
    p_disp = torch.clamp_max(
        KNN_BOUND_SLACK * (sp + comp) / torch.clamp_min(gap, 1e-12), 1.0
    )
    p = torch.clamp(p_disp * label_diff[:, :k] + dp, 0.0, 1.0)
    p = torch.where(torch.isinf(sp), 1.0, p)                   # unknown bucket
    p = torch.where(valid[:, :k], p, 1.0)                      # padded slot
    bound = p.mean(dim=-1)
    if hidden is not None:
        kept_diff = torch.where(valid[:, :k], label_diff[:, :k], 0.0)
        bound = torch.clamp(
            bound + hidden * kept_diff.max(dim=-1).values, 0.0, 1.0
        )
    return bound


def _hidden_risk(
    d_cent_masked: torch.Tensor, spread: torch.Tensor, bid: torch.Tensor,
    d_radius: torch.Tensor, n_k: int,
) -> torch.Tensor:
    """[Q] risk that an unselected, unrefined bucket hides a true neighbour:
    a live bucket whose centroid distance minus its spread undercuts the
    kept radius.  The exact-candidate sentinel ``n_k`` matches no bucket."""
    sel = torch.zeros(
        (bid.shape[0], n_k + 1), dtype=torch.bool, device=bid.device
    )
    sel.scatter_(1, bid.long(), True)
    live = (d_cent_masked < BIG / 2) & ~sel[:, :n_k]
    margin = torch.clamp_min(d_cent_masked - d_radius[:, None], 1e-12)
    risk = torch.clamp_max(KNN_BOUND_SLACK * spread[None, :] / margin, 1.0)
    return torch.where(live, risk, 0.0).max(dim=-1).values


def accurateml_map(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    knn_agg: KNNAggregates,
    test_x: torch.Tensor,
    *,
    k: int,
    refine_budget: int,
    with_bound: bool = False,
):
    """Algorithm 1 for kNN, with a per-query refinement ranking.

    Stage 1: distances from every test point to every aggregated point; the
    correlation of bucket i (Definition 4) is minus that distance.
    Stage 2: each test point ranks buckets by its own correlations and
    refines the top buckets until ``refine_budget`` originals were processed
    for it.  Fully refined buckets' centroids are masked out (replaced, not
    double-counted); the answer is one top-k over [unrefined centroids ∪
    refined originals], chained through one running k-best.

    ``with_bound=True`` also returns a [Q] error bound, ``(d, labels,
    bound)``: the selection runs at k+1 and carries each candidate's bucket
    id packed next to its label (``label * (K+1) + bucket``; refined
    originals use the sentinel bucket K).
    """
    tracer = current_tracer()
    agg = knn_agg.agg
    n_k = agg.means.shape[0]
    kk = k + 1 if with_bound else k
    with tracer.span("map.stage1"):
        if with_bound:
            cent_ids = torch.arange(n_k, dtype=torch.int32,
                                    device=test_x.device)
            cent_comb = knn_agg.bucket_labels * (n_k + 1) + cent_ids
            zero = torch.zeros(1, dtype=torch.float32, device=test_x.device)
            spread_ext = torch.cat([knn_agg.spread, zero])
            disp_ext = torch.cat([knn_agg.dispersion, zero])

        if refine_budget <= 0:
            # Pure stage 1: fused distance + top-k over the aggregated points.
            if not with_bound:
                return kernel_ops.distance_topk(
                    test_x, agg.means, knn_agg.bucket_labels, agg.counts > 0,
                    k=k
                )
            d, comb = kernel_ops.distance_topk(
                test_x, agg.means, cent_comb, agg.counts > 0, k=kk
            )
            bid = (comb % (n_k + 1)).long()
            labels = comb // (n_k + 1)
            bound = _vote_bound(d, labels, spread_ext[bid], disp_ext[bid], k)
            return d[:, :k], labels[:, :k], bound

        # ---- stage 1: correlations from the aggregated points (Alg. 1 l.2)
        d_cent = pairwise_sq_dists(test_x, agg.means)         # [Q, K]
        d_cent = torch.where(agg.counts[None, :] > 0, d_cent, BIG)
        corr = -d_cent

    # ---- stage 2: per-query refinement of the top-correlated buckets ----
    with tracer.span("map.select", refine_budget=refine_budget):
        rankings = corr_lib.rank_buckets_multi(corr, agg.counts)  # [Q, K]
        idx, valid = agg_lib.refinement_indices(agg, rankings, refine_budget)
        covered = agg_lib.buckets_fully_covered(agg, rankings, refine_budget)
        covered = covered & (agg.counts[None, :] > 0)

    with tracer.span("map.refine"):
        d_ref = kernel_ops.refine_distances(test_x, train_x, idx, valid,
                                            agg.bucket_of, n_buckets=n_k)
        ref_y = train_y[idx.long()]                           # [Q, B]
        d_cent_masked = torch.where(covered, BIG, d_cent)

        # Masked centroids seed the running k-best, refined candidates
        # merge in.
        if not with_bound:
            cent_labels = knn_agg.bucket_labels[None, :].expand(d_cent.shape)
            best_d, best_l = kernel_ops.candidate_topk(
                d_cent_masked, cent_labels.contiguous(), k=k
            )
            return kernel_ops.candidate_topk(d_ref, ref_y, best_d, best_l,
                                             k=k)

        best_d, best_c = kernel_ops.candidate_topk(
            d_cent_masked,
            cent_comb[None, :].expand(d_cent.shape).contiguous(), k=kk,
        )
        ref_comb = ref_y * (n_k + 1) + n_k
        d, comb = kernel_ops.candidate_topk(d_ref, ref_comb, best_d, best_c,
                                            k=kk)
        bid = (comb % (n_k + 1)).long()
        labels = comb // (n_k + 1)
        hidden = _hidden_risk(d_cent_masked, knn_agg.spread, bid, d[:, k],
                              n_k)
        bound = _vote_bound(
            d, labels, spread_ext[bid], disp_ext[bid], k, hidden=hidden
        )
        return d[:, :k], labels[:, :k], bound


# ---------------------------------------------------------------------------
# end-to-end jobs: shards are contiguous slices of the training set, mapped
# one after another on one device, then merged and voted
# ---------------------------------------------------------------------------

def _shard_slices(n: int, n_shards: int) -> list[slice]:
    return [
        slice(s * n // n_shards, (s + 1) * n // n_shards)
        for s in range(n_shards)
    ]


def _reduce(shards_d, shards_l, k: int, n_classes: int) -> torch.Tensor:
    d, lab = merge_topk(torch.stack(shards_d), torch.stack(shards_l), k)
    return majority_vote(d, lab, n_classes)


def run_exact(
    train_x, train_y, test_x, *, k: int, n_classes: int, n_shards: int = 1,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Exact kNN predictions [Q] int32."""
    _, train_x, train_y, test_x = to_device(device, train_x, train_y, test_x)
    shards_d, shards_l = [], []
    for sl in _shard_slices(train_x.shape[0], n_shards):
        d, lab = exact_map(train_x[sl], train_y[sl], test_x, k=k)
        shards_d.append(d)
        shards_l.append(lab)
    return _reduce(shards_d, shards_l, k, n_classes)


def run_accurateml(
    train_x, train_y, test_x, *, k: int, n_classes: int,
    compression_ratio: float, eps_max: float,
    lsh_generator: torch.Generator | None = None,
    lsh_params: list[lsh_lib.LSHParams] | None = None,
    n_shards: int = 1, n_hashes: int = 4, bucket_width: float = 4.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """AccurateML kNN predictions [Q] int32.

    Each shard's LSH params are drawn from ``lsh_generator`` in shard order,
    or taken from ``lsh_params`` (one per shard, e.g. the JAX reference's
    draws converted by ``repro_torch.convert``).
    """
    if (lsh_generator is None) == (lsh_params is None):
        raise ValueError("pass exactly one of lsh_generator and lsh_params")
    if lsh_params is not None and len(lsh_params) != n_shards:
        raise ValueError(
            f"{len(lsh_params)} lsh_params for {n_shards} shards"
        )
    dev, train_x, train_y, test_x = to_device(
        device, train_x, train_y, test_x
    )
    # The shards' views and LSH draws come before the job's span.
    shards = [(train_x[sl], train_y[sl])
              for sl in _shard_slices(train_x.shape[0], n_shards)]
    params = lsh_lib.shard_lsh_params(
        [sx for sx, _ in shards], compression_ratio, n_hashes=n_hashes,
        bucket_width=bucket_width, generator=lsh_generator,
        params=lsh_params, device=dev)
    tracer = current_tracer()
    with tracer.span("job", app="knn", shards=n_shards,
                     queries=test_x.shape[0], eps_max=eps_max):
        shards_d, shards_l = [], []
        for (sx, sy), p in zip(shards, params):
            knn_agg = build_knn_aggregates(sx, sy, p, n_classes)
            budget = refine_lib.eps_to_budget(sx.shape[0], eps_max)
            d, lab = accurateml_map(
                sx, sy, knn_agg, test_x, k=k, refine_budget=budget
            )
            shards_d.append(d)
            shards_l.append(lab)
        with tracer.span("reduce"):
            return _reduce(shards_d, shards_l, k, n_classes)


def run_sampled(
    train_x, train_y, test_x, *, k: int, n_classes: int,
    sample_frac: float,
    sample_generator: torch.Generator | None = None,
    sample_perms: list[torch.Tensor] | None = None,
    n_shards: int = 1, device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Uniform-sampling kNN predictions [Q] int32.

    Each shard's permutation is drawn from ``sample_generator`` in shard
    order, or taken from ``sample_perms`` (one per shard).
    """
    if (sample_generator is None) == (sample_perms is None):
        raise ValueError(
            "pass exactly one of sample_generator and sample_perms"
        )
    if sample_perms is not None and len(sample_perms) != n_shards:
        raise ValueError(
            f"{len(sample_perms)} sample_perms for {n_shards} shards"
        )
    dev, train_x, train_y, test_x = to_device(
        device, train_x, train_y, test_x
    )
    shards_d, shards_l = [], []
    for s, sl in enumerate(_shard_slices(train_x.shape[0], n_shards)):
        sx, sy = train_x[sl], train_y[sl]
        ns = max(1, int(sample_frac * sx.shape[0]))
        if sample_perms is None:
            perm = torch.randperm(
                sx.shape[0], generator=sample_generator,
                device=sample_generator.device,
            ).to(dev)
        else:
            perm = sample_perms[s].to(dev)
        d, lab = sampled_map(sx, sy, test_x, perm, k=k, n_sample=ns)
        shards_d.append(d)
        shards_l.append(lab)
    return _reduce(shards_d, shards_l, k, n_classes)


# ---------------------------------------------------------------------------
# serving adapter (the Servable protocol of serve/request.py)
# ---------------------------------------------------------------------------

class KNNServable(serve_servable.LSHServableBase):
    """kNN classification behind the ``Servable`` protocol.

    One instance holds one training shard.  ``build`` gives the aggregates
    of a compression ratio from the aggregate store; ``run`` executes
    ``accurateml_map`` through the MapReduce engine (all_gather combine:
    merge the shard top-k, majority-vote, the max of the bounds), so
    ``last_shuffle_bytes`` is metered on the serving path.  Request
    payload: ``(query_vector [D],)``; answer: the predicted class (int).
    """

    name = "knn"

    def __init__(
        self,
        train_x,
        train_y,
        *,
        n_classes: int,
        k: int = 5,
        lsh_generator: torch.Generator | None = None,
        lsh_params=None,
        n_hashes: int = 4,
        bucket_width: float = 4.0,
        engine: engine_lib.MapReduce | None = None,
        store=None,
        pyramid_spec=None,
        device: str | torch.device = "cuda",
    ):
        dev, train_x, train_y = to_device(device, train_x, train_y)
        super().__init__(
            (train_x, train_y), device=dev, lsh_generator=lsh_generator,
            lsh_params=lsh_params, n_hashes=n_hashes,
            bucket_width=bucket_width, engine=engine, store=store,
            pyramid_spec=pyramid_spec,
        )
        self.train_x = train_x
        self.train_y = train_y
        self.n_classes = n_classes
        self.k = k

    # --- store pyramid hooks ---
    def hash_features(self) -> torch.Tensor:
        return self.train_x

    def mergeable_stats(self, fine_ids, n_buckets):
        return knn_mergeable_stats(
            self.train_x, self.train_y, fine_ids, n_buckets, self.n_classes
        )

    def assemble(self, stats, index) -> KNNAggregates:
        prepared = knn_assemble(stats, index)
        means = prepared.agg.means.to(self.train_x.dtype)
        return dataclasses.replace(
            prepared, agg=dataclasses.replace(prepared.agg, means=means))

    def probe_payload(self) -> tuple:
        return (self.train_x[0],)

    def pad_batch(self, payloads, batch: int) -> tuple:
        return self.stack_pad(payloads, batch)

    def run(
        self, prepared: KNNAggregates, batch_payload: tuple,
        *, refine_budget: int,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (d [Q,k], labels [Q,k], vote [Q], bound [Q])."""
        self.check_stage2(refine_budget)
        test_x = self.batch_tensor(batch_payload[0])

        def reduce_fn(g):
            # The merged top-k beside the vote (the neighbour sets feed the
            # stage-1 vs refined accuracy proxy); the bound merges by max:
            # it must hold for every shard's part of the answer.
            d, lab = merge_topk(g[0], g[1], self.k)
            return (d, lab, majority_vote(d, lab, self.n_classes),
                    g[2].max(dim=0).values)

        map_fn = partial(
            accurateml_map, k=self.k, refine_budget=refine_budget,
            with_bound=True,
        )
        combine = engine_lib.CombineSpec(mode="all_gather",
                                         reduce_fn=reduce_fn)
        return self.engine.run(
            map_fn, combine, self.train_x, self.train_y,
            replicated_args=(prepared, test_x),
        )

    def unpack(self, outputs: tuple, n: int) -> list:
        return [int(v) for v in outputs[2][:n].cpu().tolist()]

    def error_bounds(self, stage1_out, n: int) -> list:
        """Per-query claimed bound on label divergence of the stage-1 vote."""
        return [
            ErrorBound(value=float(b), metric="label_divergence",
                       confidence=KNN_BOUND_CONFIDENCE)
            for b in stage1_out[3][:n].cpu().tolist()
        ]

    def accuracy_proxy(self, stage1_out, refined_out, n: int) -> list[float]:
        """1 - (top-k label multiset overlap / k) per query.  Padding slots
        (distance >= BIG/2) count on neither side; the denominator stays k,
        so lost neighbours also count as divergence.  The label counts of
        all n queries are taken at once, on the host."""
        def label_counts(out):
            d, labels = (t[:n].cpu().numpy() for t in out[:2])
            live = d < BIG / 2
            counts = np.zeros((n, self.n_classes), np.int64)
            rows = np.broadcast_to(np.arange(n)[:, None], labels.shape)
            np.add.at(counts, (rows, np.where(live, labels, 0)),
                      live.astype(np.int64))
            return counts

        overlap = np.minimum(label_counts(stage1_out),
                             label_counts(refined_out)).sum(axis=1)
        return (1.0 - overlap / self.k).tolist()


def accuracy(pred: torch.Tensor, truth: torch.Tensor) -> float:
    return float((pred == truth.to(pred.device)).float().mean())


def accuracy_loss(acc_exact: float, acc_approx: float) -> float:
    """Paper metric: decreased accuracy / exact accuracy."""
    return max(0.0, (acc_exact - acc_approx) / max(acc_exact, 1e-12))
