"""User-based CF recommendation, paper §III-D application 2, in PyTorch.

Map shards hold disjoint user rows of the rating matrix.  For a batch of
active users, a map task computes Pearson weights against its users and
emits neighbourhood contributions; the reduce combines them into

    p(u,i) = mean_u + sum_v w(u,v)(r_vi - mean_v) / sum_v |w(u,v)| m_vi .

AccurateML's aggregation stores, per LSH bucket g of users, the raw rating
sums ``sr_g``, the centred sums ``s_g`` and the rater counts ``c_g``, so a
bucket's whole contribution is rebuilt from one centroid weight
(w(u, centroid_g) s_g / |w| c_g); stage 2 replaces the top-correlated
buckets' surrogate with exact per-user terms.

The hot loops go through ``kernels.ops``: the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors.  The products that the JAX
package leaves to XLA stay ``torch.matmul`` in fp32.  A job and its map
tasks open the launch-side stage spans of ``repro_torch.obs.trace``.  The
same functions as ``src/repro/apps/cf.py``, with the same outputs and
dtypes, and its serving adapter ``CFServable``, whose aggregates come from
the aggregate store (``cf_mergeable_stats`` / ``cf_assemble``).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch

from repro_torch.core import aggregate as agg_lib
from repro_torch.core import correlation as corr_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import refine as refine_lib
from repro_torch.device import to_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.kernels.topk_stream import BIG
from repro_torch.obs.trace import current_tracer
from repro_torch.serve import servable as serve_servable
from repro_torch.serve.request import ErrorBound


def user_means(ratings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-user mean over rated items. [U,I],[U,I] -> [U,1]."""
    return ref._user_means(ratings, mask)


# Significance weighting (Herlocker-style): weights from few co-rated items
# are unreliable; shrink by co/(co + SHRINK), on every processing path.
SHRINK = 8.0


def shrink_weights(w: torch.Tensor, co_counts: torch.Tensor) -> torch.Tensor:
    return w * (co_counts / (co_counts + SHRINK))


# Error-bound calibration, as in src/repro/apps/cf.py: the claimed bound is
#     CF_BOUND_Z * mean_i( sqrt(sum_g w_g^2 SS_g[i]) / den[i] ),
# Z tuned there so that the claim covers CF_BOUND_CONFIDENCE of the
# observed rating MAEs.
CF_BOUND_Z = 3.0
CF_BOUND_CONFIDENCE = 0.9


# ---------------------------------------------------------------------------
# exact + sampled map tasks
# ---------------------------------------------------------------------------

def exact_map(ratings, mask, active, active_mask):
    """Basic map task: Pearson weights against all shard users; returns the
    shard's (num [Q,I], den [Q,I]) neighbourhood contribution."""
    w = kernel_ops.cf_weights(active, active_mask, ratings, mask)  # [Q,U]
    co = active_mask @ mask.T                                      # [Q,U]
    w = shrink_weights(w, co)
    num = w @ ref._centred(ratings, mask)
    den = w.abs() @ mask
    return num, den


def sampled_map(ratings, mask, active, active_mask, sample_idx, *,
                n_sample: int):
    """Prior art: a uniform subset of ``n_sample`` users."""
    take = sample_idx[:n_sample].long()
    return exact_map(ratings[take], mask[take], active, active_mask)


# ---------------------------------------------------------------------------
# AccurateML aggregation + two-stage map task
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CFAggregates:
    agg: agg_lib.AggregatedData   # index over users (perm/offsets/bucket_of)
    profile: torch.Tensor         # [K,I] centroid rating profile sr/c
    profile_mask: torch.Tensor    # [K,I] 1 where any bucket user rated i
    s: torch.Tensor               # [K,I] centred sums
    c: torch.Tensor               # [K,I] rater counts
    cvar: torch.Tensor            # [K,I] centred 2nd moment of ratings (SS)


def _cf_level(ratings, mask, means, ids, n_buckets: int):
    """The reference's five segment sums (sr, sr2, s, c and the user
    counts) from one stable sort of the ids and one ``cf_aggregate`` pass
    over the rating matrix in that order, and the index of that sort:
    (stats, BucketIndex).  ``means`` [U,1] are the users' mean ratings
    (``user_means``), which centre ``s``."""
    order, counts = agg_lib._bucket_order(ids, n_buckets)
    index = agg_lib.BucketIndex(perm=order.to(torch.int32),
                                offsets=agg_lib.bucket_offsets(counts),
                                bucket_of=ids.to(torch.int32))
    sr, sr2, s, c = kernel_ops.cf_aggregate(ratings, mask, means, index.perm,
                                            index.offsets)
    stats = {"counts": counts.to(torch.int32), "sr": sr, "sr2": sr2, "s": s,
             "c": c}
    return stats, index


def build_cf_aggregates(
    ratings: torch.Tensor, mask: torch.Tensor, params: lsh_lib.LSHParams
) -> CFAggregates:
    """LSH-bucket users by centred rating profile; aggregate (§III-B)."""
    tracer = current_tracer()
    with tracer.span("map.lsh"):
        means = user_means(ratings, mask)
        ids = lsh_lib.bucket_ids((ratings - means) * mask, params)
    n_buckets = params.config.n_buckets
    with tracer.span("map.aggregate", n_buckets=n_buckets):
        return cf_assemble(*_cf_level(ratings, mask, means, ids, n_buckets))


def cf_mergeable_stats(
    ratings: torch.Tensor, mask: torch.Tensor, fine_ids: torch.Tensor,
    n_buckets: int,
) -> dict[str, torch.Tensor]:
    """Additive per-bucket statistics for the aggregate store: raw rating
    sums ``sr``, squared-rating sums ``sr2`` (the second moment behind the
    error bound), centred sums ``s``, rater counts ``c`` and the int32 user
    counts, all additive under bucket union."""
    return _cf_level(ratings, mask, user_means(ratings, mask), fine_ids,
                     n_buckets)[0]


def cf_assemble(stats: dict, index: agg_lib.BucketIndex) -> CFAggregates:
    """Statistics + index -> the prepared aggregates ``accurateml_map``
    uses.  Without an ``sr2`` entry (a snapshot older than the second
    moments) the variance is the finite ``BIG``, not inf: cvar feeds a
    product where 0 x inf would be NaN."""
    c = stats["c"]
    profile = stats["sr"] / torch.clamp_min(c, 1.0)
    agg = agg_lib.AggregatedData(
        means=profile, counts=stats["counts"], perm=index.perm,
        offsets=index.offsets, bucket_of=index.bucket_of,
    )
    if "sr2" in stats:
        cvar = agg_lib.centered_second_moment(stats["sr"], stats["sr2"], c)
    else:
        cvar = torch.full(c.shape, BIG, dtype=profile.dtype,
                          device=c.device)
    return CFAggregates(
        agg=agg, profile=profile, profile_mask=(c > 0).to(profile.dtype),
        s=stats["s"], c=c, cvar=cvar,
    )


def accurateml_map(
    ratings, mask, cf_agg: CFAggregates, active, active_mask,
    *, refine_budget: int, with_bound: bool = False,
):
    """Algorithm 1 for CF.  The correlation of bucket g for active user q
    is |w(q, centroid_g)|; each active user ranks and refines its own
    buckets (per-query Alg. 1).

    With ``with_bound=True`` a third output ``varsum`` [Q,I] is returned:
    sum_g w_g^2 SS_g[i] over the buckets still answered by their surrogate.
    It is additive under the engine's psum, so the cross-shard stderr
    sqrt(varsum)/den is exact.
    """
    tracer = current_tracer()
    agg = cf_agg.agg
    with tracer.span("map.stage1"):
        live = agg.counts[None, :] > 0
        # ---- stage 1: centroid weights + surrogate contribution ----
        w_g = kernel_ops.cf_weights(
            active, active_mask, cf_agg.profile, cf_agg.profile_mask
        )                                                # [Q,K]
        co_g = active_mask @ cf_agg.profile_mask.T
        w_g = torch.where(live, shrink_weights(w_g, co_g), 0.0)
        num = w_g @ cf_agg.s                             # [Q,I]
        den = w_g.abs() @ cf_agg.c

        if refine_budget <= 0:
            if not with_bound:
                return num, den
            return num, den, w_g.square() @ cf_agg.cvar

    # ---- stage 2: per-query replacement of top buckets by exact users ----
    with tracer.span("map.select", refine_budget=refine_budget):
        rankings = corr_lib.rank_buckets_multi(w_g.abs(), agg.counts)
        idx, valid = agg_lib.refinement_indices(agg, rankings, refine_budget)
        covered = agg_lib.buckets_fully_covered(agg, rankings, refine_budget)
        covered = covered & live                         # [Q,K]

        # Exact sums must not double-count: only users of fully covered
        # buckets (per query) replace their bucket's surrogate.
        use = valid & covered.gather(1, agg.bucket_of[idx.long()].long())

    with tracer.span("map.refine"):
        _, num_delta, den_delta = kernel_ops.cf_refine(
            active, active_mask, ratings, mask, idx, use, shrink=SHRINK
        )

        # Subtract the covered buckets' surrogate, add their exact terms.
        w_g_cov = torch.where(covered, w_g, 0.0)
        num = num - w_g_cov @ cf_agg.s + num_delta
        den = den - w_g_cov.abs() @ cf_agg.c + den_delta
        if not with_bound:
            return num, den
        # Surrogate variance only over the unrefined buckets.
        w_g_unc = torch.where(covered, 0.0, w_g)
        return num, den, w_g_unc.square() @ cf_agg.cvar


# ---------------------------------------------------------------------------
# reduce + metrics
# ---------------------------------------------------------------------------

def predict(num, den, active, active_mask):
    """Reduce: combine (summed) partial sums into predictions [Q,I]."""
    base = user_means(active, active_mask)
    return torch.where(den > 1e-8, base + num / torch.clamp_min(den, 1e-8),
                       base)


def rmse(pred, truth, test_mask) -> float:
    test_mask = test_mask.to(pred.device)
    err = (pred - truth.to(pred.device)) * test_mask
    n = torch.clamp_min(test_mask.sum(), 1.0)
    return float(torch.sqrt((err * err).sum() / n))


def rmse_loss(rmse_exact: float, rmse_approx: float) -> float:
    """Paper metric: increased prediction error / exact error."""
    return max(0.0, (rmse_approx - rmse_exact) / max(rmse_exact, 1e-12))


# ---------------------------------------------------------------------------
# end-to-end jobs: shards are contiguous slices of the neighbourhood, mapped
# one after another on one device, their partial sums added, then predicted
# ---------------------------------------------------------------------------

def _shard_slices(n: int, n_shards: int) -> list[slice]:
    return [
        slice(s * n // n_shards, (s + 1) * n // n_shards)
        for s in range(n_shards)
    ]


def run_exact(
    ratings, mask, active, active_mask, *, n_shards: int = 1,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Exact CF predictions [Q,I]."""
    _, ratings, mask, active, active_mask = to_device(
        device, ratings, mask, active, active_mask)
    num = den = 0.0
    for sl in _shard_slices(ratings.shape[0], n_shards):
        n_, d_ = exact_map(ratings[sl], mask[sl], active, active_mask)
        num, den = num + n_, den + d_
    return predict(num, den, active, active_mask)


def run_accurateml(
    ratings, mask, active, active_mask, *, compression_ratio: float,
    eps_max: float,
    lsh_generator: torch.Generator | None = None,
    lsh_params: list[lsh_lib.LSHParams] | None = None,
    n_shards: int = 1, n_hashes: int = 4, bucket_width: float = 8.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """AccurateML CF predictions [Q,I].

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
    dev, ratings, mask, active, active_mask = to_device(
        device, ratings, mask, active, active_mask)
    # The shards' views and LSH draws come before the job's span.
    shards = [(ratings[sl], mask[sl])
              for sl in _shard_slices(ratings.shape[0], n_shards)]
    params = lsh_lib.shard_lsh_params(
        [r_ for r_, _ in shards], compression_ratio, n_hashes=n_hashes,
        bucket_width=bucket_width, generator=lsh_generator,
        params=lsh_params, device=dev)
    tracer = current_tracer()
    with tracer.span("job", app="cf", shards=n_shards,
                     queries=active.shape[0], eps_max=eps_max):
        num = den = 0.0
        for (r_, m_), p in zip(shards, params):
            cf_agg = build_cf_aggregates(r_, m_, p)
            budget = refine_lib.eps_to_budget(r_.shape[0], eps_max)
            n_, d_ = accurateml_map(
                r_, m_, cf_agg, active, active_mask, refine_budget=budget
            )
            with tracer.span("reduce"):
                num, den = num + n_, den + d_
        with tracer.span("reduce"):
            return predict(num, den, active, active_mask)


def run_sampled(
    ratings, mask, active, active_mask, *, sample_frac: float,
    sample_generator: torch.Generator | None = None,
    sample_perms: list[torch.Tensor] | None = None,
    n_shards: int = 1, device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Uniform-sampling CF predictions [Q,I].

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
    dev, ratings, mask, active, active_mask = to_device(
        device, ratings, mask, active, active_mask)
    num = den = 0.0
    for s, sl in enumerate(_shard_slices(ratings.shape[0], n_shards)):
        r_, m_ = ratings[sl], mask[sl]
        ns = max(1, int(sample_frac * r_.shape[0]))
        if sample_perms is None:
            perm = torch.randperm(
                r_.shape[0], generator=sample_generator,
                device=sample_generator.device,
            ).to(dev)
        else:
            perm = sample_perms[s].to(dev)
        n_, d_ = sampled_map(r_, m_, active, active_mask, perm, n_sample=ns)
        num, den = num + n_, den + d_
    return predict(num, den, active, active_mask)


# ---------------------------------------------------------------------------
# serving adapter (the Servable protocol of serve/request.py)
# ---------------------------------------------------------------------------

class CFServable(serve_servable.LSHServableBase):
    """CF recommendation behind the ``Servable`` protocol.

    One instance holds one neighbourhood shard (user rows of the rating
    matrix); the store hashes its users' centred ratings.  Request payload:
    ``(active_row [I], active_mask_row [I])`` for one active user; answer:
    the predicted rating row [I] (numpy).  ``run`` executes
    ``accurateml_map`` through the MapReduce engine with a psum combine
    into ``predict`` and the ``CF_BOUND_Z`` stderr bound.
    """

    name = "cf"

    def __init__(
        self,
        ratings,
        mask,
        *,
        lsh_generator: torch.Generator | None = None,
        lsh_params=None,
        n_hashes: int = 4,
        bucket_width: float = 8.0,
        engine: engine_lib.MapReduce | None = None,
        store=None,
        pyramid_spec=None,
        device: str | torch.device = "cuda",
    ):
        dev, ratings, mask = to_device(device, ratings, mask)
        super().__init__(
            (ratings, mask), device=dev, lsh_generator=lsh_generator,
            lsh_params=lsh_params, n_hashes=n_hashes,
            bucket_width=bucket_width, engine=engine, store=store,
            pyramid_spec=pyramid_spec,
        )
        self.ratings = ratings
        self.mask = mask

    # --- store pyramid hooks ---
    def hash_features(self) -> torch.Tensor:
        return ref._centred(self.ratings, self.mask)

    def mergeable_stats(self, fine_ids, n_buckets):
        return cf_mergeable_stats(self.ratings, self.mask, fine_ids,
                                  n_buckets)

    def assemble(self, stats, index) -> CFAggregates:
        return cf_assemble(stats, index)

    def probe_payload(self) -> tuple:
        return (self.ratings[0], self.mask[0])

    def pad_batch(self, payloads, batch: int) -> tuple:
        return self.stack_pad(payloads, batch)

    def run(
        self, prepared: CFAggregates, batch_payload: tuple,
        *, refine_budget: int,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (predictions [Q,I], bound [Q] in stars)."""
        self.check_stage2(refine_budget)
        active, active_mask = (self.batch_tensor(x) for x in batch_payload)
        map_fn = partial(
            accurateml_map, refine_budget=refine_budget, with_bound=True
        )

        def reduce_fn(nd):
            # nd = summed (num, den, varsum): the prediction and the
            # surrogate stderr are both exact across shards (all additive).
            pred = predict(nd[0], nd[1], active, active_mask)
            stderr = torch.where(
                nd[1] > 1e-8, nd[2].sqrt() / torch.clamp_min(nd[1], 1e-8),
                0.0)
            return pred, CF_BOUND_Z * stderr.mean(dim=-1)

        combine = engine_lib.CombineSpec(mode="psum", reduce_fn=reduce_fn)
        return self.engine.run(
            map_fn, combine, self.ratings, self.mask,
            replicated_args=(prepared, active, active_mask),
        )

    def unpack(self, outputs: tuple, n: int) -> list:
        return list(outputs[0][:n].cpu().numpy())

    def error_bounds(self, stage1_out, n: int) -> list:
        """Per-user claimed bound on the mean absolute rating error."""
        return [
            ErrorBound(value=float(b), metric="rating_mae",
                       confidence=CF_BOUND_CONFIDENCE)
            for b in stage1_out[1][:n].cpu().tolist()
        ]

    def accuracy_proxy(self, stage1_out, refined_out, n: int) -> list[float]:
        """Mean absolute rating delta per active user, stage-1 vs refined
        (0.0 = refinement left the predicted row unchanged), in float64 on
        the predictions' device: only the n deltas come to the host."""
        s1 = stage1_out[0][:n].double()
        s2 = refined_out[0][:n].double()
        return (s2 - s1).abs().mean(dim=-1).cpu().tolist()


# ---------------------------------------------------------------------------
# shuffle-cost model (paper Fig. 5 semantics)
# ---------------------------------------------------------------------------

def shuffle_bytes_exact(n_users: int, n_items: int, n_active: int) -> int:
    """Basic job: map emits each neighbour's (weight, centred row, mask
    row)."""
    return 4 * (n_active * n_users + 2 * n_users * n_items)


def shuffle_bytes_accurateml(
    n_users: int, n_items: int, n_active: int,
    compression_ratio: float, eps_max: float,
) -> int:
    """AccurateML job: neighbours = K centroids + refined originals."""
    k = int(round(n_users / compression_ratio))
    n_neigh = k + math.ceil(eps_max * n_users)
    return 4 * (n_active * n_neigh + 2 * n_neigh * n_items)
