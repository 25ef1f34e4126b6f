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
package leaves to XLA stay ``torch.matmul`` in fp32.  The same functions as
``src/repro/apps/cf.py`` (its serving adapter and store hooks come with the
store and serving slices), with the same outputs and dtypes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import aggregate as agg_lib
from repro_torch.core import correlation as corr_lib
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import refine as refine_lib
from repro_torch.device import to_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref


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


def _build_cf_aggregates(ratings, mask, centred, ids, n_buckets: int):
    """The reference's five segment sums (sr, sr2, s, c and the user
    counts) from one stable sort of the ids and one gather of each summed
    [U,I] array."""
    rated = ratings * mask
    order, counts, (sr, sr2, s, c) = agg_lib.segment_sums(
        (rated, rated * ratings, centred, mask), ids, n_buckets)
    profile = sr / torch.clamp_min(c, 1.0)
    agg = agg_lib.AggregatedData(
        means=profile, counts=counts.to(torch.int32),
        perm=order.to(torch.int32),
        offsets=agg_lib.bucket_offsets(counts),
        bucket_of=ids.to(torch.int32),
    )
    return CFAggregates(
        agg=agg, profile=profile, profile_mask=(c > 0).to(ratings.dtype),
        s=s, c=c, cvar=agg_lib.centered_second_moment(sr, sr2, c),
    )


def build_cf_aggregates(
    ratings: torch.Tensor, mask: torch.Tensor, params: lsh_lib.LSHParams
) -> CFAggregates:
    """LSH-bucket users by centred rating profile; aggregate (§III-B)."""
    centred = ref._centred(ratings, mask)
    ids = lsh_lib.bucket_ids(centred, params)
    return _build_cf_aggregates(ratings, mask, centred, ids,
                                params.config.n_buckets)


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
    agg = cf_agg.agg
    live = agg.counts[None, :] > 0
    # ---- stage 1: centroid weights + surrogate contribution ----
    w_g = kernel_ops.cf_weights(
        active, active_mask, cf_agg.profile, cf_agg.profile_mask
    )                                                    # [Q,K]
    co_g = active_mask @ cf_agg.profile_mask.T
    w_g = torch.where(live, shrink_weights(w_g, co_g), 0.0)
    num = w_g @ cf_agg.s                                 # [Q,I]
    den = w_g.abs() @ cf_agg.c

    if refine_budget <= 0:
        if not with_bound:
            return num, den
        return num, den, w_g.square() @ cf_agg.cvar

    # ---- stage 2: per-query replacement of top buckets by exact users ----
    rankings = corr_lib.rank_buckets_multi(w_g.abs(), agg.counts)
    idx, valid = agg_lib.refinement_indices(agg, rankings, refine_budget)
    covered = agg_lib.buckets_fully_covered(agg, rankings, refine_budget)
    covered = covered & live                             # [Q,K]

    # Exact sums must not double-count: only users of fully covered buckets
    # (per query) replace their bucket's surrogate.
    use = valid & covered.gather(1, agg.bucket_of[idx.long()].long())
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
    num = den = 0.0
    for s, sl in enumerate(_shard_slices(ratings.shape[0], n_shards)):
        r_, m_ = ratings[sl], mask[sl]
        cfg = lsh_lib.config_for_compression(
            r_.shape[0], compression_ratio, n_hashes=n_hashes,
            bucket_width=bucket_width,
        )
        if lsh_params is None:
            params = lsh_lib.init_lsh(lsh_generator, r_.shape[1], cfg,
                                      device=dev)
        else:
            params = lsh_params[s]
            if params.config != cfg:
                raise ValueError(
                    f"shard {s}: lsh_params config {params.config} != {cfg}"
                )
        cf_agg = build_cf_aggregates(r_, m_, params)
        budget = refine_lib.eps_to_budget(r_.shape[0], eps_max)
        n_, d_ = accurateml_map(
            r_, m_, cf_agg, active, active_mask, refine_budget=budget
        )
        num, den = num + n_, den + d_
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
