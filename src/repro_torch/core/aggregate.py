"""Information aggregation of original points (AccurateML §III-B step 2).

Each LSH bucket becomes one aggregated point, the mean of its originals
(Definition 3 / Eq. 2), and the paper's "index file" becomes three device
arrays: ``perm`` sorts the originals by bucket id (stable, so each bucket's
originals stay in index order), ``offsets`` are the bucket starts in that
order (K+1), ``counts`` the points per bucket.

Segment sums are deterministic: the rows are put in ``perm`` order and each
bucket's run is summed by ``torch.segment_reduce``, never by a float
``index_add_``, whose atomics on the card add in another order on every
run.  Bucket counts are read off the sorted ids by ``searchsorted``, and
``segment_reduce`` skips its checks of the lengths (``unsafe=True``: they
come from the sort and sum to N by construction), so none of this waits
for the card.  Label histograms are integer ``bincount``s, exact in any
order.

The aggregate store's part (``BucketIndex`` and the nested levels) keeps
the index apart from the statistics: additive per-bucket statistics merge
to a coarser nested level by a reshape and a sum over consecutive fine
buckets (``merge_levels``), and the index coarsens in O(K)
(``coarsen_index``), so a coarse level built directly and one merged from a
cached finer level are the same arithmetic, to the bit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AggregatedData:
    """Aggregated data points + the index linking them to the originals."""

    means: torch.Tensor      # [K, D] bucket centroids (Eq. 2)
    counts: torch.Tensor     # [K]    points per bucket (int32)
    perm: torch.Tensor       # [N]    original index sorted by bucket id
    offsets: torch.Tensor    # [K+1]  bucket start offsets into perm
    bucket_of: torch.Tensor  # [N]    bucket id of each original point

    @property
    def n_buckets(self) -> int:
        return self.means.shape[0]

    @property
    def n_points(self) -> int:
        return self.perm.shape[0]

    def realized_compression(self) -> torch.Tensor:
        """N / (# non-empty buckets) — the paper's compression ratio."""
        nonempty = (self.counts > 0).float().sum()
        return self.perm.shape[0] / torch.clamp_min(nonempty, 1.0)


def _run_sums(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[N, ...] rows in bucket order, [K] run lengths -> [K, ...] sums."""
    return torch.segment_reduce(rows, "sum", lengths=counts, axis=0,
                                unsafe=True)


def _bucket_order(
    ids: torch.Tensor, n_buckets: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """[N] bucket ids in [0, K) -> ([N] int64 stable sort order, [K] int64
    counts), with no wait for the card."""
    sorted_ids, order = torch.sort(ids.long(), stable=True)
    bounds = torch.arange(n_buckets + 1, device=ids.device)
    return order, torch.searchsorted(sorted_ids, bounds).diff()


def bucket_offsets(counts: torch.Tensor) -> torch.Tensor:
    """[K] counts -> [K+1] int32 bucket starts in sorted order."""
    return torch.cat([
        torch.zeros(1, dtype=counts.dtype, device=counts.device),
        torch.cumsum(counts, dim=0),
    ]).to(torch.int32)


def segment_sum(
    values: torch.Tensor, ids: torch.Tensor, n_buckets: int
) -> torch.Tensor:
    """[N, ...] -> [K, ...] per-bucket sums, in the same order on every
    run: rows in stable bucket order, each run summed in index order."""
    return segment_sums((values,), ids, n_buckets)[2][0]


def _aggregate(
    data: torch.Tensor, ids: torch.Tensor, n_buckets: int
) -> tuple[AggregatedData, torch.Tensor, torch.Tensor]:
    """AggregatedData, its [K, D] per-bucket sums and the [N, D] rows in
    bucket order, from one stable sort of the ids and one gather."""
    order, counts = _bucket_order(ids, n_buckets)
    rows = data.float()[order]
    sums = _run_sums(rows, counts)
    means = sums / torch.clamp_min(counts[:, None].float(), 1.0)
    agg = AggregatedData(
        means=means.to(data.dtype),
        counts=counts.to(torch.int32),
        perm=order.to(torch.int32),
        offsets=bucket_offsets(counts),
        bucket_of=ids.to(torch.int32),
    )
    return agg, sums, rows


def aggregate_by_bucket(
    data: torch.Tensor, ids: torch.Tensor, n_buckets: int
) -> AggregatedData:
    """Build AggregatedData from per-point bucket ids."""
    return _aggregate(data, ids, n_buckets)[0]


def aggregate_with_moments(
    data: torch.Tensor, ids: torch.Tensor, n_buckets: int
) -> tuple[AggregatedData, torch.Tensor, torch.Tensor]:
    """AggregatedData plus the per-bucket sums and sums of x² ([K, D] each,
    for ``bucket_spread``): the same sort and gather serve all three."""
    agg, sums, rows = _aggregate(data, ids, n_buckets)
    return agg, sums, _run_sums(rows * rows, agg.counts)


def segment_sums(
    values: Sequence[torch.Tensor], ids: torch.Tensor, n_buckets: int
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Per-bucket sums of several [N, ...] arrays from one stable sort of
    the ids and one gather each: ([N] int64 order, [K] int64 counts, the
    [K, ...] sums of each array, in the order of ``values``)."""
    order, counts = _bucket_order(ids, n_buckets)
    return order, counts, [_run_sums(v[order], counts) for v in values]


def build_aggregates(data: torch.Tensor, params) -> AggregatedData:
    """LSH-group (``params``: an ``LSHParams``) then aggregate: the full
    §III-B generation step.  A nested config (``base_buckets`` set) sums at
    the finest level and merges down, the arithmetic of the aggregate
    store's coarsened levels."""
    # Imported here: core.lsh -> kernels.ops -> kernels.ref imports this
    # module.
    from repro_torch.core import lsh as lsh_lib

    cfg = params.config
    fine_ids = lsh_lib.fine_bucket_ids(data, params)
    if cfg.base_buckets is None or cfg.base_buckets == cfg.n_buckets:
        return aggregate_by_bucket(data, fine_ids, cfg.n_buckets)
    return aggregate_nested(data, fine_ids, cfg.base_buckets, cfg.n_buckets)


# ---------------------------------------------------------------------------
# mergeable sufficient statistics (the aggregate store's pyramid)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketIndex:
    """The paper's §III-B "index file" apart from the statistics: the
    perm/offsets linking buckets to original points, coarsened in O(K)
    while the statistics merge in O(K·D)."""

    perm: torch.Tensor       # [N]   original index sorted by fine bucket id
    offsets: torch.Tensor    # [K+1] bucket start offsets into perm
    bucket_of: torch.Tensor  # [N]   bucket id of each original point

    @property
    def n_buckets(self) -> int:
        return self.offsets.shape[0] - 1


def bucket_index(
    ids: torch.Tensor, n_buckets: int, counts: torch.Tensor | None = None
) -> BucketIndex:
    """The perm/offsets index of per-point bucket ids (int32 throughout).
    ``counts`` may be passed when the caller has them already; the sort
    that gives ``perm`` is needed either way."""
    order, sorted_counts = _bucket_order(ids, n_buckets)
    if counts is None:
        counts = sorted_counts
    return BucketIndex(perm=order.to(torch.int32),
                       offsets=bucket_offsets(counts.long()),
                       bucket_of=ids.to(torch.int32))


def merge_levels(stat: torch.Tensor, factor: int) -> torch.Tensor:
    """Merge an additive [K, ...] per-bucket statistic to the nested level
    ``factor`` times coarser: each coarse bucket sums ``factor`` consecutive
    fine ones (a reshape and a sum, no gather).  The result keeps the
    input's dtype (a sum of int32 counts would be int64)."""
    k = stat.shape[0]
    if k % factor:
        raise ValueError(f"cannot merge {k} buckets by factor {factor}")
    merged = stat.reshape((k // factor, factor) + tuple(stat.shape[1:]))
    return merged.sum(dim=1).to(stat.dtype)


def coarsen_index(index: BucketIndex, factor: int) -> BucketIndex:
    """Re-map a fine ``BucketIndex`` to a coarser nested level in O(K).
    The perm is unchanged (sorting by fine id also sorts by every coarse id
    fine // factor); the coarse offsets are every ``factor``-th fine one."""
    if index.n_buckets % factor:
        raise ValueError(
            f"cannot coarsen {index.n_buckets} buckets by factor {factor}"
        )
    return BucketIndex(
        perm=index.perm,
        offsets=index.offsets[::factor],
        bucket_of=torch.div(index.bucket_of, factor, rounding_mode="floor"),
    )


def aggregate_nested(
    data: torch.Tensor, fine_ids: torch.Tensor, base_buckets: int,
    n_buckets: int,
) -> AggregatedData:
    """Hierarchical §III-B generation: segment sums at the finest level,
    then one merge down; the same arithmetic as the store's coarsened
    levels."""
    order, counts_f = _bucket_order(fine_ids, base_buckets)
    sums_f = _run_sums(data.float()[order], counts_f)
    factor = base_buckets // n_buckets
    counts = merge_levels(counts_f.to(torch.int32), factor)
    sums = merge_levels(sums_f, factor)
    means = sums / torch.clamp_min(counts[:, None].float(), 1.0)
    index = coarsen_index(
        BucketIndex(perm=order.to(torch.int32),
                    offsets=bucket_offsets(counts_f),
                    bucket_of=fine_ids.to(torch.int32)),
        factor)
    return AggregatedData(
        means=means.to(data.dtype), counts=counts, perm=index.perm,
        offsets=index.offsets, bucket_of=index.bucket_of,
    )


# ---------------------------------------------------------------------------
# second-moment statistics (error bounds).  An empty bucket has unknown
# content: its spread and dispersion are +inf, never 0 or NaN.
# ---------------------------------------------------------------------------

def bucket_sumsq(
    data: torch.Tensor, ids: torch.Tensor, n_buckets: int
) -> torch.Tensor:
    """[N,D] -> [K,D] per-bucket sum of x² per feature (additive)."""
    x = data.float()
    return segment_sum(x * x, ids, n_buckets)


def bucket_spread(
    sums: torch.Tensor, sumsq: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """[K,D] sums, [K,D] sumsq, [K] counts -> [K] within-bucket spread
    E‖x − μ‖² (the trace of the bucket covariance); +inf if empty."""
    n = torch.clamp_min(counts.float(), 1.0)[:, None]
    mean = sums / n
    var = torch.clamp_min(sumsq / n - mean * mean, 0.0)
    spread = var.sum(dim=-1)
    return torch.where(counts > 0, spread, torch.inf)


def centered_second_moment(
    s: torch.Tensor, s2: torch.Tensor, c: torch.Tensor
) -> torch.Tensor:
    """Elementwise sum of (x - mean)^2 = s2 - s^2 / c, clipped to >= 0, from
    parallel additive statistics (sum, sum of squares, count).  Cells with
    c == 0 carry no mass and give 0."""
    n = torch.clamp_min(c, 1.0)
    return torch.clamp_min(s2 - (s * s) / n, 0.0)


def histogram_dispersion(hist: torch.Tensor) -> torch.Tensor:
    """[K,C] label histogram -> [K] 1 − majority fraction; +inf if empty."""
    total = hist.sum(dim=-1)
    top = hist.max(dim=-1).values
    disp = 1.0 - top / torch.clamp_min(total, 1.0)
    return torch.where(total > 0, disp, torch.inf)


# ---------------------------------------------------------------------------
# refinement selection, batched over queries: ``ranking`` is [K] or [Q, K]
# ---------------------------------------------------------------------------

def _ranked(ranking: torch.Tensor) -> torch.Tensor:
    r = ranking.long()
    return r[None] if r.dim() == 1 else r


def refinement_indices(
    agg: AggregatedData, ranking: torch.Tensor, budget: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape selection of the originals to refine (Alg. 1 l.5-10).

    Walks buckets in ``ranking`` order and takes originals until ``budget``
    points are selected, for each ranking row.  Returns ``idx`` ([..., B]
    int32 indices into the originals, 0 on padding) and ``valid`` ([..., B]
    bool, False on padding).
    """
    r = _ranked(ranking)
    counts_ranked = agg.counts.long()[r]                     # [Q, K]
    starts_ranked = agg.offsets.long()[r]                    # [Q, K]
    cum = torch.cumsum(counts_ranked, dim=-1)
    bucket_base = cum - counts_ranked                        # exclusive
    pos = torch.arange(budget, device=r.device).expand(r.shape[0], budget)
    # Which ranked bucket does each output slot fall in?
    slot = torch.searchsorted(cum, pos.contiguous(), right=True)
    slot = torch.clamp_max(slot, agg.n_buckets - 1)
    within = pos - bucket_base.gather(-1, slot)
    sorted_pos = starts_ranked.gather(-1, slot) + within
    valid = pos < cum[:, -1:]
    sorted_pos = torch.where(valid, sorted_pos, 0)
    idx = agg.perm[sorted_pos]
    if ranking.dim() == 1:
        return idx[0], valid[0]
    return idx, valid


def refined_bucket_mask(
    agg: AggregatedData, ranking: torch.Tensor,
    n_refined: torch.Tensor | int,
) -> torch.Tensor:
    """[K] bool: True for the buckets among the first ``n_refined`` of
    ``ranking`` (a permutation of the buckets)."""
    rank_pos = torch.argsort(ranking.long(), stable=True)  # bucket -> rank
    return rank_pos < n_refined


def buckets_fully_covered(
    agg: AggregatedData, ranking: torch.Tensor, budget: int
) -> torch.Tensor:
    """[..., K] bool — buckets whose every original fits inside ``budget``.
    Only fully covered buckets replace their aggregate in stage 2."""
    r = _ranked(ranking)
    cum = torch.cumsum(agg.counts.long()[r], dim=-1)
    covered_ranked = cum <= budget
    covered = torch.empty_like(covered_ranked)
    covered.scatter_(-1, r, covered_ranked)                  # rank -> bucket
    return covered[0] if ranking.dim() == 1 else covered
