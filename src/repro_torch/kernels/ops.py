"""Public entry points of the kNN, CF, LSH and decode-attention kernels,
dispatched by tensor device.

A CUDA tensor goes to the hand-written CUDA kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``.  Nothing sends a
CUDA tensor to ``ref``: on the card the plain versions run only when called
by name (``ref.distance_topk(...)``), to be compared with the kernels.

``KERNELS`` names each kernel's wrapper; each wrapper counts its launches
in its ``launches`` attribute (``lsh_bucket_ids``, the ``lsh_hash``
kernel's ids epilogue, counts in ``lsh_hash``'s).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.agg_refine import agg_refine_attention_cuda
from repro_torch.kernels.aggregated_attention import aggregated_attention_cuda
from repro_torch.kernels.candidate_topk import candidate_topk_cuda
from repro_torch.kernels.cf_aggregate import cf_aggregate_cuda
from repro_torch.kernels.cf_refine import cf_refine_cuda
from repro_torch.kernels.cf_weights import cf_weights_cuda
from repro_torch.kernels.distance_topk import distance_topk_cuda
from repro_torch.kernels.knn_distance import knn_distance_cuda
from repro_torch.kernels.lsh_hash import lsh_bucket_ids_cuda, lsh_hash_cuda
from repro_torch.kernels.refine_distances import refine_distances_cuda

KERNELS = {
    "distance_topk": distance_topk_cuda,
    "candidate_topk": candidate_topk_cuda,
    "knn_distance": knn_distance_cuda,
    "refine_distances": refine_distances_cuda,
    "lsh_hash": lsh_hash_cuda,
    "cf_weights": cf_weights_cuda,
    "cf_refine": cf_refine_cuda,
    "cf_aggregate": cf_aggregate_cuda,
    "agg_refine_attention": agg_refine_attention_cuda,
    "aggregated_attention_decode": aggregated_attention_cuda,
}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


def dispatch_path(t: torch.Tensor) -> str:
    """The path a call on this tensor takes: ``"cuda"`` (the kernel) or
    ``"ref"`` (the plain version)."""
    return "cuda" if _on_card(t) else "ref"


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensor on {t.device}: expected a CUDA or CPU tensor")


# ---------------------------------------------------------------------------
# observability hook
#
# When a probe is installed, every op call goes through
# ``probe.timed(op_name, fn, args, kwargs)``; the probe synchronises the card
# (torch.cuda.synchronize) around the calls it times.  With no probe the
# wrappers cost one ``is None`` test.  The op labels are the keys of
# ``KERNELS``: the JAX package's, and ``cf_aggregate``, which replaces no
# kernel of it.
# ---------------------------------------------------------------------------

_PROBE = None


def set_probe(probe) -> None:
    global _PROBE
    _PROBE = probe


def get_probe():
    return _PROBE


def _probed(op_name: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            probe = _PROBE
            if probe is None:
                return fn(*args, **kwargs)
            return probe.timed(op_name, fn, args, kwargs)
        return wrapper
    return deco


@_probed("knn_distance")
def knn_distance(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distance matrix [Q,N]."""
    if _on_card(queries):
        return knn_distance_cuda(queries, points)
    return ref.knn_distance(queries, points)


@_probed("distance_topk")
def distance_topk(
    queries: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
    valid: torch.Tensor | None = None, *, k: int, metric: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused score + streaming top-k: -> ([Q,k] scores, [Q,k] labels).

    ``metric="l2"`` scores squared-L2 distance; ``metric="dot"`` scores the
    negated dot product, so the k smallest scores are the most correlated.
    A leading batch dimension on queries and points ([B,Q,D], [B,N,D];
    labels and ``valid`` [N] or [B,N]) selects each item on its own, as
    ``jax.vmap`` of the reference does, in one call: -> ([B,Q,k], [B,Q,k]).
    """
    if _on_card(queries):
        return distance_topk_cuda(queries, points, labels, valid, k=k,
                                  metric=metric)
    return ref.distance_topk(queries, points, labels, valid, k=k,
                             metric=metric)


@_probed("candidate_topk")
def candidate_topk(
    dists: torch.Tensor, labels: torch.Tensor,
    init_d: torch.Tensor | None = None, init_l: torch.Tensor | None = None,
    *, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over precomputed [Q,M] candidates, optionally seeded
    with a previous [Q,k] running best.  A [P,Q,M] stack selects over its
    parts concatenated in order along M."""
    if _on_card(dists):
        return candidate_topk_cuda(dists, labels, init_d, init_l, k=k)
    return ref.candidate_topk(dists, labels, init_d, init_l, k=k)


@_probed("refine_distances")
def refine_distances(
    queries: torch.Tensor, train_x: torch.Tensor,
    idx: torch.Tensor, valid: torch.Tensor,
    bucket_of: torch.Tensor | None = None, *, n_buckets: int = 0,
) -> torch.Tensor:
    """Gather-free stage-2 exact distances: [Q,B] with BIG where not valid.
    ``bucket_of`` ([N] bucket of each row, in [0, n_buckets)) schedules the
    kernel, which needs it; the plain version does not read it."""
    if _on_card(queries):
        return refine_distances_cuda(queries, train_x, idx, valid, bucket_of,
                                     n_buckets=n_buckets)
    return ref.refine_distances(queries, train_x, idx, valid)


@_probed("lsh_hash")
def lsh_hash(data: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             width: float) -> torch.Tensor:
    """Fused projection + floor p-stable hash, [N,H] int32."""
    if _on_card(data):
        return lsh_hash_cuda(data, a, b, width)
    return ref.lsh_hash(data, a, b, width)


@_probed("lsh_hash")
def lsh_bucket_ids(data: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   width: float, *, base: int,
                   factor: int = 1) -> torch.Tensor:
    """The p-stable hashes combined into bucket ids ``(sig % base) //
    factor``, [N] int32: the same kernel, its ids epilogue."""
    if _on_card(data):
        return lsh_bucket_ids_cuda(data, a, b, width, base=base,
                                   factor=factor)
    return ref.lsh_bucket_ids(data, a, b, width, base=base, factor=factor)


@_probed("cf_weights")
def cf_weights(
    active: torch.Tensor, active_mask: torch.Tensor,
    users: torch.Tensor, users_mask: torch.Tensor,
) -> torch.Tensor:
    """Masked Pearson weight matrix [Q,U]."""
    if _on_card(active):
        return cf_weights_cuda(active, active_mask, users, users_mask)
    return ref.cf_weights(active, active_mask, users, users_mask)


@_probed("cf_refine")
def cf_refine(
    active: torch.Tensor, active_mask: torch.Tensor,
    ratings: torch.Tensor, mask: torch.Tensor,
    idx: torch.Tensor, use: torch.Tensor,
    *, shrink: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather-free CF refinement: (w_ref [Q,B], num_delta, den_delta)."""
    if _on_card(active):
        return cf_refine_cuda(active, active_mask, ratings, mask, idx, use,
                              shrink=shrink)
    return ref.cf_refine(active, active_mask, ratings, mask, idx, use,
                         shrink=shrink)


@_probed("cf_aggregate")
def cf_aggregate(
    ratings: torch.Tensor, mask: torch.Tensor, means: torch.Tensor,
    order: torch.Tensor, offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A CF map task's bucket statistics (sr, sr2, s, c), each [K,I]:
    per bucket of ``order`` (users in stable bucket order, ``offsets`` the
    K+1 bucket starts), the sums of r·m, (r·m)·r, (r − means)·m and m."""
    if _on_card(ratings):
        return cf_aggregate_cuda(ratings, mask, means, order, offsets)
    return ref.cf_aggregate(ratings, mask, means, order, offsets)


@_probed("agg_refine_attention")
def agg_refine_attention(
    q: torch.Tensor, k_slots: torch.Tensor, v_slots: torch.Tensor,
    counts: torch.Tensor, top_idx: torch.Tensor, use: torch.Tensor,
    *, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact re-attention over the selected buckets' live slots of a
    bucket-major cache: the partial triple (m, l, acc)."""
    if _on_card(q):
        return agg_refine_attention_cuda(q, k_slots, v_slots, counts, top_idx,
                                         use, scale=scale)
    return ref.agg_refine_attention(q, k_slots, v_slots, counts, top_idx, use,
                                    scale=scale)


@_probed("aggregated_attention_decode")
def aggregated_attention_decode(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    bucket_of: torch.Tensor, mean_k: torch.Tensor, mean_v: torch.Tensor,
    counts: torch.Tensor, refined: torch.Tensor, *, scale: float,
    valid_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """Two-stage aggregated decode attention over a flat cache, for the
    whole batch: [B,H,dk] queries -> [B,H,dv] f32.  ``valid_len`` [B] counts
    the tokens written (all S when None)."""
    if _on_card(q):
        if valid_len is None:
            valid_len = torch.full((q.shape[0],), k_cache.shape[1],
                                   dtype=torch.int32, device=q.device)
        return aggregated_attention_cuda(
            q, k_cache, v_cache, bucket_of, mean_k, mean_v, counts, refined,
            valid_len, scale=scale)
    return ref.aggregated_attention_decode(
        q, k_cache, v_cache, bucket_of, mean_k, mean_v, counts, refined,
        scale=scale, valid_len=valid_len)
