"""Plain PyTorch versions of the kNN, CF and LSH kernels.

Each function is the semantic ground truth of its CUDA kernel, written as
``src/repro/kernels/ref.py`` writes it: the expanded distance form
``max(|q|^2 - 2 q.p + |p|^2, 0)`` so that both sides round alike, a stable
ascending sort for every selection (``torch.topk`` has no tie order;
``jax.lax.top_k`` breaks ties by the lowest index, as a stable sort does),
and the CF refinement in its gathering einsum form.
``ops`` sends CPU tensors here; on the card these run only when called by
name, to be compared with the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.topk_stream import BIG


def _pad_candidates(dists: torch.Tensor, labels: torch.Tensor, k: int):
    """Pad the candidate axis to >= k with BIG and label 0, so a selection
    over fewer than k candidates returns BIG-padded slots."""
    short = k - dists.shape[-1]
    if short > 0:
        dists = F.pad(dists, (0, short), value=BIG)
        labels = F.pad(labels, (0, short), value=0)
    return dists, labels


def _smallest(dists: torch.Tensor, labels: torch.Tensor, k: int):
    """The k smallest (value, label) pairs of each row, lowest index first
    on ties."""
    dists, labels = _pad_candidates(dists, labels, k)
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    idx = idx[..., :k]
    return vals[..., :k], labels.gather(-1, idx).to(torch.int32)


def knn_distance(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix. [Q,D],[N,D] -> [Q,N] float32."""
    q = queries.float()
    p = points.float()
    q2 = (q * q).sum(dim=-1, keepdim=True)             # [Q,1]
    p2 = (p * p).sum(dim=-1, keepdim=True).T           # [1,N]
    cross = q @ p.T                                    # [Q,N]
    return torch.clamp_min(q2 - 2.0 * cross + p2, 0.0)


def candidate_topk(
    dists: torch.Tensor, labels: torch.Tensor,
    init_d: torch.Tensor | None = None, init_l: torch.Tensor | None = None,
    *, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query k smallest (distance, label) pairs from [Q, M] candidates,
    optionally seeded by a [Q, k] running best (selection over the
    concatenation [seed | candidates])."""
    if init_d is not None:
        dists = torch.cat([init_d, dists], dim=1)
        labels = torch.cat([init_l, labels], dim=1)
    return _smallest(dists.float(), labels, k)


def distance_topk(
    queries: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
    valid: torch.Tensor | None = None, *, k: int, metric: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused distance + top-k: [Q,D],[N,D],[N] -> ([Q,k], [Q,k]).

    ``metric="dot"`` scores by the negated dot product, so the k smallest
    scores are the k most correlated points.  ``valid`` masks points out
    with BIG.  A selected score >= BIG/2 is a padding slot.
    """
    if metric == "dot":
        d = -(queries.float() @ points.float().T)
    elif metric == "l2":
        d = knn_distance(queries, points)
    else:
        raise ValueError(f"metric {metric!r}: expected 'l2' or 'dot'")
    if valid is not None:
        d = torch.where(valid[None, :], d, BIG)
    lab = labels[None, :].to(torch.int32).expand(d.shape)
    return _smallest(d, lab, k)


def refine_distances(
    queries: torch.Tensor, train_x: torch.Tensor,
    idx: torch.Tensor, valid: torch.Tensor,
) -> torch.Tensor:
    """Per-query exact distances to selected originals, BIG where not valid.

    [Q,D],[N,D],[Q,B],[Q,B] -> [Q,B].  Gathers [Q,B,D]; indices are clipped
    to [0, N) as the kernel clips them.
    """
    qf = queries.float()
    rows = idx.long().clamp(0, train_x.shape[0] - 1)
    ref_x = train_x.float()[rows]                      # [Q, B, D]
    q2 = (qf * qf).sum(dim=-1)                         # [Q]
    x2 = (ref_x * ref_x).sum(dim=-1)                   # [Q, B]
    cross = torch.einsum("qd,qbd->qb", qf, ref_x)
    d = torch.clamp_min(q2[:, None] - 2.0 * cross + x2, 0.0)
    return torch.where(valid, d, BIG)


def _user_means(ratings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-user mean over rated items. [U,I],[U,I] -> [U,1]."""
    return (ratings * mask).sum(dim=1, keepdim=True) / torch.clamp_min(
        mask.sum(dim=1, keepdim=True), 1.0)


def _centred(ratings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Ratings centred on each user's mean, 0 where not rated. [U,I]."""
    return (ratings - _user_means(ratings, mask)) * mask


def cf_refine(
    active: torch.Tensor, active_mask: torch.Tensor,
    ratings: torch.Tensor, mask: torch.Tensor,
    idx: torch.Tensor, use: torch.Tensor,
    *, shrink: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CF stage-2 refinement: (w_ref [Q,B], num_delta [Q,I], den_delta
    [Q,I]).

    Shrunk Pearson weights of each query against its selected users and the
    weighted neighbourhood sums they contribute; ``use`` gates a slot to
    exactly zero.  Gathers [Q,B,I] twice; indices are clipped to [0, U) as
    the kernel clips them.
    """
    ratings, mask = ratings.float(), mask.float()
    centred_all = _centred(ratings, mask)
    rows = idx.long().clamp(0, ratings.shape[0] - 1)
    gate = use[..., None].float()
    ref_m = mask[rows] * gate                              # [Q, B, I]
    ref_c = centred_all[rows] * gate

    am = active_mask.float()
    ac = _centred(active.float(), am)                      # [Q, I]

    w_num = torch.einsum("qi,qbi->qb", ac, ref_c)
    a_sq = torch.einsum("qi,qbi->qb", ac * ac, ref_m)
    u_sq = torch.einsum("qi,qbi->qb", am, ref_c * ref_c)
    w_ref = w_num / torch.sqrt(torch.clamp_min(a_sq * u_sq, 1e-12))
    co_ref = torch.einsum("qi,qbi->qb", am, ref_m)
    w_ref = w_ref * (co_ref / (co_ref + shrink))
    w_ref = torch.where(use, w_ref, 0.0)                   # [Q, B]

    num_delta = torch.einsum("qb,qbi->qi", w_ref, ref_c)
    den_delta = torch.einsum("qb,qbi->qi", w_ref.abs(), ref_m)
    return w_ref, num_delta, den_delta


def lsh_hash(data: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             width: float) -> torch.Tensor:
    """p-stable hashes floor((data @ a + b) / w). [N,D],[D,H],[H] -> [N,H]
    int32."""
    proj = data.float() @ a.float() + b[None, :]
    return torch.floor(proj / width).to(torch.int32)


def cf_weights(
    active: torch.Tensor, active_mask: torch.Tensor,
    users: torch.Tensor, users_mask: torch.Tensor,
) -> torch.Tensor:
    """Masked Pearson weights between active users and neighbour users over
    co-rated items only. [Q,I],[Q,I],[U,I],[U,I] -> [Q,U] float32."""
    am, um = active_mask.float(), users_mask.float()
    ac = _centred(active.float(), am)                  # centred, masked
    uc = _centred(users.float(), um)
    num = ac @ uc.T                                    # [Q,U]
    a_sq = (ac * ac) @ um.T                            # sum over co-rated
    u_sq = am @ (uc * uc).T
    den = torch.sqrt(torch.clamp_min(a_sq * u_sq, 1e-12))
    return num / den
