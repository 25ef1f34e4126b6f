"""Plain PyTorch versions of the kNN, CF, LSH and decode-attention kernels.

Each function is the semantic ground truth of its CUDA kernel, written as
``src/repro/kernels/ref.py`` writes it: the expanded distance form
``max(|q|^2 - 2 q.p + |p|^2, 0)`` so that both sides round alike, a stable
ascending sort for every selection (``torch.topk`` has no tie order;
``jax.lax.top_k`` breaks ties by the lowest index, as a stable sort does),
and the CF refinement in its gathering einsum form.  The decode-attention
versions mask with the finite ``NEG`` sentinel (or -inf with an
``isfinite`` mask, as the reference oracle does) and clamp every running
max at ``NEG``, so an all-masked input gives exact zeros and never a NaN.
``ops`` sends CPU tensors here; on the card these run only when called by
name, to be compared with the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.aggregate import _run_sums, segment_sums
from repro_torch.core.signature import wrapped_signature
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
    concatenation [seed | candidates]).  [P, Q, M] candidates are the
    concatenation of their parts in order: [Q, P M]."""
    if dists.dim() == 3:
        dists = dists.permute(1, 0, 2).reshape(dists.shape[1], -1)
        labels = labels.permute(1, 0, 2).reshape(labels.shape[1], -1)
    if init_d is not None:
        dists = torch.cat([init_d, dists], dim=1)
        labels = torch.cat([init_l, labels], dim=1)
    return _smallest(dists.float(), labels, k)


def distance_topk(
    queries: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
    valid: torch.Tensor | None = None, *, k: int, metric: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused distance + top-k: [Q,D],[N,D],[N] -> ([Q,k], [Q,k]).

    Batched, as ``jax.vmap`` of the reference gives it: [B,Q,D] queries,
    [B,N,D] points, labels and ``valid`` [N] (shared) or [B,N] ->
    ([B,Q,k], [B,Q,k]), each item scored by its own product, so that it
    gives the bits of a 2-D call on that item.
    ``metric="dot"`` scores by the negated dot product, so the k smallest
    scores are the k most correlated points.  ``valid`` masks points out
    with BIG.  A selected score >= BIG/2 is a padding slot.
    """
    if metric not in ("l2", "dot"):
        raise ValueError(f"metric {metric!r}: expected 'l2' or 'dot'")
    score = (knn_distance if metric == "l2"
             else lambda q, p: -(q.float() @ p.float().T))
    if queries.dim() == 2:
        d = score(queries, points)
    else:
        d = torch.stack([score(q, p) for q, p in zip(queries, points)])
    if valid is not None:
        d = torch.where(valid[..., None, :], d, BIG)
    lab = labels[..., None, :].to(torch.int32).expand(d.shape)
    return _smallest(d, lab, k)


def refine_distances(
    queries: torch.Tensor, train_x: torch.Tensor,
    idx: torch.Tensor, valid: torch.Tensor,
    bucket_of: torch.Tensor | None = None, *, n_buckets: int = 0,
) -> torch.Tensor:
    """Per-query exact distances to selected originals, BIG where not valid.

    [Q,D],[N,D],[Q,B],[Q,B] -> [Q,B].  Gathers [Q,B,D]; indices are clipped
    to [0, N) as the kernel clips them.  ``bucket_of`` and ``n_buckets``,
    the kernel's schedule key, change nothing here.
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


def cf_aggregate(
    ratings: torch.Tensor, mask: torch.Tensor, means: torch.Tensor,
    order: torch.Tensor, offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A CF map task's bucket statistics (sr, sr2, s, c), each [K,I]: the
    sums of r·m, (r·m)·r, (r − means)·m and m over each bucket's users.

    [U,I],[U,I],[U,1], ``order`` [U] (users in stable bucket order) and
    ``offsets`` [K+1] (bucket starts in that order).  The products, the
    gathers into bucket order and ``torch.segment_reduce`` over each run,
    each run summed from 0 in ``order``: the arithmetic of
    ``core/aggregate.py:segment_sums``.
    """
    rated = ratings * mask
    centred = (ratings - means) * mask
    rows = order.long()
    counts = offsets.diff().long()
    return tuple(_run_sums(v[rows], counts)
                 for v in (rated, rated * ratings, centred, mask))


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


def lsh_bucket_ids(data: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   width: float, *, base: int,
                   factor: int = 1) -> torch.Tensor:
    """Bucket ids ``(sig % base) // factor`` of the p-stable hashes, [N]
    int32, with ``sig`` their uint32 signature: ``fine_bucket_ids`` (factor
    1) and ``bucket_ids`` of ``src/repro/core/lsh.py``."""
    sig = wrapped_signature(lsh_hash(data, a, b, width))
    return (sig % base).to(torch.int32) // factor


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


# ---------------------------------------------------------------------------
# aggregated-KV decode attention
# ---------------------------------------------------------------------------

# Finite "minus infinity" of masked logits: exp(NEG - m) underflows to 0 for
# any finite m, so no merge ever computes inf - inf.
NEG = -1.0e30


def aggregated_attention_decode(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    bucket_of: torch.Tensor, mean_k: torch.Tensor, mean_v: torch.Tensor,
    counts: torch.Tensor, refined: torch.Tensor, *, scale: float,
    valid_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """Two-stage aggregated decode attention over a batch: [B, H, dv] f32.

    q [B,H,dk]; k_cache/v_cache [B,S,Hkv,dk|dv]; bucket_of [B,S]; mean_k/v
    [B,K,Hkv,dk|dv]; counts [B,K]; refined [B,K] bool; valid_len [B] (tokens
    written) or None.  Refined buckets contribute their exact tokens below
    ``valid_len``; the other non-empty buckets contribute their centroid with
    logit q.mean_k + log(count).  Query head h uses KV head h // (H // Hkv).
    """
    b, hq, dk = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, dk)
    tok_live = refined.gather(1, bucket_of.long())             # [B,S]
    if valid_len is not None:
        t = torch.arange(s, device=q.device)
        tok_live = tok_live & (t[None, :] < valid_len.reshape(b, 1))
    lt = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    lt = torch.where(tok_live[:, None, None, :], lt, -torch.inf)
    cent_live = ~refined & (counts > 0)                         # [B,K]
    lc = torch.einsum("bkgd,bnkd->bkgn", qg, mean_k.float()) * scale
    lc = torch.where(cent_live[:, None, None, :], lc, -torch.inf)
    log_mult = torch.where(
        cent_live, torch.log(torch.clamp_min(counts.float(), 1.0)), 0.0)
    lc = lc + log_mult[:, None, None, :]
    logits = torch.cat([lt, lc], dim=-1)
    # Clamped at NEG: with every bucket empty (all logits -inf) the
    # subtraction would be inf - inf; clamped, the result is exact zeros.
    m = torch.clamp_min(logits.amax(dim=-1, keepdim=True), NEG)
    w = torch.where(torch.isfinite(logits), torch.exp(logits - m), 0.0)
    denom = torch.clamp_min(w.sum(dim=-1), 1e-30)
    vals = torch.cat([v_cache.float().permute(0, 2, 1, 3),
                      mean_v.float().permute(0, 2, 1, 3)], dim=2)
    out = torch.einsum("bkgt,bktd->bkgd", w, vals) / denom[..., None]
    return out.reshape(b, hq, -1)


def masked_decode_attention(
    q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
    bias: torch.Tensor, *, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One masked decode pass, as a partial-softmax triple.

    q [Hkv,G,dk]; keys/values [Hkv,T,dk|dv]; bias [T] added to every logit
    (<= NEG/2 masks a key).  Returns (m [Hkv,G], l [Hkv,G], acc
    [Hkv,G,dv]); an all-masked pass gives (NEG, 0, 0).
    """
    logits = torch.einsum("kgd,ktd->kgt", q.float(), keys.float()) * scale
    logits = logits + bias.float()[None, None, :]
    m = torch.clamp_min(logits.amax(dim=-1), NEG)
    w = torch.where(bias[None, None, :] > NEG / 2,
                    torch.exp(logits - m[..., None]), 0.0)
    return m, w.sum(dim=-1), torch.einsum("kgt,ktd->kgd", w, values.float())


def agg_refine_attention(
    q: torch.Tensor, k_slots: torch.Tensor, v_slots: torch.Tensor,
    counts: torch.Tensor, top_idx: torch.Tensor, use: torch.Tensor,
    *, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-2 exact re-attention over the selected buckets' live slots.

    q [B,Hkv,G,dk]; k_slots/v_slots [B,K,C,Hkv,dk|dv]; counts [B,K] (total
    inserts, overflow included); top_idx/use [B,R] (use == 0 masks a
    selection slot).  Row c of a selected bucket is live where c <
    min(count, C), count > 0 and use != 0; every selection slot counts on
    its own, duplicates included.  Returns the partial-softmax triple (m
    [B,Hkv,G], l [B,Hkv,G], acc [B,Hkv,G,dv]); a fully masked selection
    gives (NEG, 0, 0).  Gathers the [B,R,C,...] slot tensor; indices are
    clipped to [0, K) as the kernel clips them.
    """
    b, hkv, g, dk = q.shape
    kb, cap = k_slots.shape[1], k_slots.shape[2]
    dv = v_slots.shape[-1]
    idx = top_idx.long().clamp(0, kb - 1)
    rows = torch.arange(b, device=q.device)[:, None]
    k_sel = k_slots[rows, idx].float()                      # [B,R,C,Hkv,dk]
    v_sel = v_slots[rows, idx].float()                      # [B,R,C,Hkv,dv]
    cnt_sel = counts.gather(1, idx)                         # [B,R]
    c = torch.arange(cap, device=q.device)
    live = ((c[None, None, :] < torch.clamp_max(cnt_sel, cap)[:, :, None])
            & (cnt_sel > 0)[:, :, None] & (use != 0)[:, :, None])  # [B,R,C]
    logits = torch.einsum("bkgd,brckd->bkgrc", q.float(), k_sel) * scale
    logits = torch.where(live[:, None, None], logits, NEG)
    flat = logits.reshape(b, hkv, g, -1)                    # [B,Hkv,G,R*C]
    m = flat.amax(dim=-1)
    w = torch.where(flat > NEG / 2, torch.exp(flat - m[..., None]), 0.0)
    vals = v_sel.permute(0, 3, 1, 2, 4).reshape(b, hkv, -1, dv)
    return m, w.sum(dim=-1), torch.einsum("bkgt,bktd->bkgd", w, vals)


def merge_partials(
    m1: torch.Tensor, l1: torch.Tensor, a1: torch.Tensor,
    m2: torch.Tensor, l2: torch.Tensor, a2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax merge of two partial triples; two empty (NEG, 0, 0)
    triples merge to (NEG, 0, 0)."""
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    return m, l1 * w1 + l2 * w2, a1 * w1[..., None] + a2 * w2[..., None]


def segment_mean(
    data: torch.Tensor, ids: torch.Tensor, n_segments: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucket means and counts: [N,D], [N] -> ([K,D] f32, [K] int32).

    The sums come from one stable sort of the ids, so they are the same bits
    on every run (``index_add_`` on the card adds in no fixed order)."""
    flat = data.float().reshape(data.shape[0], -1)
    _, counts, (sums,) = segment_sums([flat], ids, n_segments)
    mean = sums / torch.clamp_min(counts.float(), 1.0)[:, None]
    return (mean.reshape((n_segments,) + tuple(data.shape[1:])),
            counts.to(torch.int32))
