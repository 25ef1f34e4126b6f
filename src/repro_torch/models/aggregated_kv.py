"""Aggregated-KV attention: AccurateML's two-stage algorithm on the KV cache,
as ``src/repro/models/aggregated_kv.py`` computes it.

The KV cache is LSH-bucketed as the paper buckets map-task input; each
bucket holds a running (mean_k, mean_v, count).  Decode:

  stage 1  q . mean_k over all K buckets: the count-weighted centroid
           attention and the correlation of Definition 4 that ranks them,
  stage 2  the top ``refine_frac`` buckets are re-attended exactly over
           their own tokens; the rest contribute their centroids with a
           log(count) logit bias, so no token's information is dropped.

Two layouts: the flat cache keeps tokens in insertion order (stage 2 masks
the whole cache: ``ops.aggregated_attention_decode``, one launch for the
batch); the bucket-major cache keeps C slots per bucket (stage 2 reads only
the selected buckets: ``ops.agg_refine_attention``).

The caches are dataclasses of tensors, and ``insert`` /
``insert_bucket_major`` update them in place (one row written per sequence
instead of a copy of every per-layer tensor per token, as a functional
update would make); they return the cache they were given.  ``prefill``
builds a new cache.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.signature import wrapped_signature
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.kernels.ref import NEG
from repro_torch.kernels.topk_stream import BIG

LSH_WIDTH = 4.0


def refine_count(refine_frac: float, n_buckets: int) -> int:
    """Buckets to re-attend exactly: ceil(refine_frac * K), clamped to
    [0, K].  ``refine_frac=0`` is pure stage-1 centroid attention; the
    inner ``round`` guards float rounding when refine_frac is budget / K."""
    return max(0, min(n_buckets, int(math.ceil(round(
        refine_frac * n_buckets, 9)))))


def select_buckets(
    qg: torch.Tensor, mean_k: torch.Tensor, counts: torch.Tensor, *,
    n_refine: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 bucket selection: the ``n_refine`` most correlated non-empty
    buckets of each sequence, through ``ops.distance_topk`` in dot mode.

    qg [B,Hkv,G,dk]; mean_k [B,K,Hkv,dk]; counts [B,K].  The pooled query
    sums over the group heads, so a bucket's score is its total centroid
    logit mass sum_{hkv,g} q . mean_k.  One batched call for the B
    sequences (the JAX package vmaps one call per sequence); ties go to the
    lowest index.  Returns (top_idx [B,R] int32, use [B,R] bool); ``use`` is
    False on padding slots (fewer than R non-empty buckets), whose index is
    not to be trusted.
    """
    b, hkv, _, dk = qg.shape
    kb = mean_k.shape[1]
    q_pool = qg.float().sum(dim=2).reshape(b, 1, hkv * dk)
    cents = mean_k.float().reshape(b, kb, hkv * dk)
    labels = torch.arange(kb, dtype=torch.int32, device=qg.device)
    scores, idx = kernel_ops.distance_topk(q_pool, cents, labels, counts > 0,
                                           k=n_refine, metric="dot")
    return idx[:, 0], scores[:, 0] < BIG / 2


def _bucket_mask(top_idx: torch.Tensor, use: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """[B,K] bool: the buckets some used selection slot names (padding slots
    never un-refine a bucket another slot selected).  No wait for the
    card."""
    b = top_idx.shape[0]
    target = torch.where(use, top_idx.long(), n_buckets)
    mask = torch.zeros((b, n_buckets + 1), dtype=torch.bool,
                       device=top_idx.device)
    mask.scatter_(1, target, True)
    return mask[:, :n_buckets]


# ---------------------------------------------------------------------------
# LSH bucketing of keys
# ---------------------------------------------------------------------------

def _hash_ids(flat: torch.Tensor, lsh_a: torch.Tensor, lsh_b: torch.Tensor,
              n_buckets: int) -> torch.Tensor:
    """[..., Hkv*dk] keys -> [...] int32 bucket ids: floor((x a + b) / w)
    per hash, combined by the uint32 signature and taken mod K."""
    h = torch.floor((flat.float() @ lsh_a + lsh_b) / LSH_WIDTH)
    sig = wrapped_signature(h.to(torch.int32))
    return (sig % n_buckets).to(torch.int32)


def draw_lsh(generator: torch.Generator, *, n_kv: int, dk: int,
             n_hashes: int = 4,
             device: torch.device | None = None) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """One layer's LSH draws: a [Hkv*dk, n_hashes] standard-normal
    projection and [n_hashes] offsets uniform in [0, LSH_WIDTH)."""
    a = torch.randn((n_kv * dk, n_hashes), generator=generator, device=device)
    b = torch.rand((n_hashes,), generator=generator,
                   device=device) * LSH_WIDTH
    return a, b


# ---------------------------------------------------------------------------
# flat cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AggKVCache:
    """Per-layer aggregated KV cache (one attention layer, full batch)."""

    k: torch.Tensor           # [B, S, Hkv, dk]
    v: torch.Tensor           # [B, S, Hkv, dv]
    bucket_of: torch.Tensor   # [B, S] int32
    mean_k: torch.Tensor      # [B, K, Hkv, dk] f32
    mean_v: torch.Tensor      # [B, K, Hkv, dv] f32
    counts: torch.Tensor      # [B, K] int32
    lsh_a: torch.Tensor       # [Hkv*dk, n_hashes] f32 (per layer)
    lsh_b: torch.Tensor       # [n_hashes] f32

    @property
    def n_buckets(self) -> int:
        return self.mean_k.shape[1]


def init_cache(
    lsh: tuple[torch.Tensor, torch.Tensor], *, batch: int, s_max: int,
    n_kv: int, dk: int, dv: int | None = None, compression: int,
    dtype: torch.dtype = torch.bfloat16,
) -> AggKVCache:
    """An empty flat cache with the LSH draws ``lsh`` = (a, b)."""
    dv = dk if dv is None else dv
    n_buckets = max(1, s_max // compression)
    a, b = lsh
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    return AggKVCache(
        k=torch.zeros((batch, s_max, n_kv, dk), dtype=dtype, device=dev),
        v=torch.zeros((batch, s_max, n_kv, dv), dtype=dtype, device=dev),
        bucket_of=torch.zeros((batch, s_max), dtype=torch.int32, device=dev),
        mean_k=torch.zeros((batch, n_buckets, n_kv, dk), **f32),
        mean_v=torch.zeros((batch, n_buckets, n_kv, dv), **f32),
        counts=torch.zeros((batch, n_buckets), dtype=torch.int32, device=dev),
        lsh_a=a, lsh_b=b,
    )


def _bucket_id(cache, k_new: torch.Tensor) -> torch.Tensor:
    """LSH bucket of new keys.  k_new [B, Hkv, dk] -> [B] int32."""
    return _hash_ids(k_new.reshape(k_new.shape[0], -1), cache.lsh_a,
                     cache.lsh_b, cache.n_buckets)


def _running_mean(mean: torch.Tensor, rows: torch.Tensor, bidx: torch.Tensor,
                  x: torch.Tensor, n: torch.Tensor) -> None:
    """mean[rows, bidx] += (x - mean[rows, bidx]) / n, in place."""
    old = mean[rows, bidx]
    mean[rows, bidx] = old + (x.float() - old) / n[:, None, None]


def insert(cache: AggKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
           pos: torch.Tensor) -> AggKVCache:
    """Insert one token per sequence in place: the running-mean bucket
    update (Eq. 2).  k_new [B,Hkv,dk]; v_new [B,Hkv,dv]; pos [B]."""
    bidx = _bucket_id(cache, k_new).long()
    rows = torch.arange(cache.k.shape[0], device=k_new.device)
    p = pos.long()
    cache.k[rows, p] = k_new.to(cache.k.dtype)
    cache.v[rows, p] = v_new.to(cache.v.dtype)
    cache.bucket_of[rows, p] = bidx.to(torch.int32)
    new_cnt = cache.counts[rows, bidx].float() + 1.0
    _running_mean(cache.mean_k, rows, bidx, k_new, new_cnt)
    _running_mean(cache.mean_v, rows, bidx, v_new, new_cnt)
    cache.counts[rows, bidx] = new_cnt.to(torch.int32)
    return cache


def prefill(cache: AggKVCache, ks: torch.Tensor,
            vs: torch.Tensor) -> AggKVCache:
    """Bulk-build the aggregated cache from a prefilled K/V block (a new
    cache; ``cache`` gives the sizes and the LSH draws).

    ks [B,S,Hkv,dk]; vs [B,S,Hkv,dv]: bucket every position, then the
    segment means per (sequence, bucket)."""
    bsz, s = ks.shape[:2]
    kb = cache.n_buckets
    bidx = _hash_ids(ks.reshape(bsz, s, -1), cache.lsh_a, cache.lsh_b, kb)
    mk, mv, cnt = [], [], []
    for i in range(bsz):
        m_k, c = kernel_ref.segment_mean(ks[i], bidx[i], kb)
        m_v, _ = kernel_ref.segment_mean(vs[i], bidx[i], kb)
        mk.append(m_k)
        mv.append(m_v)
        cnt.append(c)
    k_full = cache.k.clone()
    v_full = cache.v.clone()
    bucket_of = cache.bucket_of.clone()
    k_full[:, :s] = ks.to(k_full.dtype)
    v_full[:, :s] = vs.to(v_full.dtype)
    bucket_of[:, :s] = bidx
    return AggKVCache(
        k=k_full, v=v_full, bucket_of=bucket_of, mean_k=torch.stack(mk),
        mean_v=torch.stack(mv), counts=torch.stack(cnt),
        lsh_a=cache.lsh_a, lsh_b=cache.lsh_b,
    )


def decode_attend(q: torch.Tensor, cache: AggKVCache, pos: torch.Tensor, *,
                  refine_frac: float, scale: float) -> torch.Tensor:
    """Two-stage aggregated attention for one decode step over a flat cache.

    q [B,H,dk]; pos [B] current positions (valid_len = pos + 1).  Returns
    [B,H,dv] f32.  ``refine_frac=0`` is pure stage 1: every bucket
    contributes its count-weighted centroid.
    """
    n_refine = refine_count(refine_frac, cache.n_buckets)
    b, hq, dk = q.shape
    hkv = cache.mean_k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dk)
    if n_refine > 0:
        top_idx, use = select_buckets(qg, cache.mean_k, cache.counts,
                                      n_refine=n_refine)
        refined = _bucket_mask(top_idx, use, cache.n_buckets)
        refined = refined & (cache.counts > 0)
    else:
        refined = torch.zeros((b, cache.n_buckets), dtype=torch.bool,
                              device=q.device)
    return kernel_ops.aggregated_attention_decode(
        q.float().contiguous(), cache.k, cache.v, cache.bucket_of,
        cache.mean_k, cache.mean_v, cache.counts, refined, scale=scale,
        valid_len=(pos + 1).to(torch.int32))


# ---------------------------------------------------------------------------
# bucket-major cache
#
# The flat cache keeps tokens in insertion order, so stage 2 must read every
# token and mask: O(S) bytes a step.  The bucket-major layout keeps C slots
# per bucket ([K, C, Hkv, d]) and writes each token into its own bucket's
# next slot; stage 2 then reads only the refined buckets: O(K + eps S).  A
# token past a bucket's capacity has no slot: it still updates the bucket's
# centroid and a separate running overflow centroid, so a refined bucket
# contributes its exact slots plus the count-weighted overflow aggregate.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BucketMajorKVCache:
    """Per-layer aggregated KV cache in bucket-major layout."""

    k: torch.Tensor           # [B, K, C, Hkv, dk]
    v: torch.Tensor           # [B, K, C, Hkv, dv]
    mean_k: torch.Tensor      # [B, K, Hkv, dk] mean over all bucket tokens
    mean_v: torch.Tensor      # [B, K, Hkv, dv]
    over_k: torch.Tensor      # [B, K, Hkv, dk] mean over overflow tokens
    over_v: torch.Tensor      # [B, K, Hkv, dv]
    counts: torch.Tensor      # [B, K] int32 (total inserts, incl. overflow)
    lsh_a: torch.Tensor
    lsh_b: torch.Tensor

    @property
    def n_buckets(self) -> int:
        return self.mean_k.shape[1]

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


AGG_CACHES = (AggKVCache, BucketMajorKVCache)


def init_bucket_major(
    lsh: tuple[torch.Tensor, torch.Tensor], *, batch: int, s_max: int,
    n_kv: int, dk: int, dv: int | None = None, compression: int,
    dtype: torch.dtype = torch.bfloat16, slack: int = 2,
) -> BucketMajorKVCache:
    """An empty bucket-major cache: K = s_max // compression buckets of
    ``compression * slack`` slots each."""
    dv = dk if dv is None else dv
    n_buckets = max(1, s_max // compression)
    cap = compression * slack
    a, b = lsh
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    return BucketMajorKVCache(
        k=torch.zeros((batch, n_buckets, cap, n_kv, dk), dtype=dtype,
                      device=dev),
        v=torch.zeros((batch, n_buckets, cap, n_kv, dv), dtype=dtype,
                      device=dev),
        mean_k=torch.zeros((batch, n_buckets, n_kv, dk), **f32),
        mean_v=torch.zeros((batch, n_buckets, n_kv, dv), **f32),
        over_k=torch.zeros((batch, n_buckets, n_kv, dk), **f32),
        over_v=torch.zeros((batch, n_buckets, n_kv, dv), **f32),
        counts=torch.zeros((batch, n_buckets), dtype=torch.int32, device=dev),
        lsh_a=a, lsh_b=b,
    )


def insert_bucket_major(cache: BucketMajorKVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> BucketMajorKVCache:
    """Insert one token per sequence in place.  k_new [B,Hkv,dk]."""
    bidx = _bucket_id(cache, k_new).long()
    rows = torch.arange(cache.k.shape[0], device=k_new.device)
    cnt = cache.counts[rows, bidx]                              # [B]
    in_cap = (cnt < cache.capacity)[:, None, None]
    slot = torch.clamp_max(cnt, cache.capacity - 1).long()
    cache.k[rows, bidx, slot] = torch.where(
        in_cap, k_new.to(cache.k.dtype), cache.k[rows, bidx, slot])
    cache.v[rows, bidx, slot] = torch.where(
        in_cap, v_new.to(cache.v.dtype), cache.v[rows, bidx, slot])
    newc = cnt.float() + 1.0
    _running_mean(cache.mean_k, rows, bidx, k_new, newc)
    _running_mean(cache.mean_v, rows, bidx, v_new, newc)
    # overflow centroid: running mean over the tokens beyond capacity
    over_cnt = torch.clamp_min(cnt.float() - (cache.capacity - 1), 1.0)
    for over, x in ((cache.over_k, k_new), (cache.over_v, v_new)):
        old = over[rows, bidx]
        upd = old + (x.float() - old) / over_cnt[:, None, None]
        over[rows, bidx] = torch.where(in_cap, old, upd)
    cache.counts[rows, bidx] = newc.to(torch.int32)
    return cache


def _softmax_partial(logits: torch.Tensor, values: torch.Tensor,
                     spec: str) -> tuple[torch.Tensor, ...]:
    """(m, l, acc) of NEG-masked logits [..., N] against values."""
    m = logits.amax(dim=-1)
    w = torch.where(logits > NEG / 2, torch.exp(logits - m[..., None]), 0.0)
    return m, w.sum(dim=-1), torch.einsum(spec, w, values)


def decode_attend_bucket_major(q: torch.Tensor, cache: BucketMajorKVCache, *,
                               refine_frac: float,
                               scale: float) -> torch.Tensor:
    """Two-stage attention reading only centroids and refined buckets.

    q [B,H,dk] -> [B,H,dv] f32.  The refined buckets' live slots go
    through ``ops.agg_refine_attention``; the selected buckets' overflow
    centroids and the unrefined buckets' count-weighted centroids each form
    their own partial triple, and the triples merge by
    ``ref.merge_partials``.  Masks use the finite NEG, so empty buckets,
    padding slots and the all-empty cache give weight 0, never a NaN.
    ``refine_frac=0`` is pure stage 1.
    """
    n_refine = refine_count(refine_frac, cache.n_buckets)
    cap = cache.capacity
    b, hq, dk = q.shape
    hkv = cache.mean_k.shape[2]
    group = hq // hkv
    kb = cache.n_buckets
    qg = q.reshape(b, hkv, group, dk).float().contiguous()
    cnt = cache.counts
    dv = cache.v.shape[-1]

    if n_refine > 0:
        top_idx, use = select_buckets(qg, cache.mean_k, cnt,
                                      n_refine=n_refine)
        m_r, l_r, acc_r = kernel_ops.agg_refine_attention(
            qg, cache.k, cache.v, cnt, top_idx, use, scale=scale)
        # overflow centroids of the selected buckets: count-weighted,
        # NEG-masked where a bucket has none
        sel = top_idx.long()
        cnt_sel = cnt.gather(1, sel)                            # [B,R]
        over_cnt = torch.clamp_min(cnt_sel - cap, 0).float() * use.float()
        rows = torch.arange(b, device=q.device)[:, None]
        ok_sel = cache.over_k[rows, sel]                        # [B,R,Hkv,dk]
        ov_sel = cache.over_v[rows, sel]
        ov_logits = torch.einsum("bkgd,brkd->bkgr", qg, ok_sel) * scale \
            + torch.log(torch.clamp_min(over_cnt, 1.0))[:, None, None]
        ov_logits = torch.where((over_cnt > 0)[:, None, None], ov_logits, NEG)
        m_o, l_o, acc_o = _softmax_partial(ov_logits, ov_sel,
                                           "bkgr,brkd->bkgd")
        m_r, l_r, acc_r = kernel_ref.merge_partials(m_r, l_r, acc_r,
                                                    m_o, l_o, acc_o)
        refined = _bucket_mask(top_idx, use, kb)
    else:
        refined = torch.zeros((b, kb), dtype=torch.bool, device=q.device)
        m_r = torch.full((b, hkv, group), NEG, device=q.device)
        l_r = torch.zeros((b, hkv, group), device=q.device)
        acc_r = torch.zeros((b, hkv, group, dv), device=q.device)

    # stage 1: count-weighted centroids of the unrefined buckets
    cent_logits = torch.einsum("bkgd,bnkd->bkgn", qg, cache.mean_k) * scale
    cent_live = ~refined & (cnt > 0)                            # [B,K]
    bias = torch.log(torch.clamp_min(cnt.float(), 1.0))
    cent_l = torch.where(cent_live[:, None, None, :],
                         cent_logits + bias[:, None, None, :], NEG)
    m_c, l_c, acc_c = _softmax_partial(cent_l, cache.mean_v,
                                       "bkgn,bnkd->bkgd")
    _, l, acc = kernel_ref.merge_partials(m_r, l_r, acc_r, m_c, l_c, acc_c)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, hq, dv)
