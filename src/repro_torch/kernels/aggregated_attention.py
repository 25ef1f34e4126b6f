"""Wrapper of the CUDA kernel ``csrc/aggregated_attention.cu``.

Two-stage aggregated decode attention over a flat KV cache, for a whole
decode batch in one launch (a thread-block cluster per (sequence, KV head,
head tile, value tile), the written tokens split among its warps on the
card, the partials merged on the chip; the launch geometry is
``decode_geometry``); replaces
``src/repro/kernels/aggregated_attention.py:aggregated_attention_pallas``
(its two ``masked_decode_attention`` passes and ``merge_partials``), which
the JAX package vmaps over the batch.  The plain version is
``ref.aggregated_attention_decode``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, decode_geometry
from repro_torch.kernels.agg_refine import (
    check_aligned, check_buckets, check_heads,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 9 + [_I] * 10 + [_F] + [_P] * 2


def aggregated_attention_cuda(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    bucket_of: torch.Tensor, mean_k: torch.Tensor, mean_v: torch.Tensor,
    counts: torch.Tensor, refined: torch.Tensor, valid_len: torch.Tensor,
    *, scale: float,
) -> torch.Tensor:
    """q [B,H,dk] f32; k_cache/v_cache [B,S,Hkv,dk|dv] bf16 or f32;
    bucket_of [B,S] int32; mean_k/mean_v [B,K,Hkv,dk|dv] f32; counts [B,K]
    int32; refined [B,K] bool; valid_len [B] int32 -> [B,H,dv] f32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(q, "q", torch.float32, (None,) * 3, dev)
    b, hq, dk = q.shape
    dtype = k_cache.dtype if isinstance(k_cache, torch.Tensor) else None
    _build.expect(k_cache, "k_cache", dtype, (b, None, None, dk), dev)
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    _build.expect(v_cache, "v_cache", dtype, (b, s, hkv, None), dev)
    dv = v_cache.shape[-1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} KV heads")
    g = hq // hkv
    check_heads(hkv, g, dk, dv, dtype)
    _build.expect(bucket_of, "bucket_of", torch.int32, (b, s), dev)
    _build.expect(mean_k, "mean_k", torch.float32, (b, None, hkv, dk), dev)
    kb = mean_k.shape[1]
    check_buckets(kb)
    _build.expect(mean_v, "mean_v", torch.float32, (b, kb, hkv, dv), dev)
    _build.expect(counts, "counts", torch.int32, (b, kb), dev)
    _build.expect(refined, "refined", torch.bool, (b, kb), dev)
    _build.expect(valid_len, "valid_len", torch.int32, (b,), dev)
    check_aligned(q=q, k_cache=k_cache, v_cache=v_cache, mean_k=mean_k,
                  mean_v=mean_v)
    out = torch.empty((b, hq, dv), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    tok_rows, cen_rows = decode_geometry.flat_rows(s, kb, dk, dv,
                                                   k_cache.element_size())
    fn = _build.entry("aggregated_attention", "aggregated_attention", _ARGS)
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 bucket_of.data_ptr(), mean_k.data_ptr(), mean_v.data_ptr(),
                 counts.data_ptr(), refined.data_ptr(), valid_len.data_ptr(),
                 int(dtype == torch.bfloat16), b, s, kb, hkv, g, dk, dv,
                 tok_rows, cen_rows, float(scale), out.data_ptr(),
                 _build.stream_of(q))
    _build.check("aggregated_attention", err)
    aggregated_attention_cuda.launches += 1
    return out


aggregated_attention_cuda.launches = 0
