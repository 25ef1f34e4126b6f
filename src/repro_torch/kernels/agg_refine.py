"""Wrapper of the CUDA kernel ``csrc/agg_refine.cu``.

Exact re-attention over the selected buckets of a bucket-major KV cache, as
a partial-softmax triple, in one launch (a thread-block cluster per
(sequence, KV head, head tile, value tile), the partials merged on the chip;
the launch geometry is ``decode_geometry``); replaces
``src/repro/kernels/agg_refine.py:agg_refine_attention_pallas``.  The plain
version is ``ref.agg_refine_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, decode_geometry

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 6 + [_I] * 10 + [_F] + [_P] * 4
MAX_DK = 1024     # a head tile's f32 queries (8 x 1024) take 32 KB of
                  # shared memory, and a centroid row 4 KB of a chunk's
MAX_BUCKETS = 8192   # a sequence's bucket counts sit in shared memory
MAX_GRID_Y = 65535   # (KV head, head tile, value tile) rows of the grid
CACHE_DTYPES = (torch.bfloat16, torch.float32)


def check_heads(hkv: int, group: int, dk: int, dv: int,
                dtype: torch.dtype) -> None:
    """Raise unless the decode-attention kernels take these head shapes:
    any number of query heads a KV head and any value width (tiles of
    ``decode_geometry.HEAD_TILE`` heads and ``VALUE_TILE`` columns, one
    launch), keys up to ``MAX_DK`` wide."""
    if dtype not in CACHE_DTYPES:
        raise TypeError(f"cache dtype {dtype}: expected bfloat16 or float32")
    if group < 1:
        raise ValueError(f"{group} query heads per KV head")
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"key width {dk}: the kernel takes 1 to {MAX_DK}")
    if dv < 1:
        raise ValueError(f"value width {dv}")
    rows = decode_geometry.grid(1, hkv, group, dv)[1]
    if rows > MAX_GRID_Y:
        raise ValueError(f"{hkv} KV heads of {group} query heads and {dv} "
                         f"values make {rows} grid rows, over {MAX_GRID_Y}")
    vec = 128 // torch.finfo(dtype).bits
    if dk % vec:
        raise ValueError(f"key width {dk}: must be a multiple of {vec} for "
                         f"{dtype} (16-byte loads)")
    if dv % vec:
        raise ValueError(f"value width {dv}: must be a multiple of {vec} "
                         f"for {dtype} (16-byte loads)")


def check_buckets(kb: int) -> None:
    """Raise unless the decode-attention kernels take ``kb`` buckets."""
    if not 1 <= kb <= MAX_BUCKETS:
        raise ValueError(f"{kb} buckets: the kernel takes 1 to {MAX_BUCKETS}")


def check_aligned(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def agg_refine_attention_cuda(
    q: torch.Tensor, k_slots: torch.Tensor, v_slots: torch.Tensor,
    counts: torch.Tensor, top_idx: torch.Tensor, use: torch.Tensor,
    *, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,Hkv,G,dk] f32; k_slots/v_slots [B,K,C,Hkv,dk|dv] bf16 or f32;
    counts [B,K] int32; top_idx [B,R] int32; use [B,R] bool -> (m [B,Hkv,G],
    l [B,Hkv,G], acc [B,Hkv,G,dv]) f32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(q, "q", torch.float32, (None,) * 4, dev)
    b, hkv, g, dk = q.shape
    dtype = k_slots.dtype if isinstance(k_slots, torch.Tensor) else None
    _build.expect(k_slots, "k_slots", dtype, (b, None, None, hkv, dk), dev)
    kb, cap = k_slots.shape[1], k_slots.shape[2]
    _build.expect(v_slots, "v_slots", dtype, (b, kb, cap, hkv, None), dev)
    dv = v_slots.shape[-1]
    check_heads(hkv, g, dk, dv, dtype)
    check_buckets(kb)
    _build.expect(counts, "counts", torch.int32, (b, kb), dev)
    _build.expect(top_idx, "top_idx", torch.int32, (b, None), dev)
    r = top_idx.shape[1]
    if r == 0:
        raise ValueError("empty selection: the caller skips R == 0")
    _build.expect(use, "use", torch.bool, (b, r), dev)
    check_aligned(q=q, k_slots=k_slots, v_slots=v_slots)
    f32 = dict(dtype=torch.float32, device=dev)
    out_m = torch.empty((b, hkv, g), **f32)
    out_l = torch.empty((b, hkv, g), **f32)
    out_acc = torch.empty((b, hkv, g, dv), **f32)
    if b == 0:
        return out_m, out_l, out_acc
    fn = _build.entry("agg_refine", "agg_refine_attention", _ARGS)
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k_slots.data_ptr(), v_slots.data_ptr(),
                 counts.data_ptr(), top_idx.data_ptr(), use.data_ptr(),
                 int(dtype == torch.bfloat16), b, kb, cap, hkv, g, dk, dv, r,
                 decode_geometry.refine_rows(r, cap, dk, dv,
                                             k_slots.element_size()),
                 float(scale), out_m.data_ptr(), out_l.data_ptr(),
                 out_acc.data_ptr(), _build.stream_of(q))
    _build.check("agg_refine", err)
    agg_refine_attention_cuda.launches += 1
    return out_m, out_l, out_acc


agg_refine_attention_cuda.launches = 0
