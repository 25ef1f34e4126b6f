"""Wrapper of the CUDA kernel ``csrc/candidate_topk.cu``.

Seeded streaming k-best over precomputed [Q, M] candidates, or over a
[P, Q, M] stack of them read in place as the concatenation of its parts in
order (the shard reduce's folds in one launch); replaces
``src/repro/kernels/topk_stream.py:candidate_topk_pallas``.  The plain
version is ``ref.candidate_topk``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_stream import MAX_K

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
_MAX_COLS = 2**31 - 1 - MAX_K   # columns are int32, the seed's first


def candidate_topk_cuda(
    dists: torch.Tensor, labels: torch.Tensor,
    init_d: torch.Tensor | None = None, init_l: torch.Tensor | None = None,
    *, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[Q,M] (or [P,Q,M]) fp32 distances and int32 labels, optional [Q,k]
    seed -> ([Q,k] fp32, [Q,k] int32).  Unseeded slots start as (BIG,
    label 0)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= {MAX_K}")
    dev = dists.device
    if dev.type != "cuda":
        raise ValueError(f"dists: on {dev}, the kernel needs a CUDA tensor")
    shape = tuple(dists.shape) if dists.dim() in (2, 3) else (None, None)
    _build.expect(dists, "dists", torch.float32, shape, dev)
    _build.expect(labels, "labels", torch.int32, shape, dev)
    parts = shape[0] if len(shape) == 3 else 1
    q, m = shape[-2:]
    if parts * m > _MAX_COLS:
        raise ValueError(f"{parts} x {m} candidates a row: the kernel takes "
                         f"at most {_MAX_COLS}")
    if (init_d is None) != (init_l is None):
        raise ValueError("init_d and init_l go together")
    if init_d is not None:
        _build.expect(init_d, "init_d", torch.float32, (q, k), dev)
        _build.expect(init_l, "init_l", torch.int32, (q, k), dev)
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_l
    fn = _build.entry("candidate_topk", "candidate_topk_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(dists.data_ptr(), labels.data_ptr(), _build.ptr(init_d),
                 _build.ptr(init_l), parts, q, m, k, out_d.data_ptr(),
                 out_l.data_ptr(), _build.stream_of(dists))
    _build.check("candidate_topk", err)
    candidate_topk_cuda.launches += 1
    return out_d, out_l


candidate_topk_cuda.launches = 0
