"""Wrapper of the CUDA kernel ``csrc/lsh_hash.cu``.

The fused p-stable hash floor((X @ A + b) / w); replaces
``src/repro/kernels/lsh_hash.py:lsh_hash_pallas``.  The plain version is
``ref.lsh_hash``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _I, _I, _I, _F, _P, _P]
_MAX_H = 8          # csrc/lsh_hash.cu: kMaxH


def lsh_hash_cuda(data: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  width: float) -> torch.Tensor:
    """[N,D] fp32 data, [D,H] fp32 projections, [H] fp32 offsets -> [N,H]
    int32 hashes."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"data: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(data, "data", torch.float32, (None, None), dev)
    n, dim = data.shape
    _build.expect(a, "a", torch.float32, (dim, None), dev)
    h = a.shape[1]
    _build.expect(b, "b", torch.float32, (h,), dev)
    if not 1 <= h <= _MAX_H:
        raise ValueError(f"{h} hashes: the kernel takes 1 to {_MAX_H}")
    out = torch.empty((n, h), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    fn = _build.entry("lsh_hash", "lsh_hash_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(data.data_ptr(), a.data_ptr(), b.data_ptr(), n, dim, h,
                 float(width), out.data_ptr(), _build.stream_of(data))
    _build.check("lsh_hash", err)
    lsh_hash_cuda.launches += 1
    return out


lsh_hash_cuda.launches = 0
