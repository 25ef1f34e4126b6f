"""Wrapper of the CUDA kernel ``csrc/lsh_hash.cu``.

The fused p-stable hash floor((X @ A + b) / w); replaces
``src/repro/kernels/lsh_hash.py:lsh_hash_pallas``.  One launch reads each
row of X once and writes either the [N, H] hashes (``lsh_hash_cuda``, the
plain version ``ref.lsh_hash``) or the [N] bucket ids that
``core/lsh.py:bucket_ids`` combines them into (``lsh_bucket_ids_cuda``, the
plain version ``ref.lsh_bucket_ids``).  Both count their launches in
``lsh_hash_cuda.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ARGS = [_P, _P, _P, _I, _I, _I, _F, _I, _U, _U, _P, _P]
_MAX_H = 12          # csrc/lsh_hash.cu: kMaxH, the signature primes' count
_TOO_WIDE = -1       # csrc/lsh_hash.cu: kTooWide


def lsh_hash_cuda(data: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  width: float) -> torch.Tensor:
    """[N,D] fp32 data, [D,H] fp32 projections, [H] fp32 offsets -> [N,H]
    int32 hashes."""
    return _launch(data, a, b, width, base=0, factor=1)


def lsh_bucket_ids_cuda(data: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        width: float, *, base: int,
                        factor: int = 1) -> torch.Tensor:
    """[N,D] fp32 data, [D,H] fp32 projections, [H] fp32 offsets -> [N]
    int32 bucket ids ``(sig % base) // factor``, ``sig`` the hashes' uint32
    signature."""
    if not 1 <= base < 2**31 or not 1 <= factor < 2**31:
        raise ValueError(f"base {base}, factor {factor}: each must be in "
                         "[1, 2^31)")
    return _launch(data, a, b, width, base=base, factor=factor)


def _launch(data, a, b, width, *, base, factor):
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
    if dim == 0:
        raise ValueError("data has no features: nothing to project")
    ids = base > 0
    out = torch.empty((n,) if ids else (n, h), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    fn = _build.entry("lsh_hash", "lsh_hash_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(data.data_ptr(), a.data_ptr(), b.data_ptr(), n, dim, h,
                 float(width), int(ids), base, factor, out.data_ptr(),
                 _build.stream_of(data))
    if err == _TOO_WIDE:
        raise ValueError(f"{dim} features at {h} hashes: a slice of the "
                         "projections does not fit in shared memory")
    _build.check("lsh_hash", err)
    lsh_hash_cuda.launches += 1
    return out


lsh_hash_cuda.launches = 0
