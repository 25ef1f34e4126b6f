"""Wrapper of the CUDA kernel ``csrc/knn_distance.cu``.

The [Q, N] squared-L2 matrix; replaces
``src/repro/kernels/knn_distance.py:knn_distance_pallas``.  The plain
version is ``ref.knn_distance``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _I, _I, _I, _P, _P]
_BM = 128            # queries per block tile (fp32_tile.cuh)
_MAX_Q = 65535 * _BM  # grid.y holds one 128-query tile per block row


def knn_distance_cuda(queries: torch.Tensor,
                      points: torch.Tensor) -> torch.Tensor:
    """[Q,D] fp32 x [N,D] fp32 -> [Q,N] fp32 squared distances."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"queries: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(queries, "queries", torch.float32, (None, None), dev)
    nq, dim = queries.shape
    _build.expect(points, "points", torch.float32, (None, dim), dev)
    n = points.shape[0]
    if nq > _MAX_Q:
        raise ValueError(f"{nq} queries: the kernel takes at most {_MAX_Q}")
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq == 0 or n == 0:
        return out
    fn = _build.entry("knn_distance", "knn_distance_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(queries.data_ptr(), points.data_ptr(), nq, n, dim,
                 out.data_ptr(), _build.stream_of(queries))
    _build.check("knn_distance", err)
    knn_distance_cuda.launches += 1
    return out


knn_distance_cuda.launches = 0
