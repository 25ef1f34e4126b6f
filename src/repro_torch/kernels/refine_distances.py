"""Wrapper of the CUDA kernel ``csrc/refine_distances.cu``.

Gather-free stage-2 exact distances; replaces
``src/repro/kernels/refine_distances.py:refine_distances_pallas``.  The
plain version is ``ref.refine_distances``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P]
_MAX_Q = 65535        # grid.y holds one query per block row
_MAX_D = 12 * 1024    # the query row sits in 48 KB of shared memory


def refine_distances_cuda(
    queries: torch.Tensor, train_x: torch.Tensor,
    idx: torch.Tensor, valid: torch.Tensor,
) -> torch.Tensor:
    """[Q,D] fp32, [N,D] fp32, [Q,B] int32 indices, [Q,B] bool -> [Q,B] fp32
    distances, BIG where ``valid`` is False.  Indices are clipped to
    [0, N)."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"queries: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(queries, "queries", torch.float32, (None, None), dev)
    nq, dim = queries.shape
    _build.expect(train_x, "train_x", torch.float32, (None, dim), dev)
    n = train_x.shape[0]
    _build.expect(idx, "idx", torch.int32, (nq, None), dev)
    nb = idx.shape[1]
    _build.expect(valid, "valid", torch.bool, (nq, nb), dev)
    if nq > _MAX_Q or dim > _MAX_D:
        raise ValueError(
            f"[{nq}, {dim}] queries: the kernel takes at most {_MAX_Q} "
            f"queries of at most {_MAX_D} features"
        )
    out = torch.empty((nq, nb), dtype=torch.float32, device=dev)
    if nq == 0 or nb == 0:
        return out
    if n == 0:
        raise ValueError("train_x is empty: no row to refine against")
    fn = _build.entry("refine_distances", "refine_distances_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(queries.data_ptr(), train_x.data_ptr(), idx.data_ptr(),
                 valid.data_ptr(), nq, n, nb, dim, out.data_ptr(),
                 _build.stream_of(queries))
    _build.check("refine_distances", err)
    refine_distances_cuda.launches += 1
    return out


refine_distances_cuda.launches = 0
