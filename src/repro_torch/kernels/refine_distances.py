"""Wrapper of the CUDA kernel ``csrc/refine_distances.cu``.

Gather-free stage-2 exact distances; replaces
``src/repro/kernels/refine_distances.py:refine_distances_pallas``.  The
plain version is ``ref.refine_distances``.  The kernel groups the slots by
the bucket of their rows (``bucket_of``, the schedule key) so that the
queries that refine a bucket share one staged copy of its rows; its
launches (marking the runs, planning, placing them, the distances) count
as one launch of the kernel.  The key decides only the schedule: any
``bucket_of`` gives the same distances.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, refine_schedule

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 5 + [_P] * 12
_MAX_SLOTS = 2**31 - 1   # a run is kept as q * B + base in an int32


def refine_distances_cuda(
    queries: torch.Tensor, train_x: torch.Tensor,
    idx: torch.Tensor, valid: torch.Tensor,
    bucket_of: torch.Tensor | None = None, *, n_buckets: int = 0,
) -> torch.Tensor:
    """[Q,D] fp32, [N,D] fp32, [Q,B] int32 indices, [Q,B] bool, [N] int32
    bucket of each row (taken into [0, n_buckets)) -> [Q,B] fp32
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
    if bucket_of is None or n_buckets < 1:
        raise ValueError("bucket_of and n_buckets >= 1: the kernel schedules "
                         "the slots by the bucket of their rows")
    _build.expect(bucket_of, "bucket_of", torch.int32, (n,), dev)
    if nq * nb > _MAX_SLOTS:
        raise ValueError(f"[{nq}, {nb}] slots: the kernel takes at most "
                         f"{_MAX_SLOTS}")
    out = torch.empty((nq, nb), dtype=torch.float32, device=dev)
    if nq == 0 or nb == 0:
        return out
    if n == 0:
        raise ValueError("train_x is empty: no row to refine against")
    scratch = refine_schedule.scratch(nq, nb, n_buckets, dev)
    fn = _build.entry("refine_distances", "refine_distances_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(queries.data_ptr(), train_x.data_ptr(), idx.data_ptr(),
                 valid.data_ptr(), bucket_of.data_ptr(), nq, n, nb, dim,
                 n_buckets, *(t.data_ptr() for t in scratch), out.data_ptr(),
                 _build.stream_of(queries))
    _build.check("refine_distances", err)
    refine_distances_cuda.launches += 1
    return out


refine_distances_cuda.launches = 0
