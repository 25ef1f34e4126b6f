"""Wrapper of the CUDA kernel ``csrc/distance_topk.cu``.

Fused squared-L2 (or negated dot) scoring and streaming k-best; replaces
``src/repro/kernels/distance_topk.py:distance_topk_pallas``.  The plain
version is ``ref.distance_topk``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_stream import MAX_K, select_in_rounds

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_TILE = 64            # queries and points per block tile (sqdist_tile.cuh)
_BLOCKS_PER_SM = 8    # aim for several waves so the last one is not ragged


def _chunking(nq: int, n: int, n_sms: int) -> tuple[int, int]:
    """(chunk_cols, n_chunks): split the points so that the grid of
    (query tile x chunk) blocks gives every SM several blocks."""
    q_tiles = math.ceil(nq / _TILE)
    n_tiles = max(1, math.ceil(n / _TILE))
    want = max(1, min(n_tiles, math.ceil(_BLOCKS_PER_SM * n_sms / q_tiles)))
    chunk_cols = math.ceil(n_tiles / want) * _TILE
    return chunk_cols, max(1, math.ceil(n / chunk_cols))


def distance_topk_cuda(
    queries: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
    valid: torch.Tensor | None = None, *, k: int, metric: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """[Q,D] fp32 queries, [N,D] fp32 points, [N] int32 labels, optional [N]
    bool mask -> ([Q,k] fp32 scores, [Q,k] int32 labels).  Masked points and
    empty slots give (BIG, label 0).  The kernel keeps at most ``MAX_K``
    best in registers; a wider k is taken in rounds of launches
    (``topk_stream.select_in_rounds``), one query row at a time."""
    if metric not in ("l2", "dot"):
        raise ValueError(f"metric {metric!r}: expected 'l2' or 'dot'")
    if k < 1:
        raise ValueError(f"k={k}: expected k >= 1")
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"queries: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(queries, "queries", torch.float32, (None, None), dev)
    nq, dim = queries.shape
    _build.expect(points, "points", torch.float32, (None, dim), dev)
    n = points.shape[0]
    _build.expect(labels, "labels", torch.int32, (n,), dev)
    if valid is not None:
        _build.expect(valid, "valid", torch.bool, (n,), dev)
    if k > MAX_K:
        return select_in_rounds(_launch, queries, points, labels, valid, k=k,
                                metric=metric)
    return _launch(queries, points, labels, valid, k=k, metric=metric)


def _launch(queries, points, labels, valid, *, k: int, metric: str):
    """One launch of the kernel (k <= MAX_K) on checked inputs."""
    dev = queries.device
    nq, dim = queries.shape
    n = points.shape[0]
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_l
    n_sms = _build.sm_count(dev)
    chunk_cols, n_chunks = _chunking(nq, n, n_sms)
    if n_chunks > 1:
        part_d = torch.empty((nq, n_chunks, k), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty((nq, n_chunks, k), dtype=torch.int32,
                             device=dev)
    else:
        part_d, part_l = out_d, out_l
    fn = _build.entry("distance_topk", "distance_topk_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(queries.data_ptr(), points.data_ptr(), labels.data_ptr(),
                 _build.ptr(valid), nq, n, dim, k, int(metric == "dot"),
                 chunk_cols, n_chunks, part_d.data_ptr(), part_l.data_ptr(),
                 out_d.data_ptr(), out_l.data_ptr(), _build.stream_of(queries))
    _build.check("distance_topk", err)
    distance_topk_cuda.launches += 1
    return out_d, out_l


distance_topk_cuda.launches = 0
