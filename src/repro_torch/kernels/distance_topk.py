"""Wrapper of the CUDA kernel ``csrc/distance_topk.cu``.

Fused squared-L2 (or negated dot) scoring and k-best; replaces
``src/repro/kernels/distance_topk.py:distance_topk_pallas``.  The plain
version is ``ref.distance_topk``.

Two regimes, chosen by the number of points N:

- **batched**, N <= ``SMALL_MAX_N``: one launch for every batch item and
  query row (a cluster of eight blocks each), any k;
- **wide**, N > ``SMALL_MAX_N``: a grid of (128-query tile x point chunk)
  blocks and a merge of the chunks, one launch per batch item; a k wider
  than ``MAX_K`` is taken in rounds (``topk_stream.select_in_rounds``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_stream import MAX_K, select_in_rounds

_P, _I = ctypes.c_void_p, ctypes.c_int
_WIDE_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_SMALL_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
               _P]
SMALL_MAX_N = 1024    # kSmallMaxN: the keys one block sorts in shared memory
_TILE = 128           # queries and points per block tile (fp32_tile.cuh)
_BLOCKS_PER_SM = 2    # resident blocks of the chunk kernel: one full wave


def _chunking(nq: int, n: int, n_sms: int) -> tuple[int, int]:
    """(chunk_cols, n_chunks): split the points so that the grid of
    (query tile x chunk) blocks fills the SMs' resident blocks at most once
    (one wave: no SM waits on a last, ragged one)."""
    q_tiles = math.ceil(nq / _TILE)
    n_tiles = max(1, math.ceil(n / _TILE))
    want = max(1, min(n_tiles, _BLOCKS_PER_SM * n_sms // q_tiles))
    chunk_cols = math.ceil(n_tiles / want) * _TILE
    return chunk_cols, max(1, math.ceil(n / chunk_cols))


def distance_topk_cuda(
    queries: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
    valid: torch.Tensor | None = None, *, k: int, metric: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """[Q,D] or [B,Q,D] fp32 queries, [N,D] or [B,N,D] fp32 points, [N] or
    [B,N] int32 labels, optional [N] or [B,N] bool mask -> ([Q,k], [Q,k])
    or ([B,Q,k], [B,Q,k]) (fp32 scores, int32 labels).  Masked points and
    empty slots give (BIG, label 0)."""
    if metric not in ("l2", "dot"):
        raise ValueError(f"metric {metric!r}: expected 'l2' or 'dot'")
    if k < 1:
        raise ValueError(f"k={k}: expected k >= 1")
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"queries: on {dev}, the kernel needs a CUDA tensor")
    batched = queries.dim() == 3
    _build.expect(queries, "queries", torch.float32,
                  (None,) * (3 if batched else 2), dev)
    *lead, nq, dim = queries.shape
    _build.expect(points, "points", torch.float32, (*lead, None, dim), dev)
    n = points.shape[-2]
    _build.expect(labels, "labels", torch.int32,
                  (*lead, n) if labels.dim() == len(lead) + 1 else (n,), dev)
    if valid is not None:
        _build.expect(valid, "valid", torch.bool,
                      (*lead, n) if valid.dim() == len(lead) + 1 else (n,),
                      dev)
    if not batched:
        queries, points = queries[None], points[None]
    nb = queries.shape[0]
    if n <= SMALL_MAX_N:
        out_d, out_l = _launch_small(queries, points, labels, valid, k=k,
                                     metric=metric)
    else:
        parts = [_select_wide(queries[b], points[b], _item(labels, b),
                              _item(valid, b), k=k, metric=metric)
                 for b in range(nb)]
        out_d = torch.stack([d for d, _ in parts])
        out_l = torch.stack([lab for _, lab in parts])
    if not batched:
        return out_d[0], out_l[0]
    return out_d, out_l


def _item(t: torch.Tensor | None, b: int) -> torch.Tensor | None:
    """Batch item b of a [B,N] labels or mask tensor; a shared [N] one as
    it is."""
    return t if t is None or t.dim() == 1 else t[b]


def _select_wide(queries, points, labels, valid, *, k: int, metric: str):
    """The wide regime on one batch item: one launch, or rounds of MAX_K
    for a wider k."""
    if k > MAX_K:
        return select_in_rounds(_launch_wide, queries, points, labels, valid,
                                k=k, metric=metric)
    return _launch_wide(queries, points, labels, valid, k=k, metric=metric)


def _launch_small(queries, points, labels, valid, *, k: int, metric: str):
    """One launch of the batched regime on checked [B,Q,D] / [B,N,D]."""
    dev = queries.device
    nb, nq, dim = queries.shape
    n = points.shape[1]
    out_d = torch.empty((nb, nq, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((nb, nq, k), dtype=torch.int32, device=dev)
    if nb * nq == 0:
        return out_d, out_l
    vec = (dim % 4 == 0 and queries.data_ptr() % 16 == 0
           and points.data_ptr() % 16 == 0)
    fn = _build.entry("distance_topk", "distance_topk_small_f32", _SMALL_ARGS)
    with _build.on_device(dev):
        err = fn(queries.data_ptr(), points.data_ptr(), labels.data_ptr(),
                 _build.ptr(valid), nb, nq, n, dim, k, int(metric == "dot"),
                 n if labels.dim() == 2 else 0,
                 n if valid is not None and valid.dim() == 2 else 0,
                 int(vec), out_d.data_ptr(), out_l.data_ptr(),
                 _build.stream_of(queries))
    _build.check("distance_topk", err)
    distance_topk_cuda.launches += 1
    return out_d, out_l


def _launch_wide(queries, points, labels, valid, *, k: int, metric: str):
    """One launch of the wide regime (k <= MAX_K) on checked 2-D inputs."""
    dev = queries.device
    nq, dim = queries.shape
    n = points.shape[0]
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_l
    chunk_cols, n_chunks = _chunking(nq, n, _build.sm_count(dev))
    if n_chunks > 1:
        part_d = torch.empty((nq, n_chunks, k), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty((nq, n_chunks, k), dtype=torch.int32,
                             device=dev)
    else:
        part_d, part_l = out_d, out_l
    fn = _build.entry("distance_topk", "distance_topk_f32", _WIDE_ARGS)
    with _build.on_device(dev):
        err = fn(queries.data_ptr(), points.data_ptr(), labels.data_ptr(),
                 _build.ptr(valid), nq, n, dim, k, int(metric == "dot"),
                 chunk_cols, n_chunks, part_d.data_ptr(), part_l.data_ptr(),
                 out_d.data_ptr(), out_l.data_ptr(), _build.stream_of(queries))
    _build.check("distance_topk", err)
    distance_topk_cuda.launches += 1
    return out_d, out_l


distance_topk_cuda.launches = 0
