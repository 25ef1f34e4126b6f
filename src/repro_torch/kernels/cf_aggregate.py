"""Wrapper of the CUDA kernel ``csrc/cf_aggregate.cu``.

A CF map task's four bucket statistics (``sr``, ``sr2``, ``s``, ``c``:
sums of r·m, (r·m)·r, (r − mean)·m and m over each bucket's users) in one
pass over the rating matrix.  It replaces no TPU kernel: the JAX package
leaves these segment sums to XLA (``src/repro/apps/cf.py``).  The plain
version is ``ref.cf_aggregate``, whose bits it gives.  Its two launches
(the buckets' hand-out order, then the sums) count as one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]
_TOO_MANY = -1       # csrc/cf_aggregate.cu: kTooMany


def cf_aggregate_cuda(
    ratings: torch.Tensor, mask: torch.Tensor, means: torch.Tensor,
    order: torch.Tensor, offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """[U,I] fp32 ratings and mask, [U,1] fp32 user means, [U] int32 users
    in stable bucket order, [K+1] int32 bucket starts in that order ->
    (sr, sr2, s, c), each [K,I] fp32."""
    dev = ratings.device
    _build.expect(ratings, "ratings", torch.float32, (None, None), dev)
    nu, ni = ratings.shape
    _build.expect(mask, "mask", torch.float32, (nu, ni), dev)
    _build.expect(means, "means", torch.float32, (nu, 1), dev)
    _build.expect(order, "order", torch.int32, (nu,), dev)
    _build.expect(offsets, "offsets", torch.int32, (None,), dev)
    k = offsets.shape[0] - 1
    if k < 0:
        raise ValueError("offsets: empty, expected K + 1 bucket starts")
    if dev.type != "cuda":
        raise ValueError(f"ratings: on {dev}, the kernel needs a CUDA tensor")
    out = tuple(torch.empty((k, ni), dtype=torch.float32, device=dev)
                for _ in range(4))
    if k == 0 or ni == 0:
        return out
    if nu == 0:
        return tuple(o.zero_() for o in out)
    rank_to_bucket = torch.empty(k, dtype=torch.int32, device=dev)
    fn = _build.entry("cf_aggregate", "cf_aggregate_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(ratings.data_ptr(), mask.data_ptr(), means.data_ptr(),
                 order.data_ptr(), offsets.data_ptr(), nu, ni, k,
                 rank_to_bucket.data_ptr(), *(o.data_ptr() for o in out),
                 _build.stream_of(ratings))
    if err == _TOO_MANY:
        raise ValueError(f"{k} buckets x {ni} items: more blocks than one "
                         "grid holds")
    _build.check("cf_aggregate", err)
    cf_aggregate_cuda.launches += 1
    return out


cf_aggregate_cuda.launches = 0
