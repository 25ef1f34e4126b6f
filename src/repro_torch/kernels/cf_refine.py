"""Wrapper of the CUDA kernel ``csrc/cf_refine.cu``.

Gather-free CF stage-2 refinement; replaces
``src/repro/kernels/cf_refine.py:cf_refine_pallas``.  The plain version is
``ref.cf_refine``.  The kernel centres the active rows and the shard on the
card while it compacts their rated entries (``cf_sparse``), then works on
the selected users' rated entries only; its two launches (the compaction,
then weights and the ordered accumulation, a block a query) count as one
launch of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cf_sparse

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P,
         _P, _P]


def cf_refine_cuda(
    active: torch.Tensor, active_mask: torch.Tensor,
    ratings: torch.Tensor, mask: torch.Tensor,
    idx: torch.Tensor, use: torch.Tensor,
    *, shrink: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[Q,I] fp32 active ratings and masks, [U,I] fp32 shard ratings and
    masks, [Q,B] int32 selected users, [Q,B] bool gate -> (w [Q,B],
    num_delta [Q,I], den_delta [Q,I]) fp32.  Indices are clipped to
    [0, U)."""
    dev = active.device
    if dev.type != "cuda":
        raise ValueError(f"active: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(active, "active", torch.float32, (None, None), dev)
    nq, ni = active.shape
    _build.expect(active_mask, "active_mask", torch.float32, (nq, ni), dev)
    _build.expect(ratings, "ratings", torch.float32, (None, ni), dev)
    nu = ratings.shape[0]
    _build.expect(mask, "mask", torch.float32, (nu, ni), dev)
    _build.expect(idx, "idx", torch.int32, (nq, None), dev)
    nb = idx.shape[1]
    _build.expect(use, "use", torch.bool, (nq, nb), dev)
    w = torch.empty((nq, nb), dtype=torch.float32, device=dev)
    num = torch.empty((nq, ni), dtype=torch.float32, device=dev)
    den = torch.empty((nq, ni), dtype=torch.float32, device=dev)
    if nq == 0 or ni == 0:
        return w.zero_(), num, den
    if nu == 0:
        raise ValueError("ratings is empty: no user to refine against")
    scratch = (*cf_sparse.lists(nq, ni, dev), *cf_sparse.lists(nu, ni, dev))
    fn = _build.entry("cf_refine", "cf_refine_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(active.data_ptr(), active_mask.data_ptr(), ratings.data_ptr(),
                 mask.data_ptr(), idx.data_ptr(), use.data_ptr(), nq, nu, nb,
                 ni, float(shrink), *(t.data_ptr() for t in scratch),
                 w.data_ptr(), num.data_ptr(), den.data_ptr(),
                 _build.stream_of(active))
    _build.check("cf_refine", err)
    cf_refine_cuda.launches += 1
    return w, num, den


cf_refine_cuda.launches = 0
