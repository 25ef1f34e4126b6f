"""Wrapper of the CUDA kernel ``csrc/cf_weights.cu``.

Masked Pearson weights; replaces
``src/repro/kernels/cf_weights.py:cf_weights_pallas``.  The plain version
is ``ref.cf_weights``.  The kernel centres both sides on the card while it
compacts their rated entries (``cf_sparse``), turns the neighbours' lists
into columns by item, and sums over the co-rated items only; its launches
(compaction, the columns' counts, scans and placement, the sums) count as
one launch of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cf_sparse

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_MAX_U = 65535 * cf_sparse.RANGE  # grid.y holds a range of users a block


def cf_weights_cuda(
    active: torch.Tensor, active_mask: torch.Tensor,
    users: torch.Tensor, users_mask: torch.Tensor,
) -> torch.Tensor:
    """[Q,I] fp32 ratings and masks of the active users, [U,I] fp32 ratings
    and masks of the neighbour users -> [Q,U] fp32 weights."""
    dev = active.device
    if dev.type != "cuda":
        raise ValueError(f"active: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(active, "active", torch.float32, (None, None), dev)
    nq, ni = active.shape
    _build.expect(active_mask, "active_mask", torch.float32, (nq, ni), dev)
    _build.expect(users, "users", torch.float32, (None, ni), dev)
    nu = users.shape[0]
    _build.expect(users_mask, "users_mask", torch.float32, (nu, ni), dev)
    if nu > _MAX_U:
        raise ValueError(f"{nu} neighbour users: the kernel takes at most "
                         f"{_MAX_U}")
    out = torch.empty((nq, nu), dtype=torch.float32, device=dev)
    if nq == 0 or nu == 0:
        return out
    if ni == 0:
        return out.zero_()
    scratch = (*cf_sparse.lists(nq, ni, dev), *cf_sparse.lists(nu, ni, dev),
               *cf_sparse.columns(nu, ni, dev))
    fn = _build.entry("cf_weights", "cf_weights_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(active.data_ptr(), active_mask.data_ptr(), users.data_ptr(),
                 users_mask.data_ptr(), nq, nu, ni,
                 *(t.data_ptr() for t in scratch), out.data_ptr(),
                 _build.stream_of(active))
    _build.check("cf_weights", err)
    cf_weights_cuda.launches += 1
    return out


cf_weights_cuda.launches = 0
