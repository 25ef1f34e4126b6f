"""Wrapper of the CUDA kernel ``csrc/cf_weights.cu``.

Masked Pearson weights; replaces
``src/repro/kernels/cf_weights.py:cf_weights_pallas``.  The plain version
is ``ref.cf_weights``.  The inputs are centred and masked here with plain
torch, as the TPU wrapper does outside its ``pallas_call``; the kernel fuses
the three contractions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _centred

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P, _P]
_MAX_Q = 65535 * 64  # grid.y holds one 64-query tile per block row


def cf_weights_cuda(
    active: torch.Tensor, active_mask: torch.Tensor,
    users: torch.Tensor, users_mask: torch.Tensor,
) -> torch.Tensor:
    """[Q,I] fp32 ratings and 0/1 masks of the active users, [U,I] fp32
    ratings and masks of the neighbour users -> [Q,U] fp32 weights."""
    dev = active.device
    if dev.type != "cuda":
        raise ValueError(f"active: on {dev}, the kernel needs a CUDA tensor")
    _build.expect(active, "active", torch.float32, (None, None), dev)
    nq, ni = active.shape
    _build.expect(active_mask, "active_mask", torch.float32, (nq, ni), dev)
    _build.expect(users, "users", torch.float32, (None, ni), dev)
    nu = users.shape[0]
    _build.expect(users_mask, "users_mask", torch.float32, (nu, ni), dev)
    if nq > _MAX_Q:
        raise ValueError(f"{nq} active users: the kernel takes at most "
                         f"{_MAX_Q}")
    out = torch.empty((nq, nu), dtype=torch.float32, device=dev)
    if nq == 0 or nu == 0:
        return out
    ac = _centred(active, active_mask)
    uc = _centred(users, users_mask)
    fn = _build.entry("cf_weights", "cf_weights_f32", _ARGS)
    with _build.on_device(dev):
        err = fn(ac.data_ptr(), active_mask.data_ptr(), uc.data_ptr(),
                 users_mask.data_ptr(), nq, nu, ni, out.data_ptr(),
                 _build.stream_of(active))
    _build.check("cf_weights", err)
    cf_weights_cuda.launches += 1
    return out


cf_weights_cuda.launches = 0
