"""Mixture-of-Experts FFN of the port, as ``src/repro/models/moe.py``
computes it on one device (``moe_dense``).

Routing is token-choice top-k with per-expert capacity truncation: gates
renormalised over the chosen experts (DeepSeek-style), each expert keeps
the ``capacity = min(T, max(1, int(T * top_k * capacity_factor / E)))``
highest-probability tokens that chose it, and a token past every chosen
expert's capacity gets nothing from the routed experts (the shared
experts and the residual still carry it), as the reference drops it.  Ties
go to the lowest index, as ``jax.lax.top_k`` breaks them: both top-k's
are stable sorts.

The expert products are ``torch.matmul`` (batched over the experts), as the
reference leaves them to XLA outside any Pallas kernel.  Where the
reference loops over the experts and scatter-adds each one's
contributions into an f32 ``[T, d]``, the port computes every expert's
slots at once and then adds each token's contributions in expert order,
so a token's sum is taken in the reference's order.

The expert-parallel paths (``moe_ep``, ``moe_ep_a2a``: ``shard_map`` over a
mesh axis) are not ported yet: ``moe_apply_local`` refuses an
``axis_name``.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import layers


class MoE(nn.Module):
    """``router`` [d, E] f32, ``w_gate`` / ``w_up`` [E, d, ff], ``w_down``
    [E, ff, d], and ``shared`` (an MLP of ``moe_d_ff * n_shared_experts``)
    when the config has shared experts."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = layers.dense_init(init, d, e, dtype=torch.float32)
        self.w_gate = init.normal((e, d, ff), 1.0 / math.sqrt(d))
        self.w_up = init.normal((e, d, ff), 1.0 / math.sqrt(d))
        self.w_down = init.normal((e, ff, d), 1.0 / math.sqrt(ff))
        if cfg.n_shared_experts > 0:
            self.shared = layers.mlp_init(
                init, d, cfg.moe_d_ff * cfg.n_shared_experts)


def moe_init(init: layers.Init, cfg) -> MoE:
    return MoE(init, cfg)


def _stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The k largest along the last axis, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: torch.Tensor, xf: torch.Tensor, top_k: int):
    """Router probabilities and normalised top-k gates: (probs [T,E],
    gates [T,k], eidx [T,k])."""
    probs = torch.softmax(xf.float() @ router_w, dim=-1)
    gates, eidx = _stable_topk(probs, top_k)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def _select_for_experts(probs, gates, eidx, experts: torch.Tensor,
                        capacity: int):
    """Capacity-truncated token selection for each expert in ``experts``
    [E']: (token_idx [E',C], gate [E',C], valid [E',C]), the C
    highest-probability tokens that chose the expert in their top-k."""
    hit = eidx[None] == experts[:, None, None]             # [E',T,k]
    chose = hit.any(dim=-1)                                # [E',T]
    gate_e = torch.where(hit, gates[None], 0.0).sum(dim=-1)
    score = torch.where(chose, probs.T[experts], -1.0)     # [E',T]
    top_score, token_idx = _stable_topk(score, capacity)
    valid = top_score > 0.0
    return token_idx, gate_e.gather(1, token_idx) * valid, valid


def _select_for_expert(probs, gates, eidx, e: int, capacity: int):
    """``_select_for_experts`` for expert ``e`` alone: (token_idx [C], gate
    [C], valid [C])."""
    experts = torch.tensor([e], device=probs.device)
    return tuple(t[0] for t in _select_for_experts(probs, gates, eidx,
                                                    experts, capacity))


def _expert_ffn(w_gate, w_up, w_down, x):
    """x [..., C, d] through the experts' SwiGLU (batched over a leading
    expert axis)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def capacity(n_tokens: int, cfg) -> int:
    return min(n_tokens, max(1, int(
        n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)))


def moe_apply_local(p: MoE, xf: torch.Tensor, cfg, *, experts_slice=None,
                    axis_name: str | None = None) -> torch.Tensor:
    """Routed experts over flat tokens xf [T, d] -> f32 [T, d].

    ``experts_slice`` = (start, count): the experts this caller owns (all
    by default); ``p``'s expert weights are those ``count`` experts'.  Each
    token's contributions are added in expert order."""
    if axis_name is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh axis is not ported yet")
    t, d = xf.shape
    probs, gates, eidx = _route(p.router, xf, cfg.moe_top_k)
    cap = capacity(t, cfg)
    start, count = (0, cfg.n_experts) if experts_slice is None \
        else experts_slice
    experts = torch.arange(start, start + count, device=xf.device)
    token_idx, gate, valid = _select_for_experts(probs, gates, eidx,
                                                 experts, cap)
    x_e = xf[token_idx] * valid[..., None]                 # [E',C,d]
    y = _expert_ffn(p.w_gate, p.w_up, p.w_down, x_e.to(p.w_gate.dtype))
    contrib = y.float() * gate[..., None]                  # [E',C,d]
    # slot_of[e, t]: token t's slot in expert e's selection, or -1
    slot_of = torch.full((count, t), -1, dtype=torch.long, device=xf.device)
    slots = torch.arange(cap, device=xf.device).expand(count, cap)
    slot_of.scatter_(1, token_idx, torch.where(valid, slots, -1))
    # a token's chosen experts in expert order, each adding its slot's
    # contribution: the reference's sequential scatter-adds over experts
    rows = torch.arange(t, device=xf.device)
    out = torch.zeros((t, d), dtype=torch.float32, device=xf.device)
    for e in torch.sort(eidx, dim=-1).values.T - start:      # [T] each
        mine = (e >= 0) & (e < count)
        e = e.clamp(0, count - 1)
        slot = torch.where(mine, slot_of[e, rows], -1)
        got = contrib[e, slot.clamp_min(0)]
        out += torch.where((slot >= 0)[:, None], got, 0.0)
    return out


def moe_dense(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """The MoE FFN on one device.  x [B, S, d] -> [B, S, d] in x's
    dtype."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    out = moe_apply_local(p, xf, cfg)
    if cfg.n_shared_experts > 0:
        out = out + layers.mlp(p.shared, xf).float()
    return out.reshape(b, s, d).to(x.dtype)
