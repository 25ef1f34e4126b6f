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

The expert-parallel paths run inside a mesh, over the process group of its
``model`` axis (``axis_name``: the group, the ``shard_map`` axis of the JAX
package), each rank holding its ``E / n`` experts:

  * ``moe_ep``: all-gather the ranks' tokens, compute the local experts over
    all of them (``moe_apply_local(experts_slice=...)``), reduce-scatter the
    contributions back (the JAX package's baseline dispatch);
  * ``moe_ep_a2a``: pack per-destination buffers of only the tokens routed
    to each rank's experts, in bf16 as the JAX package does, and exchange
    them by ``all_to_all_single`` both ways (the DeepSeek-style dispatch).

Their collectives are ``parallel.collectives``' (differentiable).
"""
from __future__ import annotations

import math
import types

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import collectives


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


def axis_size(axis_name) -> int:
    """The number of ranks of a mesh axis (its process group)."""
    return collectives.size(axis_name)


def local_experts(p: MoE, cfg, axis_name):
    """The MoE weights this rank of ``axis_name`` computes with: its ``E /
    n`` experts' slices (the router and the shared experts whole).  Weights
    that are this rank's slice already (a sharded train step's) are kept."""
    n, r = axis_size(axis_name), collectives.rank(axis_name)
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not divide by the "
                         f"axis's {n} ranks")
    e_loc = cfg.n_experts // n
    view = types.SimpleNamespace(router=p.router,
                                 shared=getattr(p, "shared", None))
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(p, name)
        if w.shape[0] == cfg.n_experts:
            w = w[r * e_loc:(r + 1) * e_loc]
        elif w.shape[0] != e_loc:
            raise ValueError(f"{name} holds {w.shape[0]} experts: expected "
                             f"{cfg.n_experts} or this rank's {e_loc}")
        setattr(view, name, w)
    return view


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
    token's contributions are added in expert order.  ``axis_name``, the
    expert-parallel group, is the caller's to reduce over (``moe_ep``), as
    in the JAX package."""
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


def moe_ep_a2a(p, x: torch.Tensor, cfg, *, axis_name) -> torch.Tensor:
    """Expert-parallel MoE with all-to-all send-buffer dispatch.  x is this
    rank's tokens [T_loc, d]; ``p`` has this rank's experts
    (``local_experts``).  Each rank packs, for every expert, the capacity
    of its own tokens routed there, sends each destination rank its
    experts' buffers (bf16) and gets back their outputs."""
    t_loc, d = x.shape
    n_ranks = axis_size(axis_name)
    e_total = cfg.n_experts
    e_loc = e_total // n_ranks
    probs, gates, eidx = _route(p.router, x, cfg.moe_top_k)
    cap = capacity(t_loc, cfg)
    token_idx, gate, valid = _select_for_experts(
        probs, gates, eidx, torch.arange(e_total, device=x.device), cap)
    send = (x[token_idx.reshape(-1)].reshape(e_total, cap, d)
            * valid[..., None]).to(torch.bfloat16)
    recv = collectives.all_to_all(send.reshape(n_ranks * e_loc * cap, d),
                                  axis_name)
    # group received tokens by local expert: [e_loc, n_ranks*cap, d]
    grouped = (recv.reshape(n_ranks, e_loc, cap, d).transpose(0, 1)
               .reshape(e_loc, n_ranks * cap, d))
    y = _expert_ffn(p.w_gate, p.w_up, p.w_down,
                    grouped.to(p.w_gate.dtype))     # [e_loc, n*cap, d]
    back = (y.reshape(e_loc, n_ranks, cap, d).transpose(0, 1)
            .reshape(n_ranks * e_loc * cap, d).to(torch.bfloat16))
    y_mine = collectives.all_to_all(back, axis_name).reshape(
        e_total, cap, d).float()
    out = torch.zeros((t_loc, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, token_idx.reshape(-1),
                        (y_mine * (gate * valid)[..., None]).reshape(-1, d))
    if cfg.n_shared_experts > 0:
        out = out + layers.mlp(p.shared, x).float()
    return out.to(x.dtype)


def moe_ep(p, x: torch.Tensor, cfg, *, axis_name) -> torch.Tensor:
    """Expert-parallel MoE.  x is this rank's tokens [T_loc, d]; ``p`` has
    this rank's experts (``local_experts``), the router replicated.
    All-gather the tokens over ``axis_name``, compute the local experts,
    reduce-scatter the contributions back."""
    n_ranks = axis_size(axis_name)
    rank = collectives.rank(axis_name)
    e_loc = cfg.n_experts // n_ranks
    x_all = collectives.all_gather(x.float(), axis_name)     # [T_glob, d]
    out_all = moe_apply_local(p, x_all, cfg,
                              experts_slice=(rank * e_loc, e_loc),
                              axis_name=axis_name)
    out = collectives.reduce_scatter(out_all, axis_name)     # [T_loc, d]
    if cfg.n_shared_experts > 0:
        out = out + layers.mlp(p.shared, x).float()
    return out.to(x.dtype)
