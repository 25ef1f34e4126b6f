"""xLSTM blocks of the port: mLSTM (matrix memory, exponential gating) and
sLSTM (scalar memory with recurrent feedback), as
``src/repro/models/xlstm.py`` computes them.  Both are O(1)-state
recurrences: no KV cache and no attention, so the aggregated-KV technique
does not apply and no kernel runs.

Training runs the step over time in ``layers.checkpointed_scan``.  States,
float32:

  mLSTM: (C [B,H,dk,dv], n [B,H,dk], m [B,H])
  sLSTM: (c [B,H,dh], n [B,H,dh], h [B,H,dh], m [B,H,dh])

The stabiliser ``m`` starts at -1e30.  Decode updates a state's tensors
in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import layers

M_START = -1e30


# ---------------------------------------------------------------- mLSTM ----

class MLSTM(nn.Module):
    """mLSTM weights: wq, wk, wv, w_o, out_proj [d, d], w_if [d, 2H], ln
    [d], b_if [2H] float32."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        self.wq = layers.dense_init(init, d, d)
        self.wk = layers.dense_init(init, d, d)
        self.wv = layers.dense_init(init, d, d)
        self.w_if = layers.dense_init(init, d, 2 * h)
        self.w_o = layers.dense_init(init, d, d)
        self.out_proj = layers.dense_init(init, d, d)
        self.ln = layers.rmsnorm_init(init, d)
        self.b_if = nn.Parameter(
            torch.zeros(2 * h, dtype=torch.float32, device=init.device),
            requires_grad=False)


def mlstm_init(init: layers.Init, cfg) -> MLSTM:
    return MLSTM(init, cfg)


def _mlstm_gates(p: MLSTM, x: torch.Tensor, cfg):
    b, s, d = x.shape
    h = cfg.n_heads
    dk = d // h
    q = (x @ p.wq).reshape(b, s, h, dk) / math.sqrt(dk)
    k = (x @ p.wk).reshape(b, s, h, dk) / math.sqrt(dk)
    v = (x @ p.wv).reshape(b, s, h, dk)
    if_ = (x @ p.w_if).float() + p.b_if
    i_pre, f_pre = torch.chunk(if_, 2, dim=-1)           # [B,S,H]
    o = torch.sigmoid(x @ p.w_o)                         # [B,S,d]
    return q, k, v, i_pre, f_pre, o


def mlstm_step(state, inputs):
    """One stabilised mLSTM time step: (state, (q, k, v, i_pre, f_pre))
    -> (state, h [B,H,dv] f32)."""
    c, n, m = state
    q, k, v, i_pre, f_pre = inputs
    logf = F.logsigmoid(f_pre)                           # [B,H]
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m - m_new)
    kf, vf = k.float(), v.float()
    c = f_g[..., None, None] * c + i_g[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * kf
    qf = q.float()
    denom = torch.maximum((n * qf).sum(dim=-1).abs(), torch.exp(-m_new))
    h_t = torch.einsum("bhk,bhkv->bhv", qf, c) / denom[..., None]
    return (c, n, m_new), h_t


def mlstm_empty_state(batch: int, cfg, *,
                      device: torch.device | None = None) -> tuple:
    h = cfg.n_heads
    dk = cfg.d_model // h
    return (torch.zeros((batch, h, dk, dk), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, h, dk), dtype=torch.float32, device=device),
            torch.full((batch, h), M_START, dtype=torch.float32,
                       device=device))


def mlstm_block(p: MLSTM, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence mLSTM block.  x [B,S,d]."""
    b, s, d = x.shape
    q, k, v, i_pre, f_pre, o = _mlstm_gates(p, x, cfg)
    xs = tuple(t.movedim(1, 0) for t in (q, k, v, i_pre, f_pre))
    _, hs = layers.checkpointed_scan(
        mlstm_step, mlstm_empty_state(b, cfg, device=x.device), xs)
    hs = hs.movedim(0, 1).reshape(b, s, d).to(x.dtype)   # [B,S,H*dv]
    hs = layers.rmsnorm(hs, p.ln, cfg.norm_eps) * o
    return hs @ p.out_proj


def _update(state: tuple, new: tuple) -> tuple:
    for old, t in zip(state, new):
        old.copy_(t)
    return state


def mlstm_decode(p: MLSTM, x: torch.Tensor, cfg, state: tuple
                 ) -> torch.Tensor:
    """One decode step.  x [B,1,d]; ``state`` updated in place."""
    b, _, d = x.shape
    q, k, v, i_pre, f_pre, o = _mlstm_gates(p, x, cfg)
    new, h_t = mlstm_step(state, tuple(t[:, 0] for t in
                                       (q, k, v, i_pre, f_pre)))
    _update(state, new)
    hs = h_t.reshape(b, 1, d).to(x.dtype)
    hs = layers.rmsnorm(hs, p.ln, cfg.norm_eps) * o
    return hs @ p.out_proj


# ---------------------------------------------------------------- sLSTM ----

class SLSTM(nn.Module):
    """sLSTM weights: w_x [d, 4d] (the i/f/z/o gates' inputs), r_h [H, dh,
    4 dh] (block-diagonal recurrent feedback), bias [4d] float32, gn [d],
    out_proj [d, d]."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        self.w_x = layers.dense_init(init, d, 4 * d)
        self.r_h = init.normal((h, dh, 4 * dh), 1.0 / math.sqrt(dh))
        self.bias = nn.Parameter(
            torch.zeros(4 * d, dtype=torch.float32, device=init.device),
            requires_grad=False)
        self.gn = layers.rmsnorm_init(init, d)
        self.out_proj = layers.dense_init(init, d, d)


def slstm_init(init: layers.Init, cfg) -> SLSTM:
    return SLSTM(init, cfg)


def slstm_step(p: SLSTM, cfg, state, x_t: torch.Tensor):
    """x_t [B,d]; state (c, n, h, m) each [B,H,dh].  ``h`` is cast to the
    recurrent weight's dtype on every step (a bf16 model rounds there)."""
    b, d = x_t.shape
    hh = cfg.n_heads
    dh = d // hh
    c, n, h_prev, m = state
    pre = (x_t @ p.w_x).float()
    rec = torch.einsum("bhd,hdf->bhf", h_prev.to(p.r_h.dtype),
                       p.r_h).float()                    # [B,H,4dh]
    pre = pre.reshape(b, hh, 4 * dh) + rec + p.bias.reshape(hh, 4 * dh)
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf + m - m_new)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h_new = o * c / torch.clamp_min(n, 1.0)
    return (c, n, h_new, m_new), h_new


def slstm_empty_state(batch: int, cfg, *,
                      device: torch.device | None = None) -> tuple:
    hh = cfg.n_heads
    dh = cfg.d_model // hh

    def zeros():
        return torch.zeros((batch, hh, dh), dtype=torch.float32,
                           device=device)
    return (zeros(), zeros(), zeros(),
            torch.full((batch, hh, dh), M_START, dtype=torch.float32,
                       device=device))


def slstm_block(p: SLSTM, x: torch.Tensor, cfg) -> torch.Tensor:
    b, s, d = x.shape
    _, hs = layers.checkpointed_scan(
        lambda st, xt: slstm_step(p, cfg, st, xt),
        slstm_empty_state(b, cfg, device=x.device), x.movedim(1, 0))
    hs = hs.movedim(0, 1).reshape(b, s, d).to(x.dtype)
    hs = layers.rmsnorm(hs, p.gn, cfg.norm_eps)
    return hs @ p.out_proj


def slstm_decode(p: SLSTM, x: torch.Tensor, cfg, state: tuple
                 ) -> torch.Tensor:
    """One decode step.  x [B,1,d]; ``state`` updated in place."""
    b, _, d = x.shape
    new, h_t = slstm_step(p, cfg, state, x[:, 0])
    _update(state, new)
    hs = h_t.reshape(b, 1, d).to(x.dtype)
    hs = layers.rmsnorm(hs, p.gn, cfg.norm_eps)
    return hs @ p.out_proj
