"""Mamba2 (state-space duality) blocks of the port, for zamba2's hybrid
stack, as ``src/repro/models/ssm.py`` computes them.

Training and prefill run the chunked SSD algorithm: within a chunk a
quadratic form of batched products, between chunks a linear recurrence
over the chunk states.  Decode is the O(1)-a-token state recurrence.  The
JAX package computes all of it outside any Pallas kernel, and so does the
port (einsums and products).

The dtypes are the reference's: the projections, the causal convolution
and its decode step multiply and add in the model dtype; ``dt``, ``a``,
the SSD and the state run in float32.  The (z, x, B, C, dt) projections
are separate weights, as there.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import layers


class Mamba(nn.Module):
    """Mamba2 weights: in_z, in_x [d, d_in], in_b, in_c [d, G N], in_dt
    [d, H], the depthwise conv_x [K, d_in] and conv_bc [K, 2 G N] with
    their biases, a_log, d_skip and dt_bias [H] (float32), gate_norm
    [d_in] and out_proj [d_in, d]."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        gn = cfg.ssm_groups * cfg.ssm_state
        h = d_in // cfg.ssm_head_dim
        self.in_z = layers.dense_init(init, d, d_in)
        self.in_x = layers.dense_init(init, d, d_in)
        self.in_b = layers.dense_init(init, d, gn)
        self.in_c = layers.dense_init(init, d, gn)
        self.in_dt = layers.dense_init(init, d, h)
        self.conv_x = init.normal((cfg.ssm_conv, d_in), 0.1)
        self.conv_bc = init.normal((cfg.ssm_conv, 2 * gn), 0.1)
        self.conv_bias_x = init.const((d_in,), 0.0)
        self.conv_bias_bc = init.const((2 * gn,), 0.0)
        a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32))
        self.a_log = nn.Parameter(a_log.to(init.device), requires_grad=False)
        self.d_skip = nn.Parameter(
            torch.ones(h, dtype=torch.float32, device=init.device),
            requires_grad=False)
        self.dt_bias = nn.Parameter(
            torch.zeros(h, dtype=torch.float32, device=init.device),
            requires_grad=False)
        self.gate_norm = layers.rmsnorm_init(init, d_in)
        self.out_proj = layers.dense_init(init, d_in, d)


def mamba_init(init: layers.Init, cfg) -> Mamba:
    return Mamba(init, cfg)


def dims(cfg) -> tuple[int, int, int, int]:
    """(d_in, groups G, state N, heads H) of a config's Mamba2 blocks."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_groups, cfg.ssm_state, d_in // cfg.ssm_head_dim


def _project(p: Mamba, x: torch.Tensor):
    """x [B,S,d] -> (z, x, [B ; C], dt) in the model dtype."""
    bc = torch.cat([x @ p.in_b, x @ p.in_c], dim=-1)
    return x @ p.in_z, x @ p.in_x, bc, x @ p.in_dt


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, then SiLU.  seq [B,S,C]; w [K,C]; the taps
    summed in order in the model dtype."""
    k, s = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j < l <= i} x[..., l], and
    -inf above the diagonal."""
    s = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_: torch.Tensor, c_: torch.Tensor, *,
                chunk: int) -> torch.Tensor:
    """Chunked state-space-duality scan.

    xh [B,S,H,P] head inputs; dt [B,S,H] (after softplus); a [H] (< 0);
    b_, c_ [B,S,G,N] (each group shared by H/G heads).  Returns y
    [B,S,H,P] float32.
    """
    bsz, s, h, p = xh.shape
    g, n = b_.shape[2], b_.shape[3]
    nc = s // chunk

    def rs(t):                                  # [B,S,...] -> [B,nc,L,...]
        return t.reshape((bsz, nc, chunk) + t.shape[2:])

    xh_c, dt_c = rs(xh.float()), rs(dt)
    # B and C stay at group granularity [B,nc,L,G,N]: the einsums
    # broadcast the group over its heads.
    b_c, c_c = rs(b_.float()), rs(c_.float())
    da = dt_c * a                                         # [B,nc,L,H]
    da_cs = torch.cumsum(da, dim=2)
    xdt = xh_c * dt_c[..., None]                          # [B,nc,L,H,P]
    hg = h // g

    def grp(t):                        # [B,nc,L,H,...] -> [B,nc,L,G,hg,...]
        return t.reshape(t.shape[:3] + (g, hg) + t.shape[4:])

    # intra-chunk: quadratic within the chunk
    l_mat = torch.exp(_segsum(da.movedim(2, -1)))         # [B,nc,H,L,L]
    scores = torch.einsum("bclgn,bcmgn->bcglm", c_c, b_c)
    sc_l = scores[:, :, :, None] * l_mat.reshape(bsz, nc, g, hg, chunk,
                                                 chunk)
    y_diag = torch.einsum("bcgelm,bcmgep->bclgep", sc_l, grp(xdt)) \
        .reshape(bsz, nc, chunk, h, p)

    # each chunk's state at its end
    decay_to_end = torch.exp(da_cs[:, :, -1:] - da_cs)    # [B,nc,L,H]
    states = torch.einsum("bclgn,bclgep->bcgenp", b_c,
                          grp(xdt * decay_to_end[..., None])) \
        .reshape(bsz, nc, h, n, p)
    chunk_decay = torch.exp(da_cs[:, :, -1])              # [B,nc,H]

    # inter-chunk recurrence: the state entering each chunk
    carry = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                    # [B,nc,H,N,P]

    # what the entering state adds within each chunk
    state_decay = torch.exp(da_cs)                        # [B,nc,L,H]
    y_off = torch.einsum(
        "bclgn,bcgenp->bclgep", c_c,
        prev_states.reshape(bsz, nc, g, hg, n, p),
    ).reshape(bsz, nc, chunk, h, p) * state_decay[..., None]
    return (y_diag + y_off).reshape(bsz, s, h, p)


def mamba_block(p: Mamba, x: torch.Tensor, cfg, *,
                chunk: int = 128) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x [B,S,d] -> [B,S,d].  The SSD chunk
    is halved until it divides S."""
    bsz, s, _ = x.shape
    d_in, g, n, h = dims(cfg)
    z, xc, bc, dt = _project(p, x)
    xc = _causal_conv(xc, p.conv_x, p.conv_bias_x)
    bc = _causal_conv(bc, p.conv_bc, p.conv_bias_bc)
    b_, c_ = torch.chunk(bc, 2, dim=-1)
    xh = xc.reshape(bsz, s, h, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    ch = min(chunk, s)
    while s % ch:
        ch //= 2
    y = ssd_chunked(xh, dt, a, b_.reshape(bsz, s, g, n),
                    c_.reshape(bsz, s, g, n), chunk=max(ch, 1))
    y = y + xh.float() * p.d_skip[:, None]
    y = y.reshape(bsz, s, d_in).to(x.dtype)
    y = layers.rmsnorm(y * F.silu(z), p.gate_norm, cfg.norm_eps)
    return y @ p.out_proj


def empty_state(cfg, batch: int, *, dtype: torch.dtype,
                device: torch.device) -> dict:
    """A Mamba2 block's decode cache: ``conv`` (the last K-1 inputs of the
    x and [B ; C] convolutions, [B,K-1,d_in] and [B,K-1,2GN], model dtype)
    and ``state`` [B,H,N,P] float32."""
    d_in, g, n, h = dims(cfg)
    k1 = cfg.ssm_conv - 1
    return {
        "conv": (torch.zeros((batch, k1, d_in), dtype=dtype, device=device),
                 torch.zeros((batch, k1, 2 * g * n), dtype=dtype,
                             device=device)),
        "state": torch.zeros((batch, h, n, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }


def _conv_step(win: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """One step of the causal conv: the window [B,K-1,C] and the new input
    [B,1,C] against w [K,C], the taps summed in the model dtype; the
    window moves on by one in place."""
    full = torch.cat([win, new], dim=1)                   # [B,K,C]
    out = (full * w).sum(dim=1, keepdim=True)
    win.copy_(full[:, 1:])
    return F.silu(out + bias)


def mamba_decode(p: Mamba, x: torch.Tensor, cfg, cache: dict
                 ) -> torch.Tensor:
    """One decode step.  x [B,1,d]; ``cache`` from ``empty_state``,
    updated in place.  Returns [B,1,d]."""
    bsz = x.shape[0]
    d_in, g, n, h = dims(cfg)
    z, xc, bc, dt = _project(p, x)
    x_win, bc_win = cache["conv"]
    xc = _conv_step(x_win, xc, p.conv_x, p.conv_bias_x)
    bc = _conv_step(bc_win, bc, p.conv_bc, p.conv_bias_bc)
    b_, c_ = torch.chunk(bc, 2, dim=-1)
    xh = xc.reshape(bsz, h, cfg.ssm_head_dim).float()
    dt = F.softplus(dt.reshape(bsz, h).float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    rep = h // g
    b1 = b_.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    c1 = c_.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt * a)                             # [B,H]
    state = cache["state"]
    state.copy_(state * decay[..., None, None]
                + torch.einsum("bhn,bhp->bhnp", b1, xh * dt[..., None]))
    y = torch.einsum("bhnp,bhn->bhp", state, c1)
    y = y + xh * p.d_skip[:, None]
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = layers.rmsnorm(y * F.silu(z), p.gate_norm, cfg.norm_eps)
    return y @ p.out_proj
