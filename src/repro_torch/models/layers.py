"""Shared transformer layers of the port: norms, linears, RoPE, GQA attention
with an exact KV cache, and the SwiGLU MLP, as ``src/repro/models/layers.py``
computes them.

Parameters live in ``nn.Module`` containers whose attribute names are the
JAX package's dictionary keys (``p.wq`` for ``p["wq"]``); weights keep its
``[d_in, d_out]`` layout, so a layer is ``x @ w``.  The casts are the
reference's: RMSNorm and RoPE run in float32 and cast back to the
activation dtype, attention runs in float32 and its output is cast back
before the output projection.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: expected one of {sorted(DTYPES)}")
    return DTYPES[name]


class Init:
    """Makes parameters on ``device``: standard normals scaled, drawn from an
    explicit generator on the generator's own device, or (``generator=None``)
    uninitialised tensors that a caller fills, as
    ``convert.lm_params_from_numpy`` does."""

    def __init__(self, generator: torch.Generator | None, *,
                 dtype: torch.dtype, device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape: tuple, scale: float) -> nn.Parameter:
        if self.generator is None:
            t = torch.empty(shape, dtype=self.dtype, device=self.device)
        else:
            t = torch.randn(shape, generator=self.generator,
                            device=self.generator.device) * scale
            t = t.to(device=self.device, dtype=self.dtype)
        return nn.Parameter(t, requires_grad=False)

    def const(self, shape: tuple, value: float) -> nn.Parameter:
        t = torch.full(shape, value, dtype=self.dtype, device=self.device)
        return nn.Parameter(t, requires_grad=False)


def dense_init(init: Init, d_in: int, d_out: int,
               scale: float | None = None) -> nn.Parameter:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((d_in, d_out), scale)


def rmsnorm_init(init: Init, d: int) -> nn.Parameter:
    return init.const((d,), 1.0)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * w in float32, cast back to x's dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), w.float(), eps).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / theta ** exps


def rope_rotation(positions: torch.Tensor, head_dim: int,
                  theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles, [..., S, 1, hd/2] f32, for
    positions [..., S]: every layer of a decode step shares them."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs           # [..., S, hd/2]
    angles = angles[..., None, :]                           # [..., S, 1, hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               rotation: tuple | None = None) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, hd]; positions: [..., S] int;
    ``rotation`` is ``rope_rotation(positions, hd, theta)`` when the caller
    has it already."""
    if rotation is None:
        rotation = rope_rotation(positions, x.shape[-1], theta)
    cos, sin = rotation
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Weights of (grouped-query) attention: wq, wk, wv, wo, and q_norm /
    k_norm with ``qk_norm``, bq / bk / bv with ``qkv_bias``."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = dense_init(init, d, h * hd)
        self.wk = dense_init(init, d, hkv * hd)
        self.wv = dense_init(init, d, hkv * hd)
        self.wo = dense_init(init, h * hd, d)
        if cfg.qkv_bias:
            self.bq = init.const((h * hd,), 0.0)
            self.bk = init.const((hkv * hd,), 0.0)
            self.bv = init.const((hkv * hd,), 0.0)
        if cfg.qk_norm:
            self.q_norm = rmsnorm_init(init, hd)
            self.k_norm = rmsnorm_init(init, hd)


def attention_init(init: Init, cfg) -> Attention:
    return Attention(init, cfg)


def _project_qkv(p: Attention, x: torch.Tensor, cfg, positions: torch.Tensor,
                 rotation: tuple | None = None):
    """x [B,S,d] -> q [B,S,H,hd], k, v [B,S,Hkv,hd] (RoPE applied, with
    ``rotation`` from ``rope_rotation`` when given)."""
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet")
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if cfg.use_rope:
        # one rotation of the query and key heads together (elementwise:
        # the same values as rotating each)
        qk = apply_rope(torch.cat([q, k], dim=2), positions, cfg.rope_theta,
                        rotation=rotation)
        q, k = qk[:, :, :h], qk[:, :, h:]
    return q, k, v


def attention_decode(
    p: Attention, x: torch.Tensor, cfg, *, cache_k: torch.Tensor,
    cache_v: torch.Tensor, pos: torch.Tensor,
    write_pos: torch.Tensor | None = None, rotation: tuple | None = None,
):
    """One decode step with exact attention.  x [B,1,d]; cache_k/v
    [B,S,Hkv,hd]; pos [B].  The new key and value are written into the
    caches in place at ``write_pos`` (default ``pos``); returns (out
    [B,1,d], cache_k, cache_v)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_max = cache_k.shape[1]
    if write_pos is None:
        write_pos = pos
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None], rotation)
    rows = torch.arange(b, device=x.device)
    slot = write_pos.long().clamp(0, s_max - 1)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)

    group = h // hkv
    qg = q.reshape(b, 1, hkv, group, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          cache_k.float()) / math.sqrt(hd)
    t_idx = torch.arange(s_max, device=x.device)[None, :]
    n_live = torch.clamp_max(pos[:, None] + 1, s_max)
    valid = t_idx < n_live
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cache_v.float())
    out = out.reshape(b, 1, h * hd).to(x.dtype) @ p.wo
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU weights: w_gate, w_up [d, ff], w_down [ff, d]."""

    def __init__(self, init: Init, d_model: int, d_ff: int):
        super().__init__()
        self.w_gate = dense_init(init, d_model, d_ff)
        self.w_up = dense_init(init, d_model, d_ff)
        self.w_down = dense_init(init, d_ff, d_model)


def mlp_init(init: Init, d_model: int, d_ff: int) -> MLP:
    return MLP(init, d_model, d_ff)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
