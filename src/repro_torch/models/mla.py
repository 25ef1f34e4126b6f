"""Multi-head Latent Attention (DeepSeek-V2) of the port, as
``src/repro/models/mla.py`` computes it: the full-sequence path for
training and prefill, and the absorbed single-token decode.

Train / prefill materialises per-head keys and values from the kv latent;
decode uses the absorbed form: the cache holds only ``c_kv`` [S, r] and
``k_rope`` [S, dr], and W_UK / W_UV fold into the query and the output, so
decode attention is MQA with (r + dr)-wide keys and r-wide values (576 and
512 at deepseek-v2's widths).  The aggregated-KV decode
(``transformer._attn_decode_aggkv``) buckets that latent cache.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers


class MLA(nn.Module):
    """``w_dq`` [d, qr], ``q_norm`` [qr], ``w_uq`` [qr, H (dn + dr)],
    ``w_dkv`` [d, r], ``kv_norm`` [r], ``w_kr`` [d, dr], ``w_uk`` [r, H dn],
    ``w_uv`` [r, H dv], ``wo`` [H dv, d]."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        self.w_dq = layers.dense_init(init, d, qr)
        self.q_norm = layers.rmsnorm_init(init, qr)
        self.w_uq = layers.dense_init(init, qr, h * (dn + dr))
        self.w_dkv = layers.dense_init(init, d, kvr)
        self.kv_norm = layers.rmsnorm_init(init, kvr)
        self.w_kr = layers.dense_init(init, d, dr)
        self.w_uk = layers.dense_init(init, kvr, h * dn)
        self.w_uv = layers.dense_init(init, kvr, h * dv)
        self.wo = layers.dense_init(init, h * dv, d)


def mla_init(init: layers.Init, cfg) -> MLA:
    return MLA(init, cfg)


def _mla_q(p: MLA, x: torch.Tensor, cfg, positions: torch.Tensor,
           rotation: tuple | None = None):
    """x [B,S,d] -> (q_nope [B,S,H,dn], q_rope [B,S,H,dr]) (RoPE applied,
    with ``rotation`` from ``layers.rope_rotation`` when given)."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q = layers.rmsnorm(x @ p.w_dq, p.q_norm, cfg.norm_eps) @ p.w_uq
    q = q.reshape(b, s, h, dn + dr)
    q_rope = layers.apply_rope(q[..., dn:], positions, cfg.rope_theta,
                               rotation=rotation)
    return q[..., :dn], q_rope


def latent_kv(p: MLA, x: torch.Tensor, cfg, positions: torch.Tensor,
              rotation: tuple | None = None):
    """x [B,S,d] -> (c_kv [B,S,r], k_rope [B,S,dr]): the latent the decode
    caches hold."""
    b, s, _ = x.shape
    c_kv = layers.rmsnorm(x @ p.w_dkv, p.kv_norm, cfg.norm_eps)
    k_rope = layers.apply_rope(
        (x @ p.w_kr).reshape(b, s, 1, cfg.rope_head_dim), positions,
        cfg.rope_theta, rotation=rotation)
    return c_kv, k_rope.reshape(b, s, cfg.rope_head_dim)


def mla_attention(p: MLA, x: torch.Tensor, cfg, *,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (training / prefill).  x [B,S,d]; positions
    [B,S]."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = latent_kv(p, x, cfg, positions)
    k_rope = k_rope[:, :, None]                          # [B,S,1,dr] shared
    k_nope = (c_kv @ p.w_uk).reshape(b, s, h, dn)
    v = (c_kv @ p.w_uv).reshape(b, s, h, dv)
    scale = 1.0 / math.sqrt(dn + dr)

    if s >= layers._BLOCKWISE_THRESHOLD:
        # the shared rope key folded into per-head keys, through the
        # blockwise path: q / k [B,S,H,dn+dr], values [B,S,H,dv]
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        out = layers.blockwise_sdpa(q_full.reshape(b, s, h, 1, dn + dr),
                                    k_full, v, scale=scale, causal=True)
        return out.reshape(b, s, h * dv).to(x.dtype) @ p.wo

    logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bshd,btkd->bhst", q_rope.float(),
                             k_rope.float())) * scale
    mask = layers.causal_mask(s, x.device)[None, None]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.reshape(b, s, h * dv).to(x.dtype) @ p.wo


def absorbed_query(p: MLA, x: torch.Tensor, cfg, pos: torch.Tensor,
                   rotation: tuple | None = None) -> torch.Tensor:
    """One token's query in the latent space: [q_nope W_UK ; q_rope]
    [B,H,r+dr] f32, W_UK absorbed in f32.  x [B,1,d]; pos [B]."""
    h, dn, r = cfg.n_heads, cfg.nope_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None], rotation)
    w_uk = p.w_uk.reshape(r, h, dn).float()
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
    return torch.cat([q_c, q_rope[:, 0].float()], dim=-1)


def absorbed_output(p: MLA, out_c: torch.Tensor, cfg,
                    dtype: torch.dtype) -> torch.Tensor:
    """The latent attention output out_c [B,H,r] f32 through W_UV (f32)
    and ``wo`` -> [B,1,d] in ``dtype``."""
    b = out_c.shape[0]
    h, r, dv = cfg.n_heads, cfg.kv_lora_rank, cfg.v_head_dim
    w_uv = p.w_uv.reshape(r, h, dv).float()
    out = torch.einsum("bhr,rhd->bhd", out_c, w_uv)
    return out.reshape(b, 1, h * dv).to(dtype) @ p.wo


def mla_decode(p: MLA, x: torch.Tensor, cfg, *, cache_c: torch.Tensor,
               cache_kr: torch.Tensor, pos: torch.Tensor,
               rotation: tuple | None = None):
    """Absorbed single-token decode with exact attention.  x [B,1,d];
    cache_c [B,S,r]; cache_kr [B,S,dr]; pos [B].  The new latent is
    written into the caches in place at ``pos``; returns (out [B,1,d],
    cache_c, cache_kr)."""
    b = x.shape[0]
    r = cfg.kv_lora_rank
    c_new, kr_new = latent_kv(p, x, cfg, pos[:, None], rotation)
    rows = torch.arange(b, device=x.device)
    slot = pos.long()
    cache_c[rows, slot] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[rows, slot] = kr_new[:, 0].to(cache_kr.dtype)
    q = absorbed_query(p, x, cfg, pos, rotation)            # [B,H,r+dr]
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    logits = (torch.einsum("bhr,btr->bht", q[..., :r], cache_c.float())
              + torch.einsum("bhd,btd->bht", q[..., r:],
                             cache_kr.float())) * scale
    s_max = cache_c.shape[1]
    valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]
    logits = torch.where(valid[:, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out_c = torch.einsum("bht,btr->bhr", probs, cache_c.float())
    return absorbed_output(p, out_c, cfg, x.dtype), cache_c, cache_kr
