"""One decoder block of the port: its weights, its full-sequence application
(train / prefill), its decode cache and one decode step, as
``src/repro/models/transformer.py`` computes them for the dense GQA stack
(``attn`` blocks with a SwiGLU MLP).

A block's decode cache is an ``aggregated_kv.AggKVCache`` or
``BucketMajorKVCache`` when ``cfg.agg_kv`` is set (the layout from
``cfg.agg_layout``), and otherwise a dict of the exact ``k`` / ``v`` caches.
Decode updates a cache in place and returns it.  MLA, MoE, SSM, xLSTM and
cross-attention blocks are not ported yet and raise.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import aggregated_kv, layers


def _check_ported(cfg, kind: str) -> None:
    if kind != "attn" or cfg.mla or cfg.n_experts > 0 \
            or cfg.is_encoder_decoder or cfg.sliding_window > 0:
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} with mla={cfg.mla}, "
            f"n_experts={cfg.n_experts}, encoder-decoder="
            f"{cfg.is_encoder_decoder}, sliding_window={cfg.sliding_window} "
            "is not ported yet (only dense GQA attention blocks are)")


class Block(nn.Module):
    """norm1, attn, and norm2 + mlp where ``cfg.d_ff > 0``."""

    def __init__(self, init: layers.Init, cfg, kind: str):
        super().__init__()
        _check_ported(cfg, kind)
        d = cfg.d_model
        self.norm1 = layers.rmsnorm_init(init, d)
        self.attn = layers.attention_init(init, cfg)
        if cfg.d_ff > 0:
            self.norm2 = layers.rmsnorm_init(init, d)
            self.mlp = layers.mlp_init(init, d, cfg.d_ff)


def block_init(init: layers.Init, cfg, kind: str) -> Block:
    """The weights of one block of the given kind."""
    return Block(init, cfg, kind)


def _ffn_apply(p: Block, x: torch.Tensor, cfg) -> torch.Tensor:
    if not hasattr(p, "mlp"):
        return x
    h = layers.rmsnorm(x, p.norm2, cfg.norm_eps)
    return x + layers.mlp(p.mlp, h)


def block_apply(p: Block, x: torch.Tensor, cfg, kind: str, *,
                positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Full-sequence application of one block (train / prefill): norm1,
    attention, the residual, then the feed-forward.  x [B,S,d]; positions
    [B,S]."""
    _check_ported(cfg, kind)
    h = layers.rmsnorm(x, p.norm1, cfg.norm_eps)
    x = x + layers.attention(p.attn, h, cfg, positions=positions,
                             causal=causal)
    return _ffn_apply(p, x, cfg)


def init_block_cache(cfg, kind: str, *, batch: int, s_max: int,
                     dtype: torch.dtype, device: torch.device,
                     lsh: tuple[torch.Tensor, torch.Tensor] | None = None):
    """An empty decode cache of one block.  ``lsh`` = (a, b) is the layer's
    LSH draws, needed with ``cfg.agg_kv``."""
    _check_ported(cfg, kind)
    if cfg.agg_kv:
        if lsh is None:
            raise ValueError("an aggregated cache needs the layer's LSH draws")
        agg_init = (aggregated_kv.init_bucket_major
                    if cfg.agg_layout == "bucket_major"
                    else aggregated_kv.init_cache)
        return agg_init(lsh, batch=batch, s_max=s_max, n_kv=cfg.n_kv_heads,
                        dk=cfg.head_dim, compression=cfg.agg_compression,
                        dtype=dtype)
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_decode_aggkv(p: Block, h: torch.Tensor, cfg, cache, pos,
                       rotation=None):
    """Aggregated-KV decode: insert the new token, then two-stage attention
    over the cache."""
    b = h.shape[0]
    q, k_new, v_new = layers._project_qkv(p.attn, h, cfg, pos[:, None],
                                          rotation)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if cfg.agg_layout == "bucket_major":
        aggregated_kv.insert_bucket_major(cache, k_new[:, 0], v_new[:, 0])
        out = aggregated_kv.decode_attend_bucket_major(
            q[:, 0], cache, refine_frac=cfg.agg_refine_frac, scale=scale)
    else:
        aggregated_kv.insert(cache, k_new[:, 0], v_new[:, 0], pos)
        out = aggregated_kv.decode_attend(
            q[:, 0], cache, pos, refine_frac=cfg.agg_refine_frac, scale=scale)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(h.dtype)
    return out @ p.attn.wo, cache


def block_decode(p: Block, x: torch.Tensor, cfg, kind: str, cache, pos,
                 rotation=None):
    """One decode step.  x [B,1,d]; pos [B]; ``rotation`` the step's RoPE
    (cos, sin) when the caller has it.  Returns (x, cache)."""
    h = layers.rmsnorm(x, p.norm1, cfg.norm_eps)
    if cfg.agg_kv:
        a, cache = _attn_decode_aggkv(p, h, cfg, cache, pos, rotation)
    else:
        a, _, _ = layers.attention_decode(
            p.attn, h, cfg, cache_k=cache["k"], cache_v=cache["v"], pos=pos,
            rotation=rotation)
    return _ffn_apply(p, x + a, cfg), cache
