"""One decoder block of the port: its weights, its full-sequence application
(train / prefill), its decode cache and one decode step, as
``src/repro/models/transformer.py`` computes them for ``attn`` blocks:
dense GQA or MLA attention, then a SwiGLU MLP or (past the first
``cfg.first_k_dense`` head blocks of an MoE config) the routed experts.

A block's decode cache is an ``aggregated_kv.AggKVCache`` or
``BucketMajorKVCache`` when ``cfg.agg_kv`` is set (the layout from
``cfg.agg_layout``; an MLA block's holds the latent, one KV head of keys
``[c_kv ; k_rope]`` and values ``c_kv``), and otherwise a dict of the exact
caches (``k`` / ``v``, or MLA's ``c`` / ``kr``).  Decode updates a cache in
place and returns it.  SSM, xLSTM, encoder-decoder, sliding-window and
M-RoPE blocks are not ported yet and raise.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import aggregated_kv, layers, mla, moe


def _check_ported(cfg, kind: str) -> None:
    if kind != "attn" or cfg.is_encoder_decoder or cfg.sliding_window > 0 \
            or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} with encoder-decoder="
            f"{cfg.is_encoder_decoder}, sliding_window={cfg.sliding_window}, "
            f"mrope={cfg.mrope} is not ported yet (only attn blocks, GQA or "
            "MLA, with an MLP or MoE, are)")


def _block_has_moe(cfg, *, is_head: bool) -> bool:
    return cfg.n_experts > 0 and not is_head


class Block(nn.Module):
    """norm1, attn (GQA or MLA), and norm2 with the MoE or the MLP."""

    def __init__(self, init: layers.Init, cfg, kind: str, *,
                 is_head: bool = False):
        super().__init__()
        _check_ported(cfg, kind)
        d = cfg.d_model
        self.norm1 = layers.rmsnorm_init(init, d)
        self.attn = (mla.mla_init(init, cfg) if cfg.mla
                     else layers.attention_init(init, cfg))
        if _block_has_moe(cfg, is_head=is_head):
            self.norm2 = layers.rmsnorm_init(init, d)
            self.moe = moe.moe_init(init, cfg)
        elif cfg.d_ff > 0:
            self.norm2 = layers.rmsnorm_init(init, d)
            self.mlp = layers.mlp_init(init, d, cfg.d_ff)


def block_init(init: layers.Init, cfg, kind: str, *,
               is_head: bool = False) -> Block:
    """The weights of one block of the given kind; a head block
    (``is_head``) keeps the dense MLP in an MoE config."""
    return Block(init, cfg, kind, is_head=is_head)


def _ffn_apply(p: Block, x: torch.Tensor, cfg) -> torch.Tensor:
    if hasattr(p, "moe"):
        h = layers.rmsnorm(x, p.norm2, cfg.norm_eps)
        return x + moe.moe_dense(p.moe, h, cfg)
    if hasattr(p, "mlp"):
        h = layers.rmsnorm(x, p.norm2, cfg.norm_eps)
        return x + layers.mlp(p.mlp, h)
    return x


def block_apply(p: Block, x: torch.Tensor, cfg, kind: str, *,
                positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Full-sequence application of one block (train / prefill): norm1,
    attention, the residual, then the feed-forward.  x [B,S,d]; positions
    [B,S]."""
    _check_ported(cfg, kind)
    h = layers.rmsnorm(x, p.norm1, cfg.norm_eps)
    if cfg.mla:
        a = mla.mla_attention(p.attn, h, cfg, positions=positions)
    else:
        a = layers.attention(p.attn, h, cfg, positions=positions,
                             causal=causal)
    return _ffn_apply(p, x + a, cfg)


def cache_dims(cfg) -> tuple[int, int, int]:
    """(KV heads, key width, value width) of a block's decode cache: the
    latent's (1, kv_lora_rank + rope_head_dim, kv_lora_rank) for MLA."""
    if cfg.mla:
        return 1, cfg.kv_lora_rank + cfg.rope_head_dim, cfg.kv_lora_rank
    return cfg.n_kv_heads, cfg.head_dim, cfg.head_dim


def rope_dim(cfg) -> int:
    """The width RoPE rotates: MLA's rope part, else the head."""
    return cfg.rope_head_dim if cfg.mla else cfg.head_dim


def init_block_cache(cfg, kind: str, *, batch: int, s_max: int,
                     dtype: torch.dtype, device: torch.device,
                     lsh: tuple[torch.Tensor, torch.Tensor] | None = None):
    """An empty decode cache of one block.  ``lsh`` = (a, b) is the layer's
    LSH draws, needed with ``cfg.agg_kv``."""
    _check_ported(cfg, kind)
    n_kv, dk, dv = cache_dims(cfg)
    if cfg.agg_kv:
        if lsh is None:
            raise ValueError("an aggregated cache needs the layer's LSH draws")
        agg_init = (aggregated_kv.init_bucket_major
                    if cfg.agg_layout == "bucket_major"
                    else aggregated_kv.init_cache)
        return agg_init(lsh, batch=batch, s_max=s_max, n_kv=n_kv, dk=dk,
                        dv=dv, compression=cfg.agg_compression, dtype=dtype)
    if cfg.mla:
        return {"c": torch.zeros((batch, s_max, cfg.kv_lora_rank),
                                 dtype=dtype, device=device),
                "kr": torch.zeros((batch, s_max, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}
    shape = (batch, s_max, n_kv, dk)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attend(cfg, q, cache, pos, scale):
    """Two-stage attention over an aggregated cache in its layout.  q
    [B,H,dk] -> [B,H,dv] f32."""
    if cfg.agg_layout == "bucket_major":
        return aggregated_kv.decode_attend_bucket_major(
            q, cache, refine_frac=cfg.agg_refine_frac, scale=scale)
    return aggregated_kv.decode_attend(
        q, cache, pos, refine_frac=cfg.agg_refine_frac, scale=scale)


def _insert(cfg, cache, key, value, pos) -> None:
    if cfg.agg_layout == "bucket_major":
        aggregated_kv.insert_bucket_major(cache, key, value)
    else:
        aggregated_kv.insert(cache, key, value, pos)


def _attn_decode_aggkv(p: Block, h: torch.Tensor, cfg, cache, pos,
                       rotation=None):
    """Aggregated-KV decode: insert the new token, then two-stage attention
    over the cache.  MLA attends in the latent space: key [c ; k_rope],
    value c, the query absorbed through W_UK and the output through
    W_UV."""
    b = h.shape[0]
    if cfg.mla:
        c_new, kr_new = mla.latent_kv(p.attn, h, cfg, pos[:, None], rotation)
        key = torch.cat([c_new[:, 0], kr_new[:, 0]], dim=-1)[:, None]
        _insert(cfg, cache, key, c_new[:, 0][:, None], pos)
        q = mla.absorbed_query(p.attn, h, cfg, pos, rotation)
        scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
        out_c = _attend(cfg, q, cache, pos, scale)          # [B,H,r]
        return mla.absorbed_output(p.attn, out_c, cfg, h.dtype), cache
    q, k_new, v_new = layers._project_qkv(p.attn, h, cfg, pos[:, None],
                                          rotation)
    _insert(cfg, cache, k_new[:, 0], v_new[:, 0], pos)
    out = _attend(cfg, q[:, 0], cache, pos, 1.0 / math.sqrt(cfg.head_dim))
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(h.dtype)
    return out @ p.attn.wo, cache


def block_decode(p: Block, x: torch.Tensor, cfg, kind: str, cache, pos,
                 rotation=None):
    """One decode step.  x [B,1,d]; pos [B]; ``rotation`` the step's RoPE
    (cos, sin) over ``rope_dim(cfg)`` when the caller has it.  Returns (x,
    cache)."""
    h = layers.rmsnorm(x, p.norm1, cfg.norm_eps)
    if cfg.agg_kv:
        a, cache = _attn_decode_aggkv(p, h, cfg, cache, pos, rotation)
    elif cfg.mla:
        a, _, _ = mla.mla_decode(p.attn, h, cfg, cache_c=cache["c"],
                                 cache_kr=cache["kr"], pos=pos,
                                 rotation=rotation)
    else:
        a, _, _ = layers.attention_decode(
            p.attn, h, cfg, cache_k=cache["k"], cache_v=cache["v"], pos=pos,
            rotation=rotation)
    return _ffn_apply(p, x + a, cfg), cache
