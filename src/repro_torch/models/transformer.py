"""One block of the port: its weights, its full-sequence application
(train / prefill), its decode cache and one decode step, as
``src/repro/models/transformer.py`` computes them, for every block kind:

  * ``attn``, ``attn_local``, ``attn_global`` and ``shared_attn``: dense
    GQA or MLA attention (a sliding window for ``attn_local`` when the
    config has one; M-RoPE with ``mrope_positions``), under
    ``is_encoder_decoder`` a cross-attention sub-block, then a SwiGLU MLP
    (GELU under ``is_encoder_decoder``) or, past the first
    ``cfg.first_k_dense`` head blocks of an MoE config, the routed
    experts;
  * ``mamba`` (Mamba2, ``ssm.py``), ``mlstm`` and ``slstm``
    (``xlstm.py``): norm1 and the mixer, with a residual.

An attention block's decode cache is an ``aggregated_kv.AggKVCache`` or
``BucketMajorKVCache`` when ``cfg.agg_kv`` is set (the layout from
``cfg.agg_layout``; an MLA block's holds the latent, one KV head of keys
``[c_kv ; k_rope]`` and values ``c_kv``), and otherwise a dict of the exact
caches (``k`` / ``v``, or MLA's ``c`` / ``kr``).  A sliding-window block
keeps an exact ring buffer of ``min(s_max, sliding_window)`` slots, with or
without ``agg_kv``.  A Mamba2 block's cache is its conv windows and state,
an xLSTM block's its recurrent state.  Decode updates a cache in place and
returns it.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import aggregated_kv, layers, mla, moe, ssm, xlstm

ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")
MIXERS = {"mamba": (ssm.mamba_init, ssm.mamba_block),
          "mlstm": (xlstm.mlstm_init, xlstm.mlstm_block),
          "slstm": (xlstm.slstm_init, xlstm.slstm_block)}


def _block_has_moe(cfg, *, is_head: bool) -> bool:
    return cfg.n_experts > 0 and not is_head


def is_ring(cfg, kind: str) -> bool:
    """Whether a block attends over a sliding window (``attn_local`` in a
    config that has one): its decode cache is an exact ring buffer."""
    return kind == "attn_local" and cfg.sliding_window > 0


def aggregatable(cfg, kind: str) -> bool:
    """Whether a block's decode cache is aggregated when ``cfg.agg_kv`` is
    set: every attention block but a sliding-window one."""
    return kind in ATTN_KINDS and not is_ring(cfg, kind)


def uses_agg(cfg, kind: str) -> bool:
    """Whether a block decodes over an aggregated cache under ``cfg``."""
    return cfg.agg_kv and aggregatable(cfg, kind)


class Block(nn.Module):
    """An attention block's norm1, attn (GQA or MLA), cross_norm and cross
    (encoder-decoder), and norm2 with the MoE or the MLP; a recurrent
    block's norm1 and mixer."""

    def __init__(self, init: layers.Init, cfg, kind: str, *,
                 is_head: bool = False):
        super().__init__()
        d = cfg.d_model
        self.norm1 = layers.rmsnorm_init(init, d)
        if kind in MIXERS:
            self.mixer = MIXERS[kind][0](init, cfg)
            return
        if kind not in ATTN_KINDS:
            raise ValueError(f"unknown block kind {kind}")
        self.attn = (mla.mla_init(init, cfg) if cfg.mla
                     else layers.attention_init(init, cfg))
        if cfg.is_encoder_decoder:
            self.cross_norm = layers.rmsnorm_init(init, d)
            self.cross = layers.cross_attention_init(init, cfg)
        if _block_has_moe(cfg, is_head=is_head):
            self.norm2 = layers.rmsnorm_init(init, d)
            self.moe = moe.moe_init(init, cfg)
        elif cfg.d_ff > 0:
            self.norm2 = layers.rmsnorm_init(init, d)
            self.mlp = (layers.gelu_mlp_init(init, d, cfg.d_ff)
                        if cfg.is_encoder_decoder
                        else layers.mlp_init(init, d, cfg.d_ff))


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
        ffn = layers.gelu_mlp if cfg.is_encoder_decoder else layers.mlp
        return x + ffn(p.mlp, h)
    return x


def block_apply(p: Block, x: torch.Tensor, cfg, kind: str, *,
                positions: torch.Tensor, causal: bool = True,
                mrope_positions: torch.Tensor | None = None,
                memory: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence application of one block (train / prefill).  x
    [B,S,d]; positions [B,S]; ``mrope_positions`` [3,B,S]; ``memory``
    [B,T,d] the encoder's output, which an encoder-decoder block attends
    to after its self-attention."""
    h = layers.rmsnorm(x, p.norm1, cfg.norm_eps)
    if kind in MIXERS:
        return x + MIXERS[kind][1](p.mixer, h, cfg)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    if cfg.mla:
        a = mla.mla_attention(p.attn, h, cfg, positions=positions)
    else:
        a = layers.attention(
            p.attn, h, cfg, positions=positions, causal=causal,
            window=cfg.sliding_window if is_ring(cfg, kind) else None,
            mrope_positions=mrope_positions)
    x = x + a
    if memory is not None and hasattr(p, "cross"):
        x = x + layers.cross_attention(
            p.cross, layers.rmsnorm(x, p.cross_norm, cfg.norm_eps), memory,
            cfg)
    return _ffn_apply(p, x, cfg)


def cache_dims(cfg) -> tuple[int, int, int]:
    """(KV heads, key width, value width) of an attention block's decode
    cache: the latent's (1, kv_lora_rank + rope_head_dim, kv_lora_rank)
    for MLA."""
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
    LSH draws, needed where the cache is aggregated (``uses_agg``)."""
    if kind == "mamba":
        return ssm.empty_state(cfg, batch, dtype=dtype, device=device)
    if kind == "mlstm":
        return xlstm.mlstm_empty_state(batch, cfg, device=device)
    if kind == "slstm":
        return xlstm.slstm_empty_state(batch, cfg, device=device)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    n_kv, dk, dv = cache_dims(cfg)
    if uses_agg(cfg, kind):
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
    slots = min(s_max, cfg.sliding_window) if is_ring(cfg, kind) else s_max
    shape = (batch, slots, n_kv, dk)
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
    value c, the query absorbed through W_UK and the output through W_UV.
    RoPE is the standard one here, M-RoPE config or not, as in the JAX
    package."""
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
                 rotation=None, *, mrope_positions=None, memory_kv=None):
    """One decode step.  x [B,1,d]; pos [B]; ``rotation`` the step's
    standard RoPE (cos, sin) over ``rope_dim(cfg)`` when the caller has it;
    ``mrope_positions`` [3,B,1] (the exact attention path rotates by them,
    the aggregated one does not, as in the JAX package); ``memory_kv`` the
    block's cross-attention (K, V) [B,T,H,hd] each.  Returns (x, cache)."""
    h = layers.rmsnorm(x, p.norm1, cfg.norm_eps)
    if kind == "mamba":
        return x + ssm.mamba_decode(p.mixer, h, cfg, cache), cache
    if kind == "mlstm":
        return x + xlstm.mlstm_decode(p.mixer, h, cfg, cache), cache
    if kind == "slstm":
        return x + xlstm.slstm_decode(p.mixer, h, cfg, cache), cache
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    if uses_agg(cfg, kind):
        a, cache = _attn_decode_aggkv(p, h, cfg, cache, pos, rotation)
    elif cfg.mla:
        a, _, _ = mla.mla_decode(p.attn, h, cfg, cache_c=cache["c"],
                                 cache_kr=cache["kr"], pos=pos,
                                 rotation=rotation)
    else:
        mrope = cfg.mrope and mrope_positions is not None
        a, _, _ = layers.attention_decode(
            p.attn, h, cfg, cache_k=cache["k"], cache_v=cache["v"], pos=pos,
            write_pos=(pos % cache["k"].shape[1] if is_ring(cfg, kind)
                       else None),
            rotation=None if mrope else rotation,
            mrope_positions=mrope_positions)
    x = x + a
    if memory_kv is not None and hasattr(p, "cross"):
        x = x + _cross_decode(p, layers.rmsnorm(x, p.cross_norm,
                                                cfg.norm_eps), memory_kv, cfg)
    return _ffn_apply(p, x, cfg), cache


def _cross_decode(p: Block, h: torch.Tensor, memory_kv, cfg) -> torch.Tensor:
    """Cross-attention during decode against precomputed encoder K / V
    [B,T,H,hd] (no mask: every slot is attended)."""
    k_mem, v_mem = memory_kv
    b = h.shape[0]
    hh, hd = cfg.n_heads, cfg.head_dim
    q = (h @ p.cross.wq).reshape(b, 1, hh, hd)
    logits = torch.einsum("bshd,bthd->bhst", q.float(),
                          k_mem.float()) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v_mem.float())
    return out.reshape(b, 1, hh * hd).to(h.dtype) @ p.cross.wo
