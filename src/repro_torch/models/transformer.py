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

``ParallelContext`` says how a block uses a mesh (``NO_PARALLEL``: one
device).  Under an active context a block's activations are this rank's
block of the batch over the data axes, replicated over the model axis, and
the JAX package's GSPMD placements become explicit collectives
(``parallel.collectives``):

  * attention whose projections hold this rank's heads only (a sharded
    train step's weights, ``parallel.sharding.local_views``) runs those
    heads and sums the output projection's parts over the model axis; an
    MLP whose hidden width is this rank's slice likewise;
  * with ``use_ep`` an MoE block runs its experts over the model axis
    (``_moe_ep_local``: the sequence-sharded ``moe_ep`` / ``moe_ep_a2a``
    arm, or the decode arm's replicated tokens and summed experts);
    ``_moe_ep_sharded`` is the same on a whole ``[B, S, d]``, as the JAX
    package's ``shard_map`` takes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch.models import aggregated_kv, layers, mla, moe, ssm, xlstm
from repro_torch.parallel import collectives

ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")
MIXERS = {"mamba": (ssm.mamba_init, ssm.mamba_block),
          "mlstm": (xlstm.mlstm_init, xlstm.mlstm_block),
          "slstm": (xlstm.slstm_init, xlstm.slstm_block)}


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """How model code uses the mesh (a ``DeviceMesh``; None = one
    device)."""

    mesh: Any = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    use_ep: bool = False             # expert-parallel MoE over model
    seq_shard_moe: bool = True       # slice sequence over model axis in MoE
    pure_dp: bool = False            # model axis folded into data (xlstm)

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def size(self, axis: str) -> int:
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    @property
    def batch_axes(self) -> tuple:
        """The mesh axes the batch is sharded over, in mesh order."""
        if self.pure_dp:
            return tuple(self.mesh.mesh_dim_names)
        return tuple(a for a in self.mesh.mesh_dim_names
                     if a in self.data_axes)

    @property
    def data_size(self) -> int:
        return math.prod(self.size(a) for a in self.batch_axes)

    @property
    def tp_group(self):
        """The model axis's group where it splits work, else None."""
        if not self.active or self.pure_dp or self.size(self.model_axis) < 2:
            return None
        return self.group(self.model_axis)


NO_PARALLEL = ParallelContext()


def data_slice(x: torch.Tensor, parallel: ParallelContext,
               dim: int = 0) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor replicated over the mesh,
    over the batch axes (the first outermost); differentiable."""
    for axis in parallel.batch_axes:
        x = collectives.scatter_replicated(x, parallel.group(axis), dim)
    return x


def data_gather(x: torch.Tensor, parallel: ParallelContext,
                dim: int = 0) -> torch.Tensor:
    """The inverse of ``data_slice``: the whole of ``dim`` on every rank."""
    for axis in reversed(parallel.batch_axes):
        x = collectives.gather_replicated(x, parallel.group(axis), dim)
    return x


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


def _ffn_apply(p: Block, x: torch.Tensor, cfg,
               parallel: ParallelContext = NO_PARALLEL) -> torch.Tensor:
    if hasattr(p, "moe"):
        h = layers.rmsnorm(x, p.norm2, cfg.norm_eps)
        if parallel.active and parallel.use_ep:
            return x + _moe_ep_local(p.moe, h, cfg, parallel)
        return x + moe.moe_dense(p.moe, h, cfg)
    if hasattr(p, "mlp"):
        h = layers.rmsnorm(x, p.norm2, cfg.norm_eps)
        ffn = layers.gelu_mlp if cfg.is_encoder_decoder else layers.mlp
        g = parallel.tp_group
        if g is not None and p.mlp.w_up.shape[1] != cfg.d_ff:
            # this rank's slice of the hidden width: its part of the output
            return x + collectives.reduce_from(
                ffn(p.mlp, collectives.copy_to(h, g)), g)
        return x + ffn(p.mlp, h)
    return x


def _moe_ep_local(pm, x: torch.Tensor, cfg,
                  parallel: ParallelContext) -> torch.Tensor:
    """Expert-parallel MoE over the model axis on this rank's block of the
    batch [B, S, d] (replicated over the model axis): where the sequence
    divides by the axis, each rank's slice of it through ``moe_ep`` (or
    ``moe_ep_a2a`` under ``moe_dispatch="all_to_all"``), gathered back;
    otherwise (decode) every rank computes its experts over all the tokens
    and the parts are summed."""
    g = parallel.group(parallel.model_axis)
    tp = parallel.size(parallel.model_axis)
    local = moe.local_experts(pm, cfg, g)
    b, s, d = x.shape
    if parallel.seq_shard_moe and s % tp == 0 and s >= tp:
        ep_fn = (moe.moe_ep_a2a if cfg.moe_dispatch == "all_to_all"
                 else moe.moe_ep)
        xl = collectives.scatter_replicated(x, g, dim=1)
        out = ep_fn(local, xl.reshape(-1, d), cfg, axis_name=g)
        return collectives.gather_replicated(out.reshape(xl.shape), g, dim=1)
    flat = collectives.copy_to(x.reshape(b * s, d), g)
    e_loc = cfg.n_experts // tp
    out = moe.moe_apply_local(
        local, flat.float(), cfg,
        experts_slice=(collectives.rank(g) * e_loc, e_loc))
    if cfg.n_shared_experts > 0 and collectives.rank(g) == 0:
        # the shared experts once, in the first rank's part: every rank's
        # part is then its own (the router's, the shared weights' gradient
        # summed over the axis, as in the sequence arm)
        out = out + layers.mlp(local.shared, flat).float()
    return collectives.reduce_from(out, g).reshape(b, s, d).to(x.dtype)


def _moe_ep_sharded(pm, x: torch.Tensor, cfg,
                    parallel: ParallelContext) -> torch.Tensor:
    """Expert-parallel MoE on a whole [B, S, d] (the same on every rank),
    returning the whole output as ``moe_dense`` does: this rank's block of
    the batch over the data axes through ``_moe_ep_local``, gathered back.
    A batch that does not divide (decode at batch 1) is replicated over the
    data axes as well; the sequence arm then has no block to give and
    raises, as ``shard_map`` does."""
    b, s, _ = x.shape
    dsz = parallel.data_size
    if b % dsz == 0 and b >= dsz:
        return data_gather(_moe_ep_local(pm, data_slice(x, parallel), cfg,
                                         parallel), parallel)
    tp = parallel.size(parallel.model_axis)
    if parallel.seq_shard_moe and s % tp == 0 and s >= tp:
        raise ValueError(f"shard_map: batch {b} does not divide by the data "
                         f"axes' {dsz} ranks")
    return _moe_ep_local(pm, x, cfg, parallel)


def _attention(p: Block, h: torch.Tensor, cfg, parallel: ParallelContext,
               **kw) -> torch.Tensor:
    """Full-sequence GQA attention; projections that hold this rank's heads
    only run those heads (under a config with the local head counts) and
    sum the output projection's parts over the model axis."""
    g = parallel.tp_group
    if g is None or p.attn.wq.shape[-1] == cfg.n_heads * cfg.head_dim:
        return layers.attention(p.attn, h, cfg, **kw)
    tp = collectives.size(g)
    local_cfg = cfg.with_(n_heads=cfg.n_heads // tp,
                          n_kv_heads=cfg.n_kv_heads // tp)
    out = layers.attention(p.attn, collectives.copy_to(h, g), local_cfg, **kw)
    return collectives.reduce_from(out, g)


def block_apply(p: Block, x: torch.Tensor, cfg, kind: str, *,
                positions: torch.Tensor, causal: bool = True,
                parallel: ParallelContext = NO_PARALLEL,
                mrope_positions: torch.Tensor | None = None,
                memory: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence application of one block (train / prefill).  x
    [B,S,d]; positions [B,S]; ``mrope_positions`` [3,B,S]; ``memory``
    [B,T,d] the encoder's output, which an encoder-decoder block attends
    to after its self-attention.  Under an active ``parallel`` x is this
    rank's block of the batch (module docstring)."""
    h = layers.rmsnorm(x, p.norm1, cfg.norm_eps)
    if kind in MIXERS:
        return x + MIXERS[kind][1](p.mixer, h, cfg)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    if cfg.mla:
        a = mla.mla_attention(p.attn, h, cfg, positions=positions)
    else:
        a = _attention(
            p, h, cfg, parallel, positions=positions, causal=causal,
            window=cfg.sliding_window if is_ring(cfg, kind) else None,
            mrope_positions=mrope_positions)
    x = x + a
    if memory is not None and hasattr(p, "cross"):
        x = x + layers.cross_attention(
            p.cross, layers.rmsnorm(x, p.cross_norm, cfg.norm_eps), memory,
            cfg)
    return _ffn_apply(p, x, cfg, parallel)


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
                 rotation=None, *, parallel: ParallelContext = NO_PARALLEL,
                 mrope_positions=None, memory_kv=None):
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
    return _ffn_apply(p, x, cfg, parallel), cache


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
