"""The port's model API: ``init_params``, ``forward``, ``loss_fn``,
``prefill``, ``init_caches`` and ``serve_step``, as
``src/repro/models/model.py`` defines them.

The parameters are an ``LM`` module: the embedding, the final norm, the
LM head, the ``shared_attn`` block (zamba2: one weight set that every
``shared_attn`` slot of the stack applies), a ``ModuleList`` of blocks in
stack order (head blocks, the repeated pattern units, tail blocks; each
``shared_attn`` slot holds the one shared module) and, for an
encoder-decoder config, the ``encoder`` (its blocks and final norm).  The
JAX package's ``lax.scan`` over stacked units becomes a loop over the
list.

The decode caches are a list in the same order, one a block (a shared
block has a cache of its own at each slot); an encoder-decoder config's
entries are dicts ``{"self": the block's cache, "cross": (K, V)}``, the
cross-attention's zero-initialised memory caches, as the JAX package's
``init_caches`` makes them (nothing there fills them from the encoder).

``param_tree`` names the parameters for the optimizer and the
checkpointer, the shared block once, as ``shared_attn.*`` (its gradient
sums over its slots); ``convert`` maps that to the JAX package's tree.

``forward``, ``loss_fn``, ``prefill`` and ``serve_step`` take ``parallel``
(``transformer.ParallelContext``).  Under an active context the tokens are
this rank's block of the batch over the data axes (the step factories of
``launch/train.py`` cut it), the weights this rank's views
(``parallel.sharding.local_views``), and the JAX package's two sharding
constraints become DTensor activations: between blocks ``[B, S, d]`` is
placed ``(data, model, None)`` (``_constrain_seq``: this rank's slice of
the sequence, the next block gathering it back) and the logits ``(data,
None, model)`` (``_constrain_bsv``); ``loss_fn`` returns the whole batch's
loss on every rank.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import aggregated_kv, layers, transformer
from repro_torch.models.transformer import NO_PARALLEL, ParallelContext
from repro_torch.parallel import collectives


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 256 (padded ids are masked out of
    the logits)."""
    return -(-cfg.vocab_size // 256) * 256


def _mask_pad_logits(logits: torch.Tensor, cfg) -> torch.Tensor:
    v = logits.shape[-1]
    if v == cfg.vocab_size:
        return logits
    live = torch.arange(v, device=logits.device) < cfg.vocab_size
    return torch.where(live, logits, -1e30)


def _stack_layout(cfg):
    """(head_kinds, pattern, n_units, tail_kinds) of the decoder stack."""
    kinds = cfg.block_kinds()
    head = kinds[: cfg.first_k_dense]
    rest = kinds[cfg.first_k_dense:]
    pat = tuple(cfg.pattern)
    n_units = len(rest) // len(pat)
    tail = rest[n_units * len(pat):]
    return head, pat, n_units, tail


def block_kinds(cfg) -> list[str]:
    """The kind of every block, in stack order."""
    head, pat, n_units, tail = _stack_layout(cfg)
    return [*head, *(list(pat) * n_units), *tail]


def _sinusoidal(positions: torch.Tensor, d: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Whisper-style sinusoidal position embedding, computed in float32 and
    cast to ``dtype``: positions [B,S] -> [B,S,d]."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


class Encoder(nn.Module):
    """Whisper's encoder weights: ``blocks`` (``attn`` blocks, with the
    cross-attention weights that every block of an encoder-decoder config
    carries and the encoder never reads) and ``final_norm``."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        self.blocks = nn.ModuleList(
            transformer.block_init(init, cfg, "attn")
            for _ in range(cfg.n_encoder_layers))
        self.final_norm = layers.rmsnorm_init(init, cfg.d_model)


class LM(nn.Module):
    """Language model weights: ``embed`` [V_pad, d], ``final_norm`` [d],
    ``lm_head`` [d, V_pad] (unless tied), ``shared_attn`` (where the
    pattern has shared-attention slots; registered before ``blocks``, so
    ``named_parameters`` names it there), ``blocks`` (the first
    ``cfg.first_k_dense`` are head blocks, with a dense MLP in an MoE
    config) and ``encoder`` (encoder-decoder configs)."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        vpad = padded_vocab(cfg)
        self.kinds = block_kinds(cfg)
        self.embed = init.normal((vpad, cfg.d_model), 0.02)
        self.final_norm = layers.rmsnorm_init(init, cfg.d_model)
        if not cfg.tie_embeddings:
            self.lm_head = layers.dense_init(init, cfg.d_model, vpad)
        if "shared_attn" in self.kinds:
            self.shared_attn = transformer.block_init(init, cfg,
                                                      "shared_attn")
        n_head = cfg.first_k_dense
        self.blocks = nn.ModuleList(
            self.shared_attn if kind == "shared_attn"
            else transformer.block_init(init, cfg, kind, is_head=i < n_head)
            for i, kind in enumerate(self.kinds))
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(init, cfg)


def init_params(cfg, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> LM:
    """Random weights in the config's dtype on ``device``, drawn from
    ``generator`` on its own device (give a generator on the card to draw
    there)."""
    init = layers.Init(generator, dtype=layers.torch_dtype(cfg.dtype),
                       device=resolve(device))
    return LM(init, cfg)


def param_tree(model: LM) -> dict[str, torch.Tensor]:
    """The model's parameters by name (``blocks.0.attn.wq``...), the tree
    the optimizer's state mirrors."""
    return dict(model.named_parameters())


def load_param_tree(model: LM, params: dict[str, torch.Tensor]) -> None:
    """Point each of the model's parameters at the tensor of its name in
    ``params`` (no copy), e.g. a restored checkpoint's."""
    for name, p in param_tree(model).items():
        t = params[name]
        if t.shape != p.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(p.shape)}")
        p.data = t.detach()


def _encode(model: LM, frames: torch.Tensor, cfg,
            parallel: ParallelContext = NO_PARALLEL) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings [B, S_enc, d]:
    sinusoidal positions, non-causal blocks, the final norm."""
    bsz, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device)[None].expand(bsz, s)
    x = frames + _sinusoidal(pos, cfg.d_model, frames.dtype)
    for blk in model.encoder.blocks:
        x = transformer.block_apply(blk, x, cfg, "attn", positions=pos,
                                    causal=False, parallel=parallel)
    return layers.rmsnorm(x, model.encoder.final_norm, cfg.norm_eps)


def _placements(parallel: ParallelContext, dim: int | None) -> list:
    """A batch-sharded activation's DTensor placements: ``Shard(0)`` on
    the batch axes, ``Shard(dim)`` on the model axis (``Replicate()`` for
    None)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if a in parallel.batch_axes
            else Shard(dim) if a == parallel.model_axis and dim is not None
            else Replicate()
            for a in parallel.mesh.mesh_dim_names]


def _constrain(x: torch.Tensor, parallel: ParallelContext, dim: int):
    """This rank's block of the batch, replicated over the model axis ->
    the DTensor whose local part is its slice of ``dim`` over the model
    axis (the gradient gathers the slices back)."""
    from torch.distributed.tensor import DTensor

    g = parallel.group(parallel.model_axis)
    return DTensor.from_local(collectives.scatter_replicated(x, g, dim),
                              parallel.mesh, _placements(parallel, dim),
                              run_check=False)


def _unconstrain(x, parallel: ParallelContext) -> torch.Tensor:
    """The inverse of ``_constrain``: a DTensor of ``_constrain`` -> this
    rank's block of the batch, whole over the model axis; a plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    dim = x.placements[parallel.mesh.mesh_dim_names.index(
        parallel.model_axis)].dim
    return collectives.gather_replicated(
        x.to_local(), parallel.group(parallel.model_axis), dim)


def _constrain_seq(x: torch.Tensor, parallel: ParallelContext):
    """Megatron-SP-style placement between blocks: [B,S,d] over (data,
    model, None), each rank holding its slice of the sequence; the JAX
    package's ``with_sharding_constraint``.  Without an active context (or
    under ``pure_dp``, or a sequence that does not divide) x as it is."""
    if not parallel.active or parallel.pure_dp:
        return x
    tp = parallel.size(parallel.model_axis)
    if x.shape[1] % tp or x.shape[1] < tp:
        return x
    return _constrain(x, parallel, 1)


def _constrain_bsv(x: torch.Tensor, parallel: ParallelContext):
    """[B, S, V] logits over (data, None, model) where V divides by the
    model axis (not under ``pure_dp``); else x as it is."""
    if not parallel.active or parallel.pure_dp:
        return x
    if x.shape[-1] % parallel.size(parallel.model_axis):
        return x
    return _constrain(x, parallel, 2)


def forward(model: LM, tokens: torch.Tensor, cfg, *,
            parallel: ParallelContext = NO_PARALLEL,
            mrope_positions: torch.Tensor | None = None,
            frames: torch.Tensor | None = None,
            remat: bool = False) -> torch.Tensor:
    """Logits [B, S, V_pad] over the full sequence.  tokens: [B, S] int;
    ``mrope_positions`` [3, B, S] (M-RoPE configs; without them RoPE is
    the standard one); ``frames`` [B, S_enc, d] the encoder's input
    (encoder-decoder configs).  With ``remat`` each block's activations
    are recomputed in the backward (``jax.checkpoint`` in the JAX
    package)."""
    bsz, s = tokens.shape
    x = model.embed[tokens.long()].to(layers.torch_dtype(cfg.dtype))
    positions = torch.arange(s, device=tokens.device)[None].expand(bsz, s)
    memory = None
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             "frames")
        x = x + _sinusoidal(positions, cfg.d_model, x.dtype)
        memory = _encode(model, frames, cfg, parallel)
    extra = {"positions": positions, "mrope_positions": mrope_positions,
             "memory": memory, "parallel": parallel}
    for blk, kind in zip(model.blocks, model.kinds):
        x = _unconstrain(x, parallel)
        if remat:
            x = checkpoint(transformer.block_apply, blk, x, cfg, kind,
                           use_reentrant=False, **extra)
        else:
            x = transformer.block_apply(blk, x, cfg, kind, **extra)
        x = _constrain_seq(x, parallel)
    x = layers.rmsnorm(_unconstrain(x, parallel), model.final_norm,
                       cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return _mask_pad_logits(x @ head, cfg)


def loss_fn(model: LM, batch: dict, cfg, *,
            parallel: ParallelContext = NO_PARALLEL, remat: bool = True
            ) -> torch.Tensor:
    """Next-token cross-entropy.  batch: tokens [B,S], labels [B,S] and
    optional loss_mask [B,S], mrope_positions [3,B,S] and frames.  Under an
    active ``parallel`` the batch is this rank's block and the loss the
    whole batch's (the mask's sum taken over the batch axes; each rank's
    part's gradient is its own)."""
    logits = forward(model, batch["tokens"], cfg, parallel=parallel,
                     mrope_positions=batch.get("mrope_positions"),
                     frames=batch.get("frames"), remat=remat)
    logits = _unconstrain(_constrain_bsv(logits, parallel), parallel)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits.float(), dim=-1)                # [B,S]
    # The JAX package picks the label's logit by a one-hot contraction with
    # float32 accumulation: one term is non-zero, so a gather cast to
    # float32 is the same value, without the [B,S,V] one-hot (0.62 GB in
    # bf16 at qwen3-8b's vocab and 2,048 tokens).
    picked = logits.gather(-1, labels[..., None])[..., 0].float()
    ll = picked - lse
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    if not parallel.active:
        return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    den, part = mask.sum(), -(ll * mask).sum()
    for axis in parallel.batch_axes:
        den = collectives.all_reduce_sum(den, parallel.group(axis))
    part = part / torch.clamp_min(den, 1.0)
    for axis in parallel.batch_axes:
        part = collectives.reduce_from(part, parallel.group(axis))
    return part


def prefill(model: LM, tokens: torch.Tensor, cfg, *,
            parallel: ParallelContext = NO_PARALLEL,
            mrope_positions: torch.Tensor | None = None,
            frames: torch.Tensor | None = None) -> torch.Tensor:
    """Inference prefill: the last position's logits [B, V_pad]."""
    return forward(model, tokens, cfg, parallel=parallel,
                   mrope_positions=mrope_positions, frames=frames,
                   remat=False)[:, -1]


def draw_lsh(cfg, generator: torch.Generator, *,
             device: str | torch.device = "cuda") -> list:
    """The LSH draws (a, b) on ``device`` of every layer whose cache can be
    aggregated (``transformer.aggregatable``), in stack order, None for the
    others; drawn from ``generator`` on its own device (over the latent
    keys for MLA)."""
    dev = resolve(device)
    n_kv, dk, _ = transformer.cache_dims(cfg)
    return [tuple(t.to(dev) for t in aggregated_kv.draw_lsh(
                generator, n_kv=n_kv, dk=dk, device=generator.device))
            if transformer.aggregatable(cfg, kind) else None
            for kind in block_kinds(cfg)]


def init_caches(cfg, *, batch: int, s_max: int, lsh: list | None = None,
                device: str | torch.device = "cuda") -> list:
    """Empty decode caches on ``device``, one per block in stack order
    (the module docstring gives an encoder-decoder config's).  With
    ``cfg.agg_kv`` each aggregated layer takes its draws from ``lsh``
    (``draw_lsh``: an entry a block)."""
    return _empty_caches(cfg, batch=batch, s_max=s_max, lsh=lsh,
                         dev=resolve(device))


def _empty_caches(cfg, *, batch: int, s_max: int, lsh: list | None,
                  dev: torch.device) -> list:
    """``init_caches`` on ``dev`` as given: the dry run builds its caches
    on ``meta`` through it (shapes only, nothing allocated)."""
    kinds = block_kinds(cfg)
    agg = [transformer.uses_agg(cfg, kind) for kind in kinds]
    if any(agg) and (lsh is None or len(lsh) != len(kinds) or any(
            a and lsh[i] is None for i, a in enumerate(agg))):
        raise ValueError("aggregated caches need one (a, b) LSH draw an "
                         "aggregated layer")
    dtype = layers.torch_dtype(cfg.dtype)
    caches = [
        transformer.init_block_cache(
            cfg, kind, batch=batch, s_max=s_max, dtype=dtype, device=dev,
            lsh=tuple(t.to(dev) for t in lsh[i]) if agg[i] else None)
        for i, kind in enumerate(kinds)
    ]
    if cfg.is_encoder_decoder:
        shape = (batch, s_max, cfg.n_heads, cfg.head_dim)
        caches = [{"self": c,
                   "cross": (torch.zeros(shape, dtype=dtype, device=dev),
                             torch.zeros(shape, dtype=dtype, device=dev))}
                  for c in caches]
    return caches


def aggregated_caches(caches) -> list:
    """The aggregated caches among a model's decode caches (any nesting),
    in stack order."""
    if isinstance(caches, aggregated_kv.AGG_CACHES):
        return [caches]
    if isinstance(caches, dict):
        caches = list(caches.values())
    if isinstance(caches, (list, tuple)):
        return [c for node in caches for c in aggregated_caches(node)]
    return []


def serve_step(model: LM, caches: list, tokens: torch.Tensor,
               pos: torch.Tensor, cfg, *,
               parallel: ParallelContext = NO_PARALLEL,
               mrope_positions: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, list]:
    """Decode one token.  tokens [B,1] int; pos [B] int32;
    ``mrope_positions`` [3,B,1] (the exact attention path of an M-RoPE
    config rotates by them).  The caches are updated in place; the RoPE
    angles are computed once for every layer.  Returns (logits [B, V_pad]
    in the model dtype, caches).
    """
    x = model.embed[tokens.long()].to(layers.torch_dtype(cfg.dtype))
    if cfg.is_encoder_decoder:
        x = x + _sinusoidal(pos[:, None], cfg.d_model, x.dtype)
    rotation = (layers.rope_rotation(pos[:, None], transformer.rope_dim(cfg),
                                     cfg.rope_theta) if cfg.use_rope else None)
    for blk, kind, cache in zip(model.blocks, model.kinds, caches):
        memory_kv = None
        if cfg.is_encoder_decoder:
            cache, memory_kv = cache["self"], cache["cross"]
        x, _ = transformer.block_decode(
            blk, x, cfg, kind, cache, pos, rotation, parallel=parallel,
            mrope_positions=mrope_positions, memory_kv=memory_kv)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return _mask_pad_logits(x[:, 0] @ head, cfg), caches
