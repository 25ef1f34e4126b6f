"""The port's model API: ``init_params``, ``forward``, ``loss_fn``,
``prefill``, ``init_caches`` and ``serve_step``, as
``src/repro/models/model.py`` defines them.

The parameters are an ``LM`` module: the embedding, the final norm, the
LM head and a ``ModuleList`` of blocks in stack order (head blocks, the
repeated pattern units, tail blocks); the JAX package's ``lax.scan`` over
stacked units becomes a loop over that list.  The decode caches are a list
in the same order.  ``param_tree`` names the parameters for the optimizer
and the checkpointer; ``convert`` maps that to the JAX package's tree.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import aggregated_kv, layers, transformer


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


class LM(nn.Module):
    """Decoder-only language model weights: ``embed`` [V_pad, d],
    ``final_norm`` [d], ``lm_head`` [d, V_pad] (unless tied) and
    ``blocks`` (the first ``cfg.first_k_dense`` are head blocks, with a
    dense MLP in an MoE config)."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        vpad = padded_vocab(cfg)
        self.kinds = block_kinds(cfg)
        self.embed = init.normal((vpad, cfg.d_model), 0.02)
        self.final_norm = layers.rmsnorm_init(init, cfg.d_model)
        if not cfg.tie_embeddings:
            self.lm_head = layers.dense_init(init, cfg.d_model, vpad)
        n_head = cfg.first_k_dense
        self.blocks = nn.ModuleList(
            transformer.block_init(init, cfg, kind, is_head=i < n_head)
            for i, kind in enumerate(self.kinds))


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


def forward(model: LM, tokens: torch.Tensor, cfg, *,
            remat: bool = False) -> torch.Tensor:
    """Logits [B, S, V_pad] over the full sequence.  tokens: [B, S] int.
    With ``remat`` each block's activations are recomputed in the backward
    (``jax.checkpoint`` in the JAX package)."""
    bsz, s = tokens.shape
    x = model.embed[tokens.long()].to(layers.torch_dtype(cfg.dtype))
    positions = torch.arange(s, device=tokens.device)[None].expand(bsz, s)
    for blk, kind in zip(model.blocks, model.kinds):
        if remat:
            x = checkpoint(transformer.block_apply, blk, x, cfg, kind,
                           positions=positions, use_reentrant=False)
        else:
            x = transformer.block_apply(blk, x, cfg, kind,
                                        positions=positions)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return _mask_pad_logits(x @ head, cfg)


def loss_fn(model: LM, batch: dict, cfg, *, remat: bool = True
            ) -> torch.Tensor:
    """Next-token cross-entropy.  batch: tokens [B,S], labels [B,S] and an
    optional loss_mask [B,S]."""
    logits = forward(model, batch["tokens"], cfg, remat=remat)
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
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def prefill(model: LM, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Inference prefill: the last position's logits [B, V_pad]."""
    return forward(model, tokens, cfg, remat=False)[:, -1]


def draw_lsh(cfg, generator: torch.Generator, *,
             device: str | torch.device = "cuda") -> list:
    """Every attention layer's LSH draws (a, b) on ``device``, in stack
    order, drawn from ``generator`` on its own device (over the latent
    keys for MLA)."""
    dev = resolve(device)
    n_kv, dk, _ = transformer.cache_dims(cfg)
    return [tuple(t.to(dev) for t in aggregated_kv.draw_lsh(
                generator, n_kv=n_kv, dk=dk, device=generator.device))
            for _ in block_kinds(cfg)]


def init_caches(cfg, *, batch: int, s_max: int, lsh: list | None = None,
                device: str | torch.device = "cuda") -> list:
    """Empty decode caches on ``device``, one per block in stack order.
    With ``cfg.agg_kv`` each layer takes its draws from ``lsh``
    (``draw_lsh``)."""
    dev = resolve(device)
    kinds = block_kinds(cfg)
    if cfg.agg_kv and (lsh is None or len(lsh) != len(kinds)):
        raise ValueError("aggregated caches need one (a, b) LSH draw a layer")
    dtype = layers.torch_dtype(cfg.dtype)
    return [
        transformer.init_block_cache(
            cfg, kind, batch=batch, s_max=s_max, dtype=dtype, device=dev,
            lsh=tuple(t.to(dev) for t in lsh[i]) if cfg.agg_kv else None)
        for i, kind in enumerate(kinds)
    ]


def serve_step(model: LM, caches: list, tokens: torch.Tensor,
               pos: torch.Tensor, cfg) -> tuple[torch.Tensor, list]:
    """Decode one token.  tokens [B,1] int; pos [B] int32.  The caches are
    updated in place; the RoPE angles are computed once for every layer.
    Returns (logits [B, V_pad] in the model dtype, caches).
    """
    x = model.embed[tokens.long()].to(layers.torch_dtype(cfg.dtype))
    rotation = (layers.rope_rotation(pos[:, None], transformer.rope_dim(cfg),
                                     cfg.rope_theta) if cfg.use_rope else None)
    for blk, kind, cache in zip(model.blocks, model.kinds, caches):
        x, _ = transformer.block_decode(blk, x, cfg, kind, cache, pos,
                                        rotation)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return _mask_pad_logits(x[:, 0] @ head, cfg), caches
