"""The port's model API for decoding: ``init_params``, ``init_caches`` and
``serve_step``, as ``src/repro/models/model.py`` defines them.

The parameters are an ``LM`` module: the embedding, the final norm, the
LM head and a ``ModuleList`` of blocks in stack order (head blocks, the
repeated pattern units, tail blocks); the JAX package's ``lax.scan`` over
stacked units becomes a loop over that list.  The decode caches are a list
in the same order.  Full-sequence ``forward`` / ``prefill`` are not ported
yet: the decode engine prefills token by token with ``serve_step``.
"""
from __future__ import annotations

import torch
from torch import nn

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
    ``blocks``."""

    def __init__(self, init: layers.Init, cfg):
        super().__init__()
        vpad = padded_vocab(cfg)
        self.kinds = block_kinds(cfg)
        self.embed = init.normal((vpad, cfg.d_model), 0.02)
        self.final_norm = layers.rmsnorm_init(init, cfg.d_model)
        if not cfg.tie_embeddings:
            self.lm_head = layers.dense_init(init, cfg.d_model, vpad)
        self.blocks = nn.ModuleList(
            transformer.block_init(init, cfg, kind) for kind in self.kinds)


def init_params(cfg, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> LM:
    """Random weights in the config's dtype on ``device``, drawn from
    ``generator`` on its own device (give a generator on the card to draw
    there)."""
    init = layers.Init(generator, dtype=layers.torch_dtype(cfg.dtype),
                       device=resolve(device))
    return LM(init, cfg)


def draw_lsh(cfg, generator: torch.Generator, *,
             device: str | torch.device = "cuda") -> list:
    """Every attention layer's LSH draws (a, b) on ``device``, in stack
    order, drawn from ``generator`` on its own device."""
    dev = resolve(device)
    return [tuple(t.to(dev) for t in aggregated_kv.draw_lsh(
                generator, n_kv=cfg.n_kv_heads, dk=cfg.head_dim,
                device=generator.device))
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
    rotation = (layers.rope_rotation(pos[:, None], cfg.head_dim,
                                     cfg.rope_theta) if cfg.use_rope else None)
    for blk, kind, cache in zip(model.blocks, model.kinds, caches):
        x, _ = transformer.block_decode(blk, x, cfg, kind, cache, pos,
                                        rotation)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return _mask_pad_logits(x[:, 0] @ head, cfg), caches
