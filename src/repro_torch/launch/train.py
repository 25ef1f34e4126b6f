"""Step factories and a host training loop, as
``src/repro/launch/train.py`` defines them.

``make_train_step`` builds the (model, opt_state[, ef], batch) -> (model,
opt_state[, ef], metrics) step: the eager equivalent of the JAX package's
``value_and_grad`` step.  The model is an ``LM``; the optimizer state
mirrors ``models.model.param_tree(model)``, and ``optim.apply_updates``
writes the new parameters and moments over the old ones.  The CLI trains
a reduced config on the card (``--device cpu`` for the CPU):

    python -m repro_torch.launch.train --steps 20
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import torch

from repro_torch import convert, optim
from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import model as model_lib


def value_and_grad(model: model_lib.LM, batch: dict, cfg
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, gradient of every parameter by name) of ``loss_fn``.  A
    parameter the loss does not read (an encoder block's cross-attention
    weights) gets a zero gradient, as under ``jax.grad``."""
    params = model_lib.param_tree(model)
    for p in params.values():
        p.requires_grad_(True)
    try:
        loss = model_lib.loss_fn(model, batch, cfg)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    finally:
        for p in params.values():
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    return loss.detach(), dict(zip(params, grads))


def init_error_feedback(model: model_lib.LM, cfg) -> optim.ErrorFeedback:
    """Zero residuals in the JAX package's parameter layout, the one the
    compressed train step selects in (``convert.lm_tree``)."""
    return optim.init_error_feedback(
        convert.lm_tree(model_lib.param_tree(model), cfg))


def make_train_step(cfg, opt_cfg: optim.AdamWConfig,
                    grad_compress_frac: float = 0.0):
    """Returns train_step(model, opt_state[, ef], batch) -> (...).

    With ``grad_compress_frac`` the step takes the error feedback of
    ``init_error_feedback``.  The JAX package compresses its own parameter
    tree, where each pattern block's leaves are stacked over the units, so
    its top-k runs over a stacked tensor, all the units' layers together;
    the port selects in that layout too (``convert.lm_tree``), and the
    kept entries are the same.
    """

    if grad_compress_frac > 0.0:
        def train_step(model, opt_state, ef, batch):
            loss, grads = value_and_grad(model, batch, cfg)
            sent, ef, _ = optim.compress_topk(
                convert.lm_tree(grads, cfg), ef, frac=grad_compress_frac
            )
            params = model_lib.param_tree(model)
            _, opt_state = optim.apply_updates(
                params, convert.lm_named(sent, cfg), opt_state, opt_cfg,
                convert.lm_decayed(params, cfg)
            )
            return model, opt_state, ef, {"loss": loss}
        return train_step

    def train_step(model, opt_state, batch):
        loss, grads = value_and_grad(model, batch, cfg)
        params = model_lib.param_tree(model)
        _, opt_state = optim.apply_updates(
            params, grads, opt_state, opt_cfg, convert.lm_decayed(params, cfg)
        )
        return model, opt_state, {"loss": loss}

    return train_step


def make_prefill_step(cfg):
    def prefill_step(model, batch):
        return model_lib.prefill(
            model, batch["tokens"], cfg,
            mrope_positions=batch.get("mrope_positions"),
            frames=batch.get("frames"))
    return prefill_step


def make_serve_step(cfg):
    def step(model, caches, batch):
        return model_lib.serve_step(
            model, caches, batch["tokens"], batch["pos"], cfg,
            mrope_positions=batch.get("mrope_positions"))
    return step


def synth_batch(generator: torch.Generator, cfg, *, batch: int, seq: int,
                device: str | torch.device = "cuda") -> dict[str, Any]:
    """Synthetic token batch, drawn from ``generator`` on its own device."""
    dev = resolve(device)
    gdev = generator.device

    def ints():
        return torch.randint(0, cfg.vocab_size, (batch, seq),
                             generator=generator, device=gdev).to(dev)

    out = {"tokens": ints(), "labels": ints()}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn(
            (batch, seq, cfg.d_model), generator=generator, device=gdev
        ).to(device=dev, dtype=model_lib.layers.torch_dtype(cfg.dtype))
    if cfg.mrope:
        out["mrope_positions"] = torch.arange(
            seq, dtype=torch.int32, device=dev)[None, None].expand(
                3, batch, seq).contiguous()
    return out


def main(argv=None) -> model_lib.LM:
    """Train a reduced config on synthetic batches, printing each step's
    loss; returns the trained model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = optim.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
    )
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = model_lib.init_params(cfg, gen, device=dev)
    opt_state = optim.init_state(model_lib.param_tree(model))
    step_fn = make_train_step(cfg, opt_cfg)

    for i in range(args.steps):
        batch = synth_batch(gen, cfg, batch=args.batch, seq=args.seq,
                            device=dev)
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        print(f"step {i:4d} loss {loss:.4f} "
              f"({(time.perf_counter()-t0)*1e3:.0f} ms)")
    return model


if __name__ == "__main__":
    main()
