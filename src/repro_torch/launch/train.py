"""Step factories and a host training loop, as
``src/repro/launch/train.py`` defines them.

``make_train_step`` builds the (model, opt_state[, ef], batch) -> (model,
opt_state[, ef], metrics) step: the eager equivalent of the JAX package's
``value_and_grad`` step.  The model is an ``LM``; the optimizer state
mirrors ``models.model.param_tree(model)``, and ``optim.apply_updates``
writes the new parameters and moments over the old ones.

With an active ``parallel`` (``models.transformer.ParallelContext``) the
model's parameters are DTensors placed by ``parallel.sharding``'s
``param_shardings`` (``place_params``) and the optimizer state mirrors
their local shards (``sharding.local_tree``).  A step takes the whole
batch on every rank and computes on this rank's block of it over the data
axes; the parameters' views (``sharding.local_views``: gathered, the
tensor-parallel attention and MLP slices kept) carry the gradient back to
each shard, summed over the data axes, and the global norm that clips it
is taken over the shards.  The loss and the update are the unsharded
step's.  The prefill and serve steps return the whole batch's logits.

The CLI trains a reduced config on the card (``--device cpu`` for the
CPU):

    python -m repro_torch.launch.train --steps 20
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any

import torch

from repro_torch import convert, optim
from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import (
    NO_PARALLEL, ParallelContext, data_gather, data_slice,
)
from repro_torch.parallel import collectives, sharding


def shard_batch(batch: dict, parallel: ParallelContext) -> dict:
    """This rank's block of a whole batch over the data axes, each entry
    along the dimension ``sharding.batch_specs`` shards; a batch that does
    not divide is kept whole (every rank computes all of it)."""
    if not parallel.active:
        return batch
    b = batch["tokens"].shape[0]
    if b % parallel.data_size or b < parallel.data_size:
        return batch
    return {k: data_slice(v, parallel, 1 if k == "mrope_positions" else 0)
            if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def _whole(logits: torch.Tensor, batch: dict, parallel) -> torch.Tensor:
    """Logits of ``shard_batch``'s rows -> the whole batch's."""
    if not parallel.active or logits.shape[0] == batch["tokens"].shape[0]:
        return logits
    return data_gather(logits, parallel)


def _sharded_value_and_grad(model, batch, cfg, parallel):
    from torch.distributed.tensor import DTensor
    from torch.nn.utils.stateless import _reparametrize_module

    params = model_lib.param_tree(model)
    if not all(isinstance(p, DTensor) for p in params.values()):
        raise ValueError("a sharded step needs the parameters placed "
                         "(parallel.sharding.place_params)")
    leaves, views = sharding.local_views(params, cfg, parallel)
    # the backward recomputes each block (remat) from the views: inside
    with _reparametrize_module(model, views):
        loss = model_lib.loss_fn(model, shard_batch(batch, parallel),
                                 cfg, parallel=parallel)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves.values(), grads)]
    return loss.detach(), dict(zip(params, grads))


def sharded_global_norm(grads: dict, params: dict, parallel
                        ) -> torch.Tensor:
    """The global norm of a sharded step's gradient (each shard's local
    gradient, the same on the ranks a parameter is replicated over): every
    rank's squares divided by the parameter's number of replicas, summed
    over the mesh."""
    mesh = parallel.mesh
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(grads.values())).device)
    for name, g in grads.items():
        replicas = math.prod(mesh.shape[i] for i, pl in
                             enumerate(params[name].placements)
                             if not pl.is_shard())
        total = total + torch.sum(g.float() ** 2) / replicas
    for i in range(mesh.ndim):
        total = collectives.all_reduce_sum(total, mesh.get_group(i))
    return torch.sqrt(total)


def value_and_grad(model: model_lib.LM, batch: dict, cfg,
                   parallel: ParallelContext = NO_PARALLEL
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, gradient of every parameter by name) of ``loss_fn``.  A
    parameter the loss does not read (an encoder block's cross-attention
    weights) gets a zero gradient, as under ``jax.grad``.  Under an active
    ``parallel`` each gradient is of the parameter's local shard."""
    if parallel.active:
        return _sharded_value_and_grad(model, batch, cfg, parallel)
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
                    parallel: ParallelContext = NO_PARALLEL,
                    grad_compress_frac: float = 0.0):
    """Returns train_step(model, opt_state[, ef], batch) -> (...).

    With ``grad_compress_frac`` the step takes the error feedback of
    ``init_error_feedback``.  The JAX package compresses its own parameter
    tree, where each pattern block's leaves are stacked over the units, so
    its top-k runs over a stacked tensor, all the units' layers together;
    the port selects in that layout too (``convert.lm_tree``), and the
    kept entries are the same.  A sharded step (an active ``parallel``)
    does not take it: the JAX package's top-k runs over each whole
    stacked tensor, which no rank holds.
    """

    if parallel.active:
        if grad_compress_frac > 0.0:
            raise ValueError("gradient compression selects over whole "
                             "tensors: a sharded step does not take it")

        def sharded_step(model, opt_state, batch):
            loss, grads = value_and_grad(model, batch, cfg, parallel)
            params = model_lib.param_tree(model)
            gnorm = sharded_global_norm(grads, params, parallel)
            _, opt_state = optim.apply_updates(
                sharding.local_tree(params), grads, opt_state, opt_cfg,
                convert.lm_decayed(params, cfg), gnorm=gnorm)
            return model, opt_state, {"loss": loss}
        return sharded_step

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


def make_prefill_step(cfg, parallel: ParallelContext = NO_PARALLEL):
    def prefill_step(model, batch):
        if not parallel.active:
            return model_lib.prefill(
                model, batch["tokens"], cfg,
                mrope_positions=batch.get("mrope_positions"),
                frames=batch.get("frames"))
        local = shard_batch(batch, parallel)
        with sharding.materialized(model, cfg, parallel):
            logits = model_lib.prefill(
                model, local["tokens"], cfg, parallel=parallel,
                mrope_positions=local.get("mrope_positions"),
                frames=local.get("frames"))
        return _whole(logits, batch, parallel)
    return prefill_step


def make_serve_step(cfg, parallel: ParallelContext = NO_PARALLEL):
    """Returns step(model, caches, batch) -> (logits, caches).  Under an
    active ``parallel`` the caches are those of this rank's rows
    (``shard_batch``'s) and the logits the whole batch's; the attention
    runs on whole weights (decode is not tensor-parallel here)."""
    def step(model, caches, batch):
        if not parallel.active:
            return model_lib.serve_step(
                model, caches, batch["tokens"], batch["pos"], cfg,
                mrope_positions=batch.get("mrope_positions"))
        local = shard_batch(batch, parallel)
        with sharding.materialized(model, cfg, parallel, tp=False):
            logits, caches = model_lib.serve_step(
                model, caches, local["tokens"], local["pos"], cfg,
                parallel=parallel,
                mrope_positions=local.get("mrope_positions"))
        return _whole(logits, batch, parallel), caches
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
