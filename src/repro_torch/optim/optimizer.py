"""AdamW + schedules, as ``src/repro/optim/optimizer.py`` computes them.

State layout mirrors the parameter tree (m, v in float32; a tree of
``repro_torch.tree``: for a model, ``models.model.param_tree``).  The
field names are the JAX package's, so checkpoint keys (``opt/.step``,
``opt/.m/...``) match.  Every quantity is a float32 tensor, as the JAX
package's are: the schedule, the clip factor and the bias corrections
included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib


class AdamState(NamedTuple):
    step: torch.Tensor       # scalar int32
    m: Any                   # tree like params (f32)
    v: Any                   # tree like params (f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3.0e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1.0e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32)."""
    step = torch.as_tensor(step)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def init_state(params: Any) -> AdamState:
    zeros = tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params,
    )
    device = tree_lib.leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=zeros, v=tree_lib.tree_map(torch.zeros_like, zeros))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(leaf.float() ** 2) for leaf in tree_lib.leaves(tree))
    )


@torch.no_grad()
def apply_updates(
    params: Any, grads: Any, state: AdamState, cfg: AdamWConfig,
    decayed: Any = None, gnorm: torch.Tensor | None = None,
) -> tuple[Any, AdamState]:
    """One AdamW step with global-norm clipping, written over ``params`` and
    ``state``'s moments in place (as ``torch.optim`` does, and as a jitted
    JAX step reuses donated buffers): the JAX package's values without a
    second copy of the moments, 13 GB at qwen3-8b's widths 2 layers deep.
    ``decayed``, a tree like ``params`` of bools, says which leaves get
    the weight decay; by default those with ``ndim >= 2``, as in the JAX
    package (for an ``LM``, ``convert.lm_decayed`` says which leaves the
    JAX package's own tree decays).  ``gnorm``: the gradient's global
    norm where the caller holds only shards of it (a sharded step), else
    computed here.  Returns (params, the new state)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v, decay):
        g = g.float() * clip
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        del g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay:  # decoupled weight decay
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    flat_p = tree_lib.leaves(params)
    flat_d = ([p.dim() >= 2 for p in flat_p] if decayed is None
              else tree_lib.flatten_up_to(params, decayed))
    for p, g, m, v, decay in zip(flat_p,
                                 tree_lib.flatten_up_to(params, grads),
                                 tree_lib.flatten_up_to(params, state.m),
                                 tree_lib.flatten_up_to(params, state.v),
                                 flat_d):
        upd(p, g, m, v, decay)
    return params, AdamState(step=step, m=state.m, v=state.v)
