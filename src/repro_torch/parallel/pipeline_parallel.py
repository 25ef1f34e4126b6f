"""Pipeline parallelism: a microbatched GPipe schedule over a ``pipe`` mesh
axis, as ``src/repro/parallel/pipeline_parallel.py`` runs it.

With M microbatches and S stages the schedule runs M + S - 1 ticks; each
tick every stage computes one microbatch and hands its activation to the
next stage (``collectives.hop``: a ``torch.autograd.Function`` over one
``batch_isend_irecv``, whose backward sends the gradient the other way).
The last stage commits its outputs; the final buffer is summed over the
axis (``collectives.reduce_from``), so every rank holds it and the same
function trains.

Every rank keeps every hop in its graph, as the JAX package's ``where``
and ``cond`` keep them in its trace: stage 0 selects the microbatch over
what it received, each stage writes its outputs into its buffer under a
"last stage" select, and the last hop's output joins the buffer at weight
zero.  So each rank's backward runs every hop, last tick first, and the
ranks' sends and receives pair up.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.engine import _tree_map
from repro_torch.parallel import collectives


def _stage_slice(t: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's parameters from a leaf with a leading stage axis: a
    DTensor sharded over the axis (its one local row) or a whole tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[stage]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh,
    *,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline.

    stage_params: a tree with leading axis S (whole tensors, or DTensors
    sharded over ``axis``: ``core.engine.shard_leading``).
    microbatches: [M, mb, ...] (the same on every rank; stage 0 consumes
    it).  Returns the [M, mb, ...] outputs on every rank.
    """
    dim = mesh.mesh_dim_names.index(axis)
    group = mesh.get_group(axis)
    s_stages = mesh.shape[dim]
    stage = mesh.get_local_rank(dim)
    params_here = _tree_map(lambda t: _stage_slice(t, stage), stage_params)
    m = microbatches.shape[0]
    first = torch.tensor(stage == 0, device=microbatches.device)
    last = torch.tensor(stage == s_stages - 1, device=microbatches.device)

    outs = [torch.zeros_like(microbatches[0]) for _ in range(m)]
    recv = torch.zeros_like(microbatches[0])
    for t in range(m + s_stages - 1):
        mb_idx = t - stage                       # microbatch at this stage
        valid = 0 <= mb_idx < m
        x_in = torch.where(first, microbatches[min(max(mb_idx, 0), m - 1)],
                           recv)
        y = stage_fn(params_here, x_in)
        if valid:
            # the last stage commits its output; the others keep zeros
            outs[mb_idx] = torch.where(last, y, outs[mb_idx])
        else:
            y = torch.where(first & ~first, y, torch.zeros_like(y))
        recv = collectives.hop(y, group)
    # The last hop's output joins the buffer at weight zero: each hop's
    # output then reaches the loss on every rank, so every rank's backward
    # runs all the hops, last tick first (a hop whose output reached no
    # loss on one rank would leave its neighbours' sends unmatched).
    never = first & ~first
    buf = torch.stack(outs) + torch.where(never, recv.sum(), 0.0)
    # every rank returns the (summed) final buffer
    return collectives.reduce_from(buf, group)


def sequential_reference(stage_fn, stage_params, microbatches
                         ) -> torch.Tensor:
    """Oracle: apply the stages in turn to each microbatch (no
    pipeline)."""
    leaves = []
    _tree_map(lambda t: leaves.append(t) or t, stage_params)
    n = leaves[0].shape[0]

    def one(mb):
        x = mb
        for i in range(n):
            x = stage_fn(_tree_map(lambda t: t[i], stage_params), x)
        return x

    return torch.stack([one(mb) for mb in microbatches])
