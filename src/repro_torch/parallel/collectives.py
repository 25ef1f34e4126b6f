"""The collectives of the port's mesh path, over ``torch.distributed``.

Every collective the mesh path runs goes through this module: the engine's
all-gather and sum, expert parallelism's all-gather, reduce-scatter and
all-to-all, the pipeline's hops, the parameter gathers of a sharded train
step.  Each takes a process group (a ``DeviceMesh`` axis's) and works on
the tensor's own device.

The ranks of one card share it under the gloo backend (NCCL will not put
two ranks of one communicator on one device).  gloo takes some
collectives on CUDA tensors and not others: for those in ``GLOO_CUDA`` the
call goes to gloo as it is; for the rest it is staged through pinned host
buffers: the input copied to the host, the collective run there, the
result copied back.  That is a rule of the backend, chosen by the table,
not a fallback after a failure (``tools/torch_gloo_probe.py`` is how the
table was found on the card).

The autograd-aware forms follow the tensor-parallel convention (Megatron):
a tensor replicated over a group carries the same gradient on every rank
of it.  ``all_gather`` and ``reduce_scatter`` are each other's adjoints;
``reduce_from`` sums a partial result over the group (its gradient is
passed through), ``copy_to`` marks a replicated input entering per-rank
partial work (its gradient is summed).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# The collectives that gloo runs on CUDA tensors itself, found by
# tools/torch_gloo_probe.py on the card (torch 2.11+cu128): each gave the
# right answer there.  ``batch_isend_irecv`` is not among them: gloo hands
# the device pointer to its TCP transport, which fails ("writev: Bad
# address") and takes the world down, so the hops stage through the host.
# (The functional collectives' all-gather, and with it DTensor's
# ``full_tensor``, crash there too; the port does not call them.)
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather_into_tensor",
                       "reduce_scatter_tensor", "all_to_all_single"})


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def _staged(op: str, x: torch.Tensor, group) -> bool:
    return (x.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA)


def _host(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


def _run(op: str, fn, out: torch.Tensor, *inputs: torch.Tensor,
         group) -> torch.Tensor:
    """``fn(out, *inputs)`` on the tensors' device, or on pinned host
    copies that are copied back where gloo does not take ``op`` on CUDA."""
    if not _staged(op, inputs[0], group):
        fn(out, *inputs)
        return out
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    fn(host_out, *(_host(x.contiguous()) for x in inputs))
    out.copy_(host_out)
    return out


# ---------------------------------------------------------------------------
# plain collectives (no gradient)
# ---------------------------------------------------------------------------

def all_gather_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` stacked on dim 0 in rank order: [n * x.shape[0],
    ...] (``jax.lax.all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    out = x.new_empty((size(group) * x.shape[0], *x.shape[1:]))
    return _run("all_gather_into_tensor",
                lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
                out, x, group=group)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` on a new leading axis: [n, *x.shape]
    (``jax.lax.all_gather``)."""
    return all_gather_tensor(x[None], group)


def reduce_scatter_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` [n * m, ...], this rank's m rows
    (``jax.lax.psum_scatter(..., tiled=True)``)."""
    n = size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} does "
                         f"not divide by the group's {n} ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    return _run("reduce_scatter_tensor",
                lambda o, i: dist.reduce_scatter_tensor(o, i, group=group),
                out, x, group=group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise sum of ``x``, in a new tensor."""
    out = x.detach().clone(memory_format=torch.contiguous_format)

    def fn(o, i):
        if o is not i:
            o.copy_(i)
        dist.all_reduce(o, group=group)
    return _run("all_reduce", fn, out, out, group=group)


def all_to_all_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """Split dim 0 into n equal blocks, send block j to rank j, and stack
    what arrives in rank order (``jax.lax.all_to_all(..., split_axis=0,
    concat_axis=0, tiled=True)``)."""
    n = size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"divide by the group's {n} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    return _run("all_to_all_single",
                lambda o, i: dist.all_to_all_single(o, i, group=group),
                out, x, group=group)


def shift(x: torch.Tensor, group, *, forward: bool) -> torch.Tensor:
    """Send ``x`` to the next rank of the group and return what the
    previous one sent (zeros on the first); ``forward=False`` the other way
    round.  One ``batch_isend_irecv``, so that the end ranks, which only
    send or only receive, cannot deadlock."""
    n, r = size(group), rank(group)
    dst, src = (r + 1, r - 1) if forward else (r - 1, r + 1)
    x = x.contiguous()
    out = torch.zeros_like(x)
    staged = _staged("batch_isend_irecv", x, group)
    send = _host(x) if staged else x
    recv = torch.zeros(x.shape, dtype=x.dtype, pin_memory=True) if staged \
        else out
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        out.copy_(recv)
    return out


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tensor(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_tensor(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_tensor(g, ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    """A dim-0 shard of a tensor replicated over the group -> the whole;
    each rank's gradient is the whole tensor's, so the shard's is its
    slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, g):
        r = rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


class _ScatterReplicated(torch.autograd.Function):
    """This rank's dim-0 block of a tensor replicated over the group; the
    inverse of ``_GatherReplicated``."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = size(group), rank(group)
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide by "
                             f"the group's {n} ranks")
        ctx.group = group
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m].clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_tensor(g, ctx.group), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, forward=True)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, forward=False), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_tensor``, differentiable (gradient: reduce-scatter)."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``reduce_scatter_tensor``, differentiable (gradient: all-gather)."""
    return _ReduceScatter.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_tensor``, differentiable (its own adjoint)."""
    return _AllToAll.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum a partial result over the group; the sum's gradient, the same on
    every rank, is each part's."""
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated tensor entering per-rank partial work: the identity,
    whose gradient sums the ranks' partial gradients."""
    return _CopyTo.apply(x, group)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The whole of a tensor replicated over the group from this rank's
    block of ``dim`` (the gradient: its block of the whole's)."""
    if dim == 0:
        return _GatherReplicated.apply(x, group)
    return _GatherReplicated.apply(x.movedim(dim, 0), group).movedim(0, dim)


def scatter_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor replicated over the group
    (the gradient: the blocks gathered)."""
    if dim == 0:
        return _ScatterReplicated.apply(x, group)
    return _ScatterReplicated.apply(x.movedim(dim, 0), group).movedim(0, dim)


def hop(x: torch.Tensor, group) -> torch.Tensor:
    """To the next rank of the group, from the previous (zeros on the
    first); the gradient goes the other way."""
    return _Shift.apply(x, group)
