"""MapReduce engine: map shards + shuffle + reduce, as
``src/repro/core/engine.py`` runs it.

The paper's job anatomy (map over input chunks, shuffle intermediate
results, reduce):

  map task   -> one rank of the mesh's ``axis`` (``shard_map``'s shard in
                the JAX package) over its slice of the leading dimension
  shuffle    -> the collective that moves map outputs (all_gather / psum);
                its byte count is the paper's shuffle cost
  reduce     -> a replicated combine over the gathered outputs, on every
                rank

With ``mesh=None`` the map_fn runs once over the whole input, its outputs
stacked along a new leading shard axis for an ``all_gather`` combine.  On
a mesh (a ``DeviceMesh`` of ``launch/mesh.py``, every rank calling ``run``)
each rank maps its slice of every sharded argument (a DTensor from
``shard_leading``, or a whole tensor, sliced here) with the replicated
arguments whole, then ``all_gather`` stacks the ranks' outputs on a new
leading axis (``all_gather_into_tensor``) or ``psum`` sums them
(``all_reduce``), and ``reduce_fn`` runs on every rank; ``identity`` keeps
each rank's output.  A leading dimension that does not divide by the axis
size raises, as ``shard_map`` does.  The shuffle is metered as the per-shard
output bytes times the number of shards (0 for ``identity``), and the
tracer gets the JAX package's spans: ``mapreduce`` (mode, shards,
shuffle_bytes), one ``map.shard`` event a shard and ``map+reduce.fused``;
the events follow the fused span here, since the port meters the outputs
it made.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.obs.trace import current_tracer
from repro_torch.parallel import collectives


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {key: _tree_map(fn, x) for key, x in tree.items()}
    raise TypeError(f"map output of type {type(tree).__name__}: expected "
                    "tensors in tuples, lists or dicts")


def _tree_bytes(tree: Any) -> int:
    """Byte size of every tensor in a tree of map outputs."""
    total = 0

    def add(t: torch.Tensor) -> torch.Tensor:
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    _tree_map(add, tree)
    return total


def _sync(tree: Any) -> Any:
    """Wait for the card to finish ``tree``, so a span ends where the work
    did (only under a live tracer)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return tree


@dataclasses.dataclass(frozen=True)
class CombineSpec:
    """How map outputs become the job result.

    mode:
      * "all_gather" — stack outputs along a new leading shard axis and hand
        them to ``reduce_fn`` (shuffle bytes = sum of outputs).
      * "psum"       — elementwise sum across shards (shuffle bytes = one
        output per shard).
      * "identity"   — outputs stay shard-local (no shuffle).
    """

    mode: str = "all_gather"
    reduce_fn: Callable[[Any], Any] | None = None


def _axis_dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def _local(x: torch.Tensor, n: int, r: int, axis: str) -> torch.Tensor:
    """This rank's rows of a sharded argument: a DTensor's local shard, or
    the r-th of n equal blocks of a whole tensor's leading dimension."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local()
    if x.shape[0] % n:
        raise ValueError(
            f"shard_map: leading dimension {x.shape[0]} of a sharded "
            f"argument does not divide by the {axis!r} axis size {n}")
    m = x.shape[0] // n
    return x[r * m:(r + 1) * m]


class MapReduce:
    """Run a map_fn over data sharded along ``axis`` of a mesh.

    With ``mesh=None`` the engine runs the map_fn once over the whole
    input, the single-device path of the tests and benchmarks.
    """

    def __init__(self, mesh=None, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.last_shuffle_bytes: int = 0

    def run(
        self,
        map_fn: Callable[..., Any],
        combine: CombineSpec,
        *sharded_args: Any,
        replicated_args: tuple = (),
    ) -> Any:
        # Spans attach to the tracer the caller installed; under a live
        # tracer the engine synchronises at stage boundaries so a span's
        # duration means "work finished here", not "launch returned here".
        tracer = current_tracer()
        if self.mesh is not None:
            return self._run_mesh(tracer, map_fn, combine, sharded_args,
                                  replicated_args)
        with tracer.span("mapreduce", mode=combine.mode, shards=1) as mr:
            with tracer.span("map.shard", shard=0) as m_sp:
                out = map_fn(*sharded_args, *replicated_args)
                if tracer.enabled:
                    out = _sync(out)
            self.last_shuffle_bytes = (
                0 if combine.mode == "identity" else _tree_bytes(out)
            )
            m_sp.set(shuffle_bytes=self.last_shuffle_bytes)
            mr.set(shuffle_bytes=self.last_shuffle_bytes)
            if combine.mode == "all_gather":
                out = _tree_map(lambda x: x[None], out)
            elif combine.mode != "psum":
                return out
            with tracer.span("reduce"):
                result = combine.reduce_fn(out) if combine.reduce_fn else out
                if tracer.enabled:
                    result = _sync(result)
            return result

    def _run_mesh(self, tracer, map_fn, combine, sharded_args,
                  replicated_args):
        mesh, axis = self.mesh, self.axis
        dim = _axis_dim(mesh, axis)
        group = mesh.get_group(axis)
        n_shards = mesh.shape[dim]
        r = mesh.get_local_rank(dim)
        local = [_tree_map(lambda x: _local(x, n_shards, r, axis), a)
                 for a in sharded_args]
        mode = combine.mode
        with tracer.span("mapreduce", mode=mode, shards=n_shards) as mr:
            with tracer.span("map+reduce.fused"):
                out = map_fn(*local, *replicated_args)
                per_shard = _tree_bytes(out)
                if mode == "all_gather":
                    out = _tree_map(
                        lambda x: collectives.all_gather_stack(x, group),
                        out)
                elif mode == "psum":
                    out = _tree_map(
                        lambda x: collectives.all_reduce_sum(x, group), out)
                if mode != "identity" and combine.reduce_fn is not None:
                    out = combine.reduce_fn(out)
                if tracer.enabled:
                    out = _sync(out)
            self.last_shuffle_bytes = (
                0 if mode == "identity" else per_shard * n_shards)
            mr.set(shuffle_bytes=self.last_shuffle_bytes)
            if tracer.enabled:
                per = self.last_shuffle_bytes // n_shards
                for i in range(n_shards):
                    tracer.event("map.shard", shard=i, shuffle_bytes=per)
        return out


def shard_leading(mesh, axis: str, tree: Any) -> Any:
    """This rank's slice of every tensor of a host tree, its leading
    dimension sharded along ``axis`` (replicated over the mesh's other
    axes), on the mesh's device: DTensors whose ``to_local`` is the slice.
    A leading dimension that does not divide by the axis size raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dim = _axis_dim(mesh, axis)
    n, r = mesh.shape[dim], mesh.get_local_rank(dim)
    placements = [Shard(0) if i == dim else Replicate()
                  for i in range(mesh.ndim)]
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def place(x):
        rows = _local(x, n, r, axis).to(dev)
        return DTensor.from_local(rows, mesh, placements, run_check=False)

    return _tree_map(place, tree)
