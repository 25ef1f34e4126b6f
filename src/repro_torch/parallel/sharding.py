"""Parameter, batch and cache PartitionSpec rules for the production meshes,
as ``src/repro/parallel/sharding.py`` states them, and their DTensor
placements.

Sharding policy:
  * TP over ``model``: attention heads, MLP hidden, MoE experts (EP), vocab.
  * FSDP over the data axes (``data``; ``pod`` composes in multi-pod): the
    remaining large dim of each 2D+ parameter, when divisible.
  * Small/odd tensors (norms, biases, low-head-count attention such as
    whisper-tiny's 6 heads or gemma3's 4) stay replicated.

The rules are plain functions over a parameter's path and shape and return
a ``PartitionSpec``: per dimension an axis name, a tuple of axis names or
None.  They run over the JAX package's parameter tree, which ``convert``
builds from the port's (``convert.lm_tree``; the paths are the JAX
package's: ``units/b0/attn/wq``, ``encoder/blocks/...``,
``head_blocks/0/moe/w_gate``), and ``convert.lm_named`` maps the specs back
to the port's parameter names.  That tree stacks a unit's layers as
``[n_units, ...]`` and gives them ``P(None, *inner)``; each of the port's
per-layer tensors takes ``inner``.

A mesh is a ``DeviceMesh`` or, for the rules alone, a mapping of axis name
to size (``{"data": 16, "model": 16}``), so that the production meshes'
specs are computed without 256 ranks.  ``param_shardings`` turns each spec
into DTensor placements on a ``DeviceMesh`` (``NamedSharding``): ``Shard(d)``
on each mesh dimension that tensor dimension d names, in mesh order (a
``("pod", "data")`` entry shards one dimension over both), ``Replicate()``
on the rest; ``place`` and ``gather`` move between whole tensors and
DTensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import axis_sizes


class PartitionSpec(tuple):
    """Per tensor dimension: an axis name, a tuple of axis names, or
    None (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# parameter-name suffixes by role ------------------------------------------
_HEADS_OUT = ("wq", "wk", "wv", "w_uq", "bq", "bk", "bv")   # [.., H*hd]
_HEADS_IN = ("wo",)                                          # [H*hd, ..]
_FF_OUT = ("w_gate", "w_up", "in_z", "in_x", "in_dt")        # [d, ff]
_FF_IN = ("w_down", "out_proj")                              # [ff, d]
_VOCAB = ("embed",)
_LM_HEAD = ("lm_head",)
_EXPERT = ("moe/w_gate", "moe/w_up", "moe/w_down")           # [E, ..]
_REPLICATE_HINTS = (
    "norm", "bias", "a_log", "d_skip", "dt_bias", "router", "b_if",
    "in_b", "in_c", "conv", "r_h", "w_if", "shared",
)


def _divisible(n: int, by: int) -> bool:
    """Shardable: axis size >1 (no-op axes never claim a dim) and divides."""
    return by > 1 and n % by == 0


def infer_param_spec(
    path_s: str, shape: tuple, cfg, *, tp: int, fsdp: int,
    data_axes: tuple, model_axis: str = "model",
) -> PartitionSpec:
    """PartitionSpec for one parameter."""
    name = path_s.split("/")[-1]
    ndim = len(shape)
    spec: list = [None] * ndim

    def fsdp_remaining():
        """FSDP-shard the largest still-unsharded dim if divisible."""
        if fsdp <= 1:
            return
        order = sorted(
            range(ndim), key=lambda i: -(shape[i] if spec[i] is None else -1)
        )
        for i in order:
            if spec[i] is None and _divisible(shape[i], fsdp) \
                    and shape[i] >= 4 * fsdp:
                spec[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                return

    heads_shardable = (
        _divisible(cfg.n_heads, tp) and _divisible(cfg.n_kv_heads, tp)
    )
    is_expert = any(path_s.endswith(e) for e in _EXPERT) or (
        "moe/" in path_s and name in ("w_gate", "w_up", "w_down")
        and "shared" not in path_s
    )

    if is_expert and ndim == 3:
        if _divisible(shape[0], tp):
            spec[0] = model_axis
        fsdp_remaining()
        return P(*spec)

    if any(h in path_s for h in _REPLICATE_HINTS) and not is_expert:
        if ndim >= 2:
            fsdp_remaining()
        return P(*spec)

    if name in _VOCAB and ndim == 2:
        # tied embeddings double as the lm_head: shard the vocab dim; untied
        # ones shard d_model instead
        if cfg.tie_embeddings:
            if _divisible(shape[0], tp):
                spec[0] = model_axis
        else:
            if _divisible(shape[1], tp):
                spec[1] = model_axis
        fsdp_remaining()
        return P(*spec)
    if name in _LM_HEAD and ndim == 2:
        if _divisible(shape[1], tp):
            spec[1] = model_axis
        fsdp_remaining()
        return P(*spec)

    if name in _HEADS_OUT:
        if heads_shardable and _divisible(shape[-1], tp):
            spec[-1] = model_axis
        if ndim >= 2:
            fsdp_remaining()
        return P(*spec)
    if name in _HEADS_IN and ndim == 2:
        if heads_shardable and _divisible(shape[0], tp):
            spec[0] = model_axis
        fsdp_remaining()
        return P(*spec)

    if name in _FF_OUT and ndim == 2:
        if _divisible(shape[1], tp):
            spec[1] = model_axis
        fsdp_remaining()
        return P(*spec)
    if name in _FF_IN and ndim == 2:
        if _divisible(shape[0], tp):
            spec[0] = model_axis
        fsdp_remaining()
        return P(*spec)

    # MLA latents: shard the head-structured output dims
    if name in ("w_uk", "w_uv") and ndim == 2:
        if _divisible(cfg.n_heads, tp) and _divisible(shape[1], tp):
            spec[1] = model_axis
        fsdp_remaining()
        return P(*spec)
    if name in ("w_dq", "w_dkv", "w_kr") and ndim == 2:
        fsdp_remaining()
        return P(*spec)

    if ndim >= 2:
        fsdp_remaining()
    return P(*spec)


def _axes(cfg, mesh, model_axis: str) -> tuple[dict, tuple, int, int]:
    """(axis sizes, data axes, tp, fsdp) of a mesh under ``cfg``:
    ``prefer_pure_dp`` folds the model axis into the data axes."""
    sizes = axis_sizes(mesh)
    if getattr(cfg, "prefer_pure_dp", False):
        tp, data_axes = 1, tuple(sizes)
    else:
        tp = sizes[model_axis]
        data_axes = tuple(a for a in sizes if a != model_axis)
    return sizes, data_axes, tp, math.prod(sizes[a] for a in data_axes)


def _stacked(path_s: str) -> bool:
    return path_s.startswith("units/") or "/blocks/" in path_s \
        or path_s.startswith("encoder/blocks")


def tree_specs(tree: dict, cfg, mesh, *, model_axis: str = "model",
               per_layer: bool = False) -> dict:
    """The specs of a parameter tree in the JAX package's layout (nested
    dicts; each leaf anything with a ``shape``), as ``param_specs`` of the
    JAX package gives them: a stacked leaf's ``P(None, *inner)``.  With
    ``per_layer`` a stacked leaf gets a list of its layers' ``inner``
    instead, the form ``convert.lm_named`` maps to the port's names."""
    _, data_axes, tp, fsdp = _axes(cfg, mesh, model_axis)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        shape = tuple(node.shape)
        if _stacked(path) and len(shape) >= 2:
            inner = infer_param_spec(
                path, shape[1:], cfg, tp=tp, fsdp=fsdp, data_axes=data_axes,
                model_axis=model_axis)
            return [inner] * shape[0] if per_layer else P(None, *inner)
        return infer_param_spec(path, shape, cfg, tp=tp, fsdp=fsdp,
                                data_axes=data_axes, model_axis=model_axis)

    return walk(tree, "")


def param_specs(named: dict[str, torch.Tensor], cfg, mesh, *,
                model_axis: str = "model") -> dict[str, PartitionSpec]:
    """{parameter name: PartitionSpec} of the port's parameters
    (``models.model.param_tree``: tensors, DTensors or meta tensors; only
    their shapes are read)."""
    from repro_torch import convert

    meta = {n: torch.empty(tuple(t.shape), device="meta")
            for n, t in named.items()}
    specs = tree_specs(convert.lm_tree(meta, cfg), cfg, mesh,
                       model_axis=model_axis, per_layer=True)
    return convert.lm_named(specs, cfg)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: what ``jax.sharding.NamedSharding`` is
    to the JAX package."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that tensor dimension d names, ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def param_shardings(named: dict[str, torch.Tensor], cfg, mesh,
                    **kw) -> dict[str, NamedSharding]:
    """{parameter name: NamedSharding} of ``param_specs`` on the
    ``DeviceMesh``."""
    return {n: NamedSharding(mesh, s)
            for n, s in param_specs(named, cfg, mesh, **kw).items()}


def _data_spec(cfg, mesh, model_axis: str):
    sizes, data_axes, tp, dsz = _axes(cfg, mesh, model_axis)
    return (data_axes if len(data_axes) > 1 else data_axes[0]), tp, dsz


def batch_specs(cfg, mesh, *, kind: str, model_axis: str = "model"
                ) -> dict[str, PartitionSpec]:
    """PartitionSpecs of a step's inputs (tokens/labels/frames/pos...)."""
    dspec, _, _ = _data_spec(cfg, mesh, model_axis)
    bs = P(dspec, None)
    specs = {"tokens": bs, "labels": bs, "loss_mask": bs}
    if cfg.is_encoder_decoder:
        specs["frames"] = P(dspec, None, None)
    if cfg.mrope:
        specs["mrope_positions"] = P(None, dspec, None)
    if kind == "decode":
        specs["pos"] = P(dspec)
    return specs


def path_items(node, path: str = ""):
    """(path, leaf) of every leaf with a shape, paths joined by ``/``."""
    if hasattr(node, "shape") and not isinstance(node, (dict, list, tuple)):
        yield path, node
        return
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    elif dataclasses.is_dataclass(node):
        items = ((f.name, getattr(node, f.name))
                 for f in dataclasses.fields(node))
    else:
        return
    for k, v in items:
        yield from path_items(v, f"{path}/{k}" if path else str(k))


def cache_specs(caches: Any, cfg, mesh, *, model_axis: str = "model"
                ) -> dict[str, PartitionSpec]:
    """{leaf path: PartitionSpec} of a tree of decode caches: batch over
    the data axes when divisible, else the longest sequence-like dim over
    them (long-context batch 1), KV heads over model when divisible.  A
    leaf under ``units`` (the JAX package's stacked caches) keeps its
    leading unit axis unsharded; the port's per-layer caches have none."""
    dspec, tp, dsz = _data_spec(cfg, mesh, model_axis)

    def leaf_spec(path, shape):
        spec = [None] * len(shape)
        bdim = 1 if "units" in path else 0
        if len(shape) > bdim and _divisible(shape[bdim], dsz):
            spec[bdim] = dspec
            if tp > 1:
                for i in range(bdim + 1, len(shape)):
                    if _divisible(shape[i], tp) and shape[i] >= tp \
                            and i >= bdim + 2:
                        spec[i] = model_axis
                        break
        else:
            order = sorted(range(bdim, len(shape)), key=lambda i: -shape[i])
            for i in order:
                if _divisible(shape[i], dsz) and shape[i] >= dsz:
                    spec[i] = dspec
                    break
        return P(*spec)

    return {path: leaf_spec(path, tuple(leaf.shape))
            for path, leaf in path_items(caches)}


# ---------------------------------------------------------------------------
# whole tensors <-> DTensors
# ---------------------------------------------------------------------------

def local_slices(shape: tuple, sharding: NamedSharding) -> tuple:
    """This rank's block of a tensor of ``shape`` under ``sharding``: a
    slice per dimension (the mesh dimensions that shard one tensor
    dimension nest in mesh order, the first outermost)."""
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not one of the sharding's mesh")
    index = [slice(None)] * len(shape)
    for d in range(len(shape)):
        pos, n = 0, 1
        for i, pl in enumerate(sharding.placements):
            if pl.is_shard(d):
                pos, n = pos * mesh.shape[i] + coord[i], n * mesh.shape[i]
        if n > 1:
            if shape[d] % n:
                raise ValueError(f"dim {d} of {shape} does not divide by "
                                 f"{n} shards")
            m = shape[d] // n
            index[d] = slice(pos * m, (pos + 1) * m)
    return tuple(index)


def place(full: torch.Tensor, sharding: NamedSharding, *,
          device: torch.device | None = None):
    """A DTensor of ``full`` (whole on every rank) under ``sharding``: this
    rank's block, copied to ``device`` (the tensor's own by default); no
    communication."""
    from torch.distributed.tensor import DTensor

    local = full[local_slices(tuple(full.shape), sharding)]
    local = local.to(device) if device is not None else local
    return DTensor.from_local(local.contiguous(), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


def gather(x) -> torch.Tensor:
    """The whole tensor of a DTensor, on every rank of its mesh, through
    ``parallel.collectives`` (gloo's CUDA rules); a plain tensor as it
    is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import collectives

    if not isinstance(x, DTensor):
        return x
    mesh, out = x.device_mesh, x.to_local()
    # innermost mesh dimension first, so each gather undoes one level of
    # the nesting
    for i in reversed(range(mesh.ndim)):
        pl = x.placements[i]
        if pl.is_shard():
            g = mesh.get_group(i)
            out = collectives.all_gather_tensor(
                out.movedim(pl.dim, 0), g).movedim(0, pl.dim)
    return out.contiguous()


# ---------------------------------------------------------------------------
# a sharded step's views of its parameters
# ---------------------------------------------------------------------------

_TP_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_TP_MLP = ("w_gate", "w_up", "w_down")


def _keeps_model_shard(name: str, cfg, parallel, tp: bool) -> bool:
    """Whether a parameter's view keeps this rank's slice over the model
    axis: a GQA attention projection or an MLP matrix in a step that runs
    them tensor-parallel (``tp``), an expert matrix under ``use_ep``."""
    parts = name.split(".")
    module, leaf = (parts[-2], parts[-1]) if len(parts) > 1 else ("", name)
    if module == "attn" and leaf in _TP_ATTN:
        return tp and not cfg.mla
    if module == "mlp" and leaf in _TP_MLP:
        return tp
    return module == "moe" and leaf in _TP_MLP and parallel.use_ep


class _View(torch.autograd.Function):
    """A DTensor parameter's local shard -> the view a step computes with:
    gathered over every mesh dimension that shards it (the innermost
    first), but the model axis where ``keep_model``.  The gradient: over
    the batch axes, the ranks' gradients summed (reduce-scatter where the
    axis shards the parameter, all-reduce where it does not); over the
    model axis, where the view is gathered, this rank's slice (every rank
    there holds the same gradient), where it is kept, nothing, and where
    the parameter is replicated, nothing, or the sum where ``sum_model``
    (a replicated weight applied to this rank's heads only)."""

    @staticmethod
    def forward(ctx, local, mesh, placements, batch_dims, model_dim,
                keep_model, sum_model):
        from repro_torch.parallel import collectives

        ctx.args = (mesh, placements, batch_dims, model_dim, keep_model,
                    sum_model)
        out = local
        for i in reversed(range(mesh.ndim)):
            pl = placements[i]
            if pl.is_shard() and not (i == model_dim and keep_model):
                out = collectives.all_gather_tensor(
                    out.movedim(pl.dim, 0).contiguous(),
                    mesh.get_group(i)).movedim(0, pl.dim)
        return out.contiguous()

    @staticmethod
    def backward(ctx, g):
        from repro_torch.parallel import collectives

        mesh, placements, batch_dims, model_dim, keep_model, sum_model = \
            ctx.args
        for i in range(mesh.ndim):
            pl, group = placements[i], mesh.get_group(i)
            if i in batch_dims:
                if pl.is_shard():
                    g = collectives.reduce_scatter_tensor(
                        g.movedim(pl.dim, 0).contiguous(),
                        group).movedim(0, pl.dim)
                else:
                    g = collectives.all_reduce_sum(g, group)
            elif i == model_dim:
                if pl.is_shard() and not keep_model:
                    n, r = mesh.shape[i], mesh.get_local_rank(i)
                    m = g.shape[pl.dim] // n
                    g = g.narrow(pl.dim, r * m, m)
                elif not pl.is_shard() and sum_model:
                    g = collectives.all_reduce_sum(g, group)
        return g.contiguous(), None, None, None, None, None, None


def local_views(params: dict, cfg, parallel, *, tp: bool = True
                ) -> tuple[dict, dict]:
    """(leaves, views) of a model's DTensor parameters (``param_tree``):
    ``leaves`` each one's local shard, detached, requiring grad (the
    tensors a step differentiates and updates), ``views`` what the model
    computes with (``_View``): the whole parameter, or, with ``tp``, a
    tensor-parallel attention projection's or MLP's slice over the model
    axis (its heads), and under ``use_ep`` the experts' slice.  A plain
    tensor is its own leaf and view."""
    from torch.distributed.tensor import DTensor

    names = parallel.mesh.mesh_dim_names
    batch_dims = tuple(names.index(a) for a in parallel.batch_axes)
    model_dim = (names.index(parallel.model_axis)
                 if parallel.model_axis in names and not parallel.pure_dp
                 else -1)
    leaves, views = {}, {}
    keep = {n: isinstance(p, DTensor) and model_dim >= 0
            and p.placements[model_dim].is_shard()
            and _keeps_model_shard(n, cfg, parallel, tp)
            for n, p in params.items()}
    for name, p in params.items():
        if not isinstance(p, DTensor):
            leaves[name] = views[name] = p
            continue
        leaf = p.to_local().detach().requires_grad_(True)
        prefix, _, short = name.rpartition(".")
        # replicated weights whose gradient is each rank's part: the norms
        # of this rank's heads, the router and shared experts under EP
        sum_model = (short in ("q_norm", "k_norm")
                     and keep.get(f"{prefix}.wq", False)) or (
            parallel.use_ep and ".moe." in f".{name}"
            and (short == "router" or ".moe.shared." in f".{name}"))
        leaves[name] = leaf
        views[name] = _View.apply(leaf, parallel.mesh, list(p.placements),
                                  batch_dims, model_dim, keep[name],
                                  sum_model)
    return leaves, views


def place_params(model, shardings: dict[str, NamedSharding]) -> None:
    """Replace each of the model's parameters (``param_tree``'s names) by
    its DTensor under ``shardings`` (``param_shardings``): this rank's
    block, no communication."""
    from torch import nn

    for name, p in list(model.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        owner._parameters[leaf] = nn.Parameter(
            place(p.detach(), shardings[name]), requires_grad=False)


def local_tree(params: dict) -> dict:
    """Each parameter's local shard (a plain tensor as it is): the tree a
    sharded step's optimizer state mirrors."""
    from torch.distributed.tensor import DTensor

    return {n: p.to_local() if isinstance(p, DTensor) else p
            for n, p in params.items()}


@contextlib.contextmanager
def materialized(model, cfg, parallel, *, tp: bool = True):
    """The model with its parameters replaced by ``local_views`` for the
    duration (no gradient kept)."""
    from torch.nn.utils.stateless import _reparametrize_module

    from repro_torch.models import model as model_lib

    with torch.no_grad():
        _, views = local_views(model_lib.param_tree(model), cfg, parallel,
                               tp=tp)
    with _reparametrize_module(model, views):
        yield model
