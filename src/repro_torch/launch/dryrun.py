"""The dry run of the port: every cell (arch x shape x mesh) of
``src/repro/launch/dryrun.py``, sized for one device of the production
mesh.

For each cell it
  1. specialises the arch's config to the shape (``cell_config``:
     aggregated KV at ``long_500k`` where the arch has attention, and the
     ``VARIANTS``),
  2. builds stand-ins of the step's arguments on the ``meta`` device, so
     that nothing is allocated: the parameters (``models.model.LM``),
     AdamW's state for a train cell (``optim.init_state``: f32 ``m`` and
     ``v`` and an int32 step), the batch (``input_specs``) and a decode
     cell's caches,
  3. gives each its spec on the production mesh, 16 x 16 or 2 x 16 x 16
     (``parallel.sharding``'s rules, through ``_guard_spec``), the mesh
     taken as its axis sizes: no world and no ranks,
  4. records one device's bytes of each argument, its local block.

The JAX package compiles each step with XLA and records
``memory_analysis()``, ``cost_analysis()`` and the collectives of the
compiled HLO.  Eager PyTorch compiles nothing, so the compile time, the
cost analysis, XLA's temporary and output bytes and the collective census
have no counterpart here (``NO_COUNTERPART``), nor has the calibration
that corrects XLA's cost analysis.  XLA's ``argument_size_in_bytes`` is
the bytes of the arguments the step reads: ``jax.jit`` drops an argument
that the step never reads, so the record counts those apart as
``unused`` (``_unused``: whisper's encoder in decode, xLSTM's positions).

``allocate_on_card`` allocates one device's blocks of a cell on the card:
the proof that one device of every cell fits one H100.  ``build_cell``
builds a cell's arguments for real (``init_params``, ``optim.init_state``,
``init_caches``) at a cut depth on one device, and ``compare_build`` holds
them against ``cell_leaves`` on a mesh of one device, leaf by leaf: that
the stand-ins are the tensors the port allocates.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape decode_32k --mesh multi
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch import optim
from repro_torch.configs import (
    ARCH_NAMES, SHAPES, active_param_count, get_config, param_count,
)
from repro_torch.device import resolve
from repro_torch.launch.mesh import PRODUCTION_SHAPES, axis_sizes
from repro_torch.models import aggregated_kv, layers, transformer
from repro_torch.models import model as model_lib
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import PartitionSpec as P

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
META = torch.device("meta")
GROUPS = ("params", "optimizer", "batch", "caches")
# the JAX package's record keys that only an XLA compile fills in
NO_COUNTERPART = (
    "compile_seconds", "cost", "collectives",
    "memory.output_size_in_bytes", "memory.temp_size_in_bytes",
    "memory.generated_code_size_in_bytes", "memory.alias_size_in_bytes",
)

# §Perf variants: per-arch beyond-baseline optimizations (EXPERIMENTS.md)
VARIANTS = {
    "opt": {
        "deepseek-v2-236b": {"moe_dispatch": "all_to_all"},
        "moonshot-v1-16b-a3b": {"moe_dispatch": "all_to_all"},
        "xlstm-350m": {"prefer_pure_dp": True},
        # decode cells additionally switch the aggregated cache layout
        "_agg_layout": "bucket_major",
    },
}


def cell_config(arch: str, shape_name: str, variant: str | None = None):
    """Arch config specialized for the shape cell (DESIGN.md §5)."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        has_attention = any(
            k in ("attn", "attn_local", "attn_global", "shared_attn")
            for k in cfg.block_kinds()
        )
        if has_attention:
            # the paper's technique provides the sub-quadratic decode path
            cfg = cfg.with_(agg_kv=True)
    if variant:
        over = VARIANTS[variant].get(arch, {})
        if over:
            cfg = cfg.with_(**over)
        if cfg.agg_kv and "_agg_layout" in VARIANTS[variant]:
            cfg = cfg.with_(agg_layout=VARIANTS[variant]["_agg_layout"])
    return cfg


def production_mesh(multi_pod: bool) -> dict[str, int]:
    """{axis name: size} of the 16 x 16 or 2 x 16 x 16 mesh."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return dict(zip(axes, shape))


def mesh_name(multi_pod: bool) -> str:
    return "x".join(str(n) for n in PRODUCTION_SHAPES[multi_pod][0])


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg, shape_cfg) -> dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this cell."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    i32 = torch.int32
    if shape_cfg.kind in ("train", "prefill"):
        specs = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
        if cfg.is_encoder_decoder:
            specs["frames"] = _meta((b, s, cfg.d_model),
                                    layers.torch_dtype(cfg.dtype))
        if cfg.mrope:
            specs["mrope_positions"] = _meta((3, b, s), i32)
        if shape_cfg.kind == "prefill":
            specs.pop("labels")
        return specs
    # decode: one new token against an S-long cache
    specs = {"tokens": _meta((b, 1), i32), "pos": _meta((b,), i32)}
    if cfg.mrope:
        specs["mrope_positions"] = _meta((3, b, 1), i32)
    return specs


def _guard_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop mesh axes that don't divide the corresponding dim."""
    sizes = axis_sizes(mesh)
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        sz = math.prod(sizes[a] for a in axes)
        if i < len(shape) and shape[i] % sz == 0 and shape[i] >= sz:
            out.append(ax)
        else:
            out.append(None)
    out += [None] * (len(shape) - len(out))
    return P(*out[: len(shape)])


def local_shape(shape: tuple, spec: P, mesh) -> tuple:
    """One device's block of a tensor of ``shape`` under a guarded spec."""
    sizes = axis_sizes(mesh)
    return tuple(
        d // math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                          else (ax,)))
        if ax is not None else d
        for d, ax in zip(shape, spec))


class Leaf(NamedTuple):
    """One argument tensor of a cell's step."""

    group: str              # one of GROUPS
    name: str               # parameter name, "m.<name>", batch key, path
    shape: tuple            # the whole tensor's
    local: tuple            # one device's block
    dtype: torch.dtype
    used: bool              # whether the step reads it

    @property
    def nbytes(self) -> int:
        return math.prod(self.local) * self.dtype.itemsize


def _unused(cfg, kind: str, group: str, name: str) -> bool:
    """Whether the step of ``kind`` never reads this argument (what
    ``jax.jit`` leaves out of XLA's arguments).  A train step reads every
    parameter in its update."""
    if group == "params" and cfg.is_encoder_decoder and kind != "train":
        parts = name.split(".")
        if parts[0] == "encoder":
            # decode never runs the encoder; the encoder never applies the
            # cross-attention weights its blocks carry
            return kind == "decode" or parts[3:4] in (["cross"],
                                                       ["cross_norm"])
        # decode attends to the cross caches: the memory's K and V
        # projections are not applied
        return (kind == "decode" and parts[2:3] == ["cross"]
                and parts[3] in ("wk", "wv"))
    if group == "batch" and kind == "decode":
        kinds = model_lib.block_kinds(cfg)
        if name == "pos":
            # read by attention, its cache and the sinusoidal positions
            return not cfg.is_encoder_decoder and not any(
                k in transformer.ATTN_KINDS for k in kinds)
        if name == "mrope_positions":
            # only exact (non-aggregated) attention rotates by the grid
            return all(transformer.uses_agg(cfg, k) for k in kinds
                       if k in transformer.ATTN_KINDS)
    return False


def meta_caches(cfg, *, batch: int, s_max: int) -> list:
    """``models.model.init_caches``' caches on ``meta``, with meta LSH
    draws for the aggregated layers."""
    n_kv, dk, _ = transformer.cache_dims(cfg)
    lsh = [aggregated_kv.draw_lsh(None, n_kv=n_kv, dk=dk, device=META)
           if transformer.aggregatable(cfg, kind) else None
           for kind in model_lib.block_kinds(cfg)]
    return model_lib._empty_caches(cfg, batch=batch, s_max=s_max, lsh=lsh,
                                   dev=META)


def cell_leaves(cfg, shape_cfg, mesh) -> list[Leaf]:
    """Every argument of the cell's step, with one device's block of it
    on ``mesh`` (a ``DeviceMesh`` or a mapping of axis sizes)."""
    kind = shape_cfg.kind
    out: list[Leaf] = []

    def add(group, name, t, spec):
        spec = _guard_spec(spec, tuple(t.shape), mesh)
        out.append(Leaf(group, name, tuple(t.shape),
                        local_shape(tuple(t.shape), spec, mesh), t.dtype,
                        not _unused(cfg, kind, group, name)))

    model = model_lib.LM(layers.Init(None, dtype=layers.torch_dtype(
        cfg.dtype), device=META), cfg)
    params = model_lib.param_tree(model)
    p_specs = sharding.param_specs(params, cfg, mesh)
    for name, t in params.items():
        add("params", name, t, p_specs[name])
    if kind == "train":
        state = optim.init_state(params)
        add("optimizer", "step", state.step, P())
        for moment in ("m", "v"):
            for name, t in getattr(state, moment).items():
                add("optimizer", f"{moment}.{name}", t, p_specs[name])
    b_specs = sharding.batch_specs(cfg, mesh, kind=kind)
    for key, t in input_specs(cfg, shape_cfg).items():
        add("batch", key, t, b_specs.get(key, P(*([None] * t.dim()))))
    if kind == "decode":
        caches = meta_caches(cfg, batch=shape_cfg.global_batch,
                             s_max=shape_cfg.seq_len)
        c_specs = sharding.cache_specs(caches, cfg, mesh)
        for path, t in sharding.path_items(caches):
            add("caches", path, t, c_specs[path])
    return out


def _leaves(arch, shape_name, multi_pod, variant):
    cfg = cell_config(arch, shape_name, variant)
    return cfg, cell_leaves(cfg, SHAPES[shape_name],
                            production_mesh(multi_pod))


def _path(arch: str, shape_name: str, multi_pod: bool,
          variant: str | None) -> Path:
    tag = "multi" if multi_pod else "single"
    if variant:
        tag = f"{tag}__{variant}"
    return RESULTS_DIR / f"{arch}__{shape_name}__{tag}.json"


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             *, save: bool = True, verbose: bool = True,
             variant: str | None = None) -> dict:
    """The cell's record: the JAX package's keys where they mean the same
    thing, ``memory`` one device's bytes of the step's arguments."""
    shape_cfg = SHAPES[shape_name]
    cfg, leaves = _leaves(arch, shape_name, multi_pod, variant)
    memory = {g: sum(lf.nbytes for lf in leaves if lf.group == g)
              for g in GROUPS}
    memory["unused"] = sum(lf.nbytes for lf in leaves if not lf.used)
    memory["argument_size_in_bytes"] = sum(lf.nbytes for lf in leaves
                                           if lf.used)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "kind": shape_cfg.kind,
        "agg_kv": cfg.agg_kv,
        "tokens": shape_cfg.tokens,
        "params": param_count(cfg),
        "active_params": active_param_count(cfg),
        "memory": memory,
        "no_counterpart": list(NO_COUNTERPART),
    }
    if verbose:
        print(json.dumps(result, indent=2))
    if save:
        out = _path(arch, shape_name, multi_pod, variant)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
        if verbose:
            print(f"wrote {out}")
    return result


def run_all(meshes=("single", "multi"), archs=None, shapes=None,
            skip_existing=True, *, save: bool = True) -> list[dict]:
    """Every cell, in this process (nothing is compiled, so no cell needs
    a heap of its own); a cell whose record exists is read back unless
    ``skip_existing`` is off.  Returns the records."""
    archs = archs or ARCH_NAMES
    shapes = shapes if shapes is not None else list(SHAPES)
    records = []
    for mesh_tag in meshes:
        multi = mesh_tag == "multi"
        for arch in archs:
            for shape in shapes:
                out = _path(arch, shape, multi, None)
                if save and skip_existing and out.exists():
                    records.append(json.loads(out.read_text()))
                    continue
                records.append(run_cell(arch, shape, multi, save=save,
                                        verbose=False))
    return records


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def allocate_on_card(arch: str, shape_name: str, multi_pod: bool, *,
                     device: str | torch.device = "cuda",
                     variant: str | None = None) -> dict:
    """Allocate one device's block of every argument of the cell on the
    card (``torch.empty`` in each leaf's dtype), free them, and return
    ``bytes`` (the blocks' bytes: the record's arguments, ``unused``
    included) and ``allocated`` (how far ``torch.cuda.memory_allocated``
    grew: the caching allocator's blocks).  Where one device's blocks do
    not fit the card, the allocator's out-of-memory error is raised.  No
    kernel runs."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"allocate_on_card measures the card's caching "
                         f"allocator; got device {dev}")
    _, leaves = _leaves(arch, shape_name, multi_pod, variant)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    blocks = [torch.empty(lf.local, dtype=lf.dtype, device=dev)
              for lf in leaves]
    allocated = torch.cuda.memory_allocated(dev) - before
    del blocks
    torch.cuda.empty_cache()
    return {"bytes": sum(lf.nbytes for lf in leaves), "allocated": allocated}


# ---------------------------------------------------------------------------
# the stand-ins against a real build
# ---------------------------------------------------------------------------

def one_device() -> dict[str, int]:
    """The 16 x 16 mesh's axes, each of size 1: every block is whole."""
    return dict.fromkeys(production_mesh(False), 1)


def cut_depth(cfg):
    """``cfg`` at the least depth that keeps each kind of block: the
    pattern once, the leading dense layers and one more, two encoder
    layers."""
    over = {"n_layers": min(cfg.n_layers, max(
        2, len(cfg.pattern), cfg.first_k_dense + 1))}
    if cfg.is_encoder_decoder:
        over["n_encoder_layers"] = min(cfg.n_encoder_layers, 2)
    return cfg.with_(**over)


def build_cell(cfg, shape_cfg, *, device: str | torch.device = "cuda",
               seed: int = 0) -> list[tuple[str, str, torch.Tensor]]:
    """The cell's step arguments built for real on one device, (group,
    name, tensor): the parameters (``models.model.init_params``), AdamW's
    state for a train cell (``optim.init_state``) and a decode cell's
    caches (``init_caches``, ``draw_lsh`` for the aggregated layers).  The
    batch is data and is left out."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.param_tree(model_lib.init_params(cfg, gen,
                                                        device=dev))
    out = [("params", name, t.detach()) for name, t in params.items()]
    if shape_cfg.kind == "train":
        state = optim.init_state(params)
        out.append(("optimizer", "step", state.step))
        for moment in ("m", "v"):
            out += [("optimizer", f"{moment}.{name}", t)
                    for name, t in getattr(state, moment).items()]
    if shape_cfg.kind == "decode":
        lsh = model_lib.draw_lsh(cfg, gen, device=dev) if cfg.agg_kv else None
        caches = model_lib.init_caches(cfg, batch=shape_cfg.global_batch,
                                       s_max=shape_cfg.seq_len, lsh=lsh,
                                       device=dev)
        out += [("caches", path, t)
                for path, t in sharding.path_items(caches)]
    return out


def compare_build(cfg, shape_cfg, built) -> dict:
    """``build_cell``'s tensors against ``cell_leaves`` on one device, the
    batch aside: ``mismatches`` lists each leaf whose name, shape or dtype
    differs, ``bytes`` the real tensors' storage bytes by group and
    ``counted`` the stand-ins' ``nbytes`` by group."""
    want = {(lf.group, lf.name): (lf.local, lf.dtype)
            for lf in cell_leaves(cfg, shape_cfg, one_device())
            if lf.group != "batch"}
    got = {(g, name): (tuple(t.shape), t.dtype) for g, name, t in built}
    mismatches = [f"{g} {name}: built {got.get((g, name))}, counted "
                  f"{want.get((g, name))}"
                  for g, name in sorted(want.keys() | got.keys())
                  if got.get((g, name)) != want.get((g, name))]
    groups = [g for g in GROUPS if g != "batch"]
    storages = {}
    for g, _, t in built:
        storages[t.untyped_storage().data_ptr()] = (
            g, t.untyped_storage().nbytes())
    return {
        "mismatches": mismatches,
        "bytes": {g: sum(n for gg, n in storages.values() if gg == g)
                  for g in groups},
        "counted": {g: sum(math.prod(local) * dtype.itemsize
                           for (gg, _), (local, dtype) in want.items()
                           if gg == g)
                    for g in groups},
    }


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--variant", choices=list(VARIANTS))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.calibrate:
        print("dryrun: --calibrate corrects XLA's cost analysis, which has "
              "no counterpart in the port (nothing is compiled)",
              file=sys.stderr)
        return 2
    if args.all:
        records = run_all(archs=[args.arch] if args.arch else None,
                          shapes=[args.shape] if args.shape else None,
                          skip_existing=not args.force)
        print(f"{len(records)} cells under {RESULTS_DIR}")
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    run_cell(args.arch, args.shape, args.mesh == "multi",
             variant=args.variant)
    return 0


if __name__ == "__main__":
    sys.exit(main())
