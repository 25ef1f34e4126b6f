"""Turn the JAX package's parameters, given as numpy arrays, into the port's,
and a language model's parameters and train state back into the JAX
package's trees.

The port's parameter names are the JAX package's keys (``attn.w_dq``,
``moe.router``, ``moe.w_gate`` stacked over the experts, ``moe.shared``,
``mixer.a_log``, ``cross.wq``...), so every model's block leaves map by
name alike; the shared-attention block (``shared_attn``) and the encoder
(``encoder.blocks``, stacked over its layers there, and
``encoder.final_norm``) map to the JAX package's top-level entries.

JAX's PRNG bits cannot be reproduced in torch, so a comparison of the two
packages draws once on the JAX side and hands the draws over: LSH
projections for ``run_accurateml(lsh_params=...)``, prepared aggregates
for ``accurateml_map`` (kNN and CF), an aggregate store's level-0 state
from a snapshot (``store_level0_from_numpy``), a language model's weights
(``lm_params_from_numpy``) and its decode caches' per-layer LSH draws
(``lm_cache_lsh_from_numpy``).  Arrays are copied; dtypes are those the
port uses (float32 values, int32 indices and counts, the model's dtype for
its weights).

The other way, ``lm_tree`` turns anything keyed by the port's parameter
names (the parameters, their gradients, AdamW's moments) into the JAX
package's parameter tree, the pattern units stacked on a leading axis;
``lm_params_to_numpy`` does it for a model, as numpy.  ``train_state_tree``
and ``train_state_from_tree`` map a train state, ``{"params", "opt"}``,
both ways, so a checkpoint of either package restores into the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.cf import CFAggregates
from repro_torch.apps.knn import KNNAggregates
from repro_torch.core.aggregate import AggregatedData, BucketIndex
from repro_torch.core.lsh import LSHConfig, LSHParams
from repro_torch.device import resolve
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.optim import AdamState


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)


def _i32(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.int32), device=dev)


def lsh_params_from_numpy(
    a, b, *, n_hashes: int, bucket_width: float, n_buckets: int,
    base_buckets: int | None = None, device: str | torch.device = "cuda",
) -> LSHParams:
    """[D, H] projections ``a`` and [H] offsets ``b`` -> ``LSHParams``."""
    dev = resolve(device)
    config = LSHConfig(
        n_hashes=n_hashes, bucket_width=bucket_width, n_buckets=n_buckets,
        base_buckets=base_buckets,
    )
    a, b = _f32(a, dev), _f32(b, dev)
    if a.shape[1:] != (n_hashes,) or b.shape != (n_hashes,):
        raise ValueError(
            f"a {tuple(a.shape)} / b {tuple(b.shape)} do not match "
            f"n_hashes={n_hashes}"
        )
    return LSHParams(a=a, b=b, config=config)


def knn_aggregates_from_numpy(
    means, counts, perm, offsets, bucket_of, bucket_labels, spread,
    dispersion, *, device: str | torch.device = "cuda",
) -> KNNAggregates:
    """The fields of a JAX ``KNNAggregates`` -> the port's."""
    dev = resolve(device)
    agg = AggregatedData(
        means=_f32(means, dev), counts=_i32(counts, dev),
        perm=_i32(perm, dev), offsets=_i32(offsets, dev),
        bucket_of=_i32(bucket_of, dev),
    )
    return KNNAggregates(
        agg=agg, bucket_labels=_i32(bucket_labels, dev),
        spread=_f32(spread, dev), dispersion=_f32(dispersion, dev),
    )


def cf_aggregates_from_numpy(
    means, counts, perm, offsets, bucket_of, profile, profile_mask, s, c,
    cvar, *, device: str | torch.device = "cuda",
) -> CFAggregates:
    """The fields of a JAX ``CFAggregates`` -> the port's."""
    dev = resolve(device)
    agg = AggregatedData(
        means=_f32(means, dev), counts=_i32(counts, dev),
        perm=_i32(perm, dev), offsets=_i32(offsets, dev),
        bucket_of=_i32(bucket_of, dev),
    )
    return CFAggregates(
        agg=agg, profile=_f32(profile, dev),
        profile_mask=_f32(profile_mask, dev), s=_f32(s, dev),
        c=_f32(c, dev), cvar=_f32(cvar, dev),
    )


def store_level0_from_numpy(
    npz, *, device: str | torch.device = "cuda",
) -> tuple[dict[str, torch.Tensor], BucketIndex]:
    """One pyramid's arrays of a ``save_store`` snapshot (an opened ``.npz``
    or any mapping with its keys: ``stats/<name>``, ``index/perm``,
    ``index/offsets``, ``index/bucket_of``) -> (level-0 stats, index) for
    ``knn_assemble`` / ``cf_assemble`` or ``AggregateStore.adopt``.
    ``counts`` and the index are int32, the other stats float32."""
    dev = resolve(device)
    stats = {}
    for key in npz.keys():
        if key.startswith("stats/"):
            name = key[len("stats/"):]
            stats[name] = (_i32 if name == "counts" else _f32)(npz[key], dev)
    if "counts" not in stats:
        raise ValueError("snapshot arrays have no stats/counts")
    index = BucketIndex(perm=_i32(npz["index/perm"], dev),
                        offsets=_i32(npz["index/offsets"], dev),
                        bucket_of=_i32(npz["index/bucket_of"], dev))
    return stats, index


def _layer_trees(tree: dict, cfg, head: str, units: str, tail: str) -> list:
    """The per-layer subtrees of a JAX stack pytree, in stack order: head
    blocks, then each unit's pattern blocks (the unit axis of the stacked
    ``units`` leaves indexed away), then tail blocks; None where the tree
    has no entry (a parameter tree's shared-attention slots)."""
    head_kinds, pat, n_units, tail_kinds = model_lib._stack_layout(cfg)
    out = [tree[head][str(i)] for i in range(len(head_kinds))]
    for u in range(n_units):
        for i in range(len(pat)):
            out.append(_index(tree[units].get(f"b{i}"), u))
    out += [tree[tail].get(str(i)) for i in range(len(tail_kinds))]
    return out


def _index(node, u: int):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _index(v, u) for k, v in node.items()}
    if isinstance(node, (torch.Tensor, list)):
        return node[u]
    return np.asarray(node)[u]


def _load(param: torch.Tensor, arr, name: str) -> None:
    """Copy ``arr`` (numpy, or a tensor of any dtype: a bf16 one keeps its
    bits) into ``param``."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.tensor(np.asarray(arr, dtype=np.float32))
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                         f"{tuple(param.shape)}")
    param.data.copy_(arr.to(param.dtype))


def lm_params_from_numpy(tree: dict, cfg, *,
                         device: str | torch.device = "cuda"):
    """The JAX package's ``repro.models.init_params`` pytree, as numpy with
    its stacked ``units``, -> the port's ``LM`` module in ``cfg.dtype``."""
    dev = resolve(device)
    model = model_lib.LM(
        layers.Init(None, dtype=layers.torch_dtype(cfg.dtype), device=dev),
        cfg)
    named = lm_named(tree, cfg)
    for name, param in model.named_parameters():
        _load(param, named[name], name)
    return model


def lm_cache_lsh_from_numpy(caches: dict, cfg, *,
                            device: str | torch.device = "cuda") -> list:
    """The per-layer LSH draws of the JAX package's decode caches
    (``repro.models.init_caches``, as numpy; each aggregated cache, an
    object or a dict, has ``lsh_a`` [Hkv*dk, H] and ``lsh_b`` [H], with a
    leading unit axis in ``units``)
    -> the port's list in stack order, for ``init_caches(lsh=)`` and
    ``DecodeEngine(lsh=)``: (a, b) for each layer whose cache is
    aggregated, None for the others (ring buffers, Mamba2 and xLSTM
    states; the cross-attention caches are not layers of the stack)."""
    dev = resolve(device)
    draws = {part: {name: _draws(node) for name, node in caches[part].items()}
             for part in ("head", "units", "tail")}
    return [None if c is None else (_f32(c["lsh_a"], dev),
                                    _f32(c["lsh_b"], dev))
            for c in _layer_trees(draws, cfg, "head", "units", "tail")]


def _draws(node) -> dict | None:
    """A layer's cache reduced to a dict of its LSH draws, None unless the
    cache is aggregated."""
    if isinstance(node, dict) and "lsh_a" in node:
        return {"lsh_a": node["lsh_a"], "lsh_b": node["lsh_b"]}
    if hasattr(node, "lsh_a"):
        return {"lsh_a": node.lsh_a, "lsh_b": node.lsh_b}
    return None


# ---------------------------------------------------------------------------
# the port's model and train state -> the JAX package's trees
# ---------------------------------------------------------------------------

def _set(node: dict, path: list[str], value) -> None:
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def lm_tree(named: dict, cfg) -> dict:
    """Tensors keyed by the port's parameter names (``param_tree``, its
    gradients or moments) -> the JAX package's parameter tree of the same
    tensors: ``embed``, ``final_norm``, ``lm_head``, ``head_blocks``,
    ``units`` (each pattern block's leaves stacked over the units; no
    entry for a shared-attention slot), ``tail_blocks``, ``shared_attn``
    and ``encoder`` (``blocks`` stacked over its layers,
    ``final_norm``)."""
    head_kinds, pat, n_units, tail_kinds = model_lib._stack_layout(cfg)
    n_blocks = len(head_kinds) + n_units * len(pat) + len(tail_kinds)
    blocks: list[dict] = [{} for _ in range(n_blocks)]
    encoder: list[dict] = [{} for _ in range(cfg.n_encoder_layers)]
    tree: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            _set(blocks[int(parts[1])], parts[2:], t)
        elif parts[:2] == ["encoder", "blocks"]:
            _set(encoder[int(parts[2])], parts[3:], t)
        else:
            _set(tree, parts, t)
    n_head = len(head_kinds)

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    tree["head_blocks"] = {str(i): blocks[i] for i in range(n_head)}
    tree["units"] = {
        f"b{j}": stack([blocks[n_head + u * len(pat) + j]
                        for u in range(n_units)])
        for j, kind in enumerate(pat) if kind != "shared_attn"
    } if n_units else {}
    tail0 = n_head + n_units * len(pat)
    tree["tail_blocks"] = {str(i): blocks[tail0 + i]
                           for i, kind in enumerate(tail_kinds)
                           if kind != "shared_attn"}
    if cfg.is_encoder_decoder:
        tree["encoder"]["blocks"] = stack(encoder)
    return tree


def lm_decayed(named: dict, cfg) -> dict[str, bool]:
    """Which of the port's parameters (``param_tree``) AdamW decays: the
    JAX package decays each leaf of its own tree with ``ndim >= 2``, and
    there a pattern block's leaves are stacked over the units and an
    encoder block's over the encoder's layers, so their norm weights are
    decayed while a head, tail or shared block's are not."""
    head_kinds, pat, n_units, _ = model_lib._stack_layout(cfg)
    lo = len(head_kinds)
    hi = lo + n_units * len(pat)
    out = {}
    for name, t in named.items():
        parts = name.split(".")
        stacked = (parts[0] == "blocks" and lo <= int(parts[1]) < hi) \
            or parts[:2] == ["encoder", "blocks"]
        out[name] = t.dim() + stacked >= 2
    return out


def lm_params_to_numpy(model, cfg) -> dict:
    """The inverse of ``lm_params_from_numpy``: the port's ``LM`` -> the
    JAX package's ``init_params`` tree as numpy, units stacked.  numpy has
    no bfloat16: bf16 weights come out as float32 (the same values)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map(host, lm_tree(model_lib.param_tree(model), cfg))


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    return fn(node)


def lm_named(tree: dict, cfg) -> dict:
    """The inverse of ``lm_tree``: a JAX-layout tree (numpy or tensors) ->
    its leaves by the port's parameter names (a unit's slice of a stacked
    leaf is a view)."""
    names = model_lib.LM(layers.Init(None, dtype=torch.float32,
                                     device=torch.device("meta")), cfg)
    blocks = _layer_trees(tree, cfg, "head_blocks", "units", "tail_blocks")
    out = {}
    for name, _ in names.named_parameters():
        parts = name.split(".")
        node = tree
        if parts[0] == "blocks":
            node, parts = blocks[int(parts[1])], parts[2:]
        elif parts[:2] == ["encoder", "blocks"]:
            node = _index(tree["encoder"]["blocks"], int(parts[2]))
            parts = parts[3:]
        for part in parts:
            node = node[part]
        out[name] = node
    return out


def _f32_named(tree: dict, cfg, dev) -> dict[str, torch.Tensor]:
    out = {}
    for name, arr in lm_named(tree, cfg).items():
        t = torch.zeros(tuple(np.shape(arr)), dtype=torch.float32,
                        device=dev)
        _load(t, arr, name)
        out[name] = t
    return out


def train_state_tree(state: dict, cfg) -> dict:
    """A train state of the port -> the JAX package's (its
    ``examples/train_lm.py`` layout), for ``Checkpointer.save``.

    ``state`` holds ``"params"`` (an ``LM``, or its ``param_tree``) and
    ``"opt"`` (an ``AdamState`` keyed like ``param_tree``), and may hold
    other entries (``"loss"``; ``"ef"``, already in the JAX layout), which
    are kept.  Keys come out as ``params/units/b0/attn/wq``,
    ``opt/.step``, ``opt/.m/embed``..."""
    params = state["params"]
    if isinstance(params, model_lib.LM):
        params = model_lib.param_tree(params)
    opt = state["opt"]
    return {**state, "params": lm_tree(params, cfg),
            "opt": AdamState(step=opt.step, m=lm_tree(opt.m, cfg),
                             v=lm_tree(opt.v, cfg))}


def train_state_from_tree(tree: dict, cfg, *,
                          device: str | torch.device = "cuda") -> dict:
    """The inverse of ``train_state_tree``: a JAX-layout train state (numpy
    or tensors: a restored checkpoint of either package) -> ``"params"``
    the port's ``LM`` in ``cfg.dtype``, ``"opt"`` its ``AdamState``, other
    entries as given."""
    dev = resolve(device)
    opt = tree["opt"]
    step = opt.step if isinstance(opt.step, torch.Tensor) \
        else torch.tensor(np.asarray(opt.step))
    step = step.to(device=dev, dtype=torch.int32)
    return {**tree,
            "params": lm_params_from_numpy(tree["params"], cfg, device=dev),
            "opt": AdamState(step=step, m=_f32_named(opt.m, cfg, dev),
                             v=_f32_named(opt.v, cfg, dev))}
