"""Turn the JAX package's parameters, given as numpy arrays, into the port's.

JAX's PRNG bits cannot be reproduced in torch, so a comparison of the two
packages draws once on the JAX side and hands the draws over: LSH
projections for ``run_accurateml(lsh_params=...)``, prepared aggregates
for ``accurateml_map`` (kNN and CF), an aggregate store's level-0 state
from a snapshot (``store_level0_from_numpy``), a language model's weights
(``lm_params_from_numpy``) and its decode caches' per-layer LSH draws
(``lm_cache_lsh_from_numpy``).  Arrays are copied; dtypes are those the
port uses (float32 values, int32 indices and counts, the model's dtype for
its weights).
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
    ``units`` leaves indexed away), then tail blocks."""
    head_kinds, pat, n_units, tail_kinds = model_lib._stack_layout(cfg)
    out = [tree[head][str(i)] for i in range(len(head_kinds))]
    for u in range(n_units):
        for i in range(len(pat)):
            out.append(_index(tree[units][f"b{i}"], u))
    out += [tree[tail][str(i)] for i in range(len(tail_kinds))]
    return out


def _index(node, u: int):
    if isinstance(node, dict):
        return {k: _index(v, u) for k, v in node.items()}
    return np.asarray(node)[u]


def _load(param: torch.Tensor, arr, name: str) -> None:
    arr = np.asarray(arr, dtype=np.float32)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected "
                         f"{tuple(param.shape)}")
    param.data.copy_(torch.tensor(arr).to(param.dtype))


def lm_params_from_numpy(tree: dict, cfg, *,
                         device: str | torch.device = "cuda"):
    """The JAX package's ``repro.models.init_params`` pytree, as numpy with
    its stacked ``units``, -> the port's ``LM`` module in ``cfg.dtype``."""
    dev = resolve(device)
    model = model_lib.LM(
        layers.Init(None, dtype=layers.torch_dtype(cfg.dtype), device=dev),
        cfg)
    _load(model.embed, tree["embed"], "embed")
    _load(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        _load(model.lm_head, tree["lm_head"], "lm_head")
    blocks = _layer_trees(tree, cfg, "head_blocks", "units", "tail_blocks")
    for i, (blk, sub) in enumerate(zip(model.blocks, blocks)):
        for name, param in blk.named_parameters():
            node = sub
            for part in name.split("."):
                node = node[part]
            _load(param, node, f"block {i} {name}")
    return model


def lm_cache_lsh_from_numpy(caches: dict, cfg, *,
                            device: str | torch.device = "cuda") -> list:
    """The per-layer LSH draws of the JAX package's decode caches
    (``repro.models.init_caches``, as numpy; each aggregated cache, an
    object or a dict, has ``lsh_a`` [Hkv*dk, H] and ``lsh_b`` [H], with a
    leading unit axis in ``units``)
    -> the port's list of (a, b) in stack order, for ``init_caches(lsh=)``
    and ``DecodeEngine(lsh=)``."""
    dev = resolve(device)
    return [(_f32(c["lsh_a"], dev), _f32(c["lsh_b"], dev))
            for c in _layer_trees(_lsh_only(caches), cfg, "head", "units",
                                  "tail")]


def _lsh_only(node):
    """A cache pytree with every aggregated cache reduced to a dict of its
    draws."""
    if isinstance(node, dict) and "lsh_a" in node:
        return {"lsh_a": node["lsh_a"], "lsh_b": node["lsh_b"]}
    if isinstance(node, dict):
        return {k: _lsh_only(v) for k, v in node.items()}
    if hasattr(node, "lsh_a"):
        return {"lsh_a": node.lsh_a, "lsh_b": node.lsh_b}
    raise ValueError(f"not an aggregated cache: {type(node).__name__}")
