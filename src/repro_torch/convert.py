"""Turn the JAX package's parameters, given as numpy arrays, into the port's.

JAX's PRNG bits cannot be reproduced in torch, so a comparison of the two
packages draws once on the JAX side and hands the draws over: LSH
projections for ``run_accurateml(lsh_params=...)`` and prepared aggregates
for ``accurateml_map`` (kNN and CF).  Arrays are copied; dtypes are those
the port uses (float32 values, int32 indices and counts).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.cf import CFAggregates
from repro_torch.apps.knn import KNNAggregates
from repro_torch.core.aggregate import AggregatedData
from repro_torch.core.lsh import LSHConfig, LSHParams
from repro_torch.device import resolve


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
