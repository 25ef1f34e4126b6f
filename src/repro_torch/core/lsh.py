"""p-stable locality-sensitive hashing (Datar et al., SCG'04), AccurateML §III-B.

h(d) = floor((a·d + b) / w), ``a`` i.i.d. standard normal (2-stable, so
Euclidean), ``b ~ U[0, w)``.  The projection of a whole shard is one
``[N, D] x [D, H]`` product; the H hashes combine into one bounded bucket
id through a uint32 signature that wraps around, as
``src/repro/core/lsh.py`` computes it.  On a CUDA tensor the hashes, or the
ids, come from one launch of the ``lsh_hash`` kernel (``kernels/ops``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """Hyper-parameters of the p-stable LSH family.

    Attributes:
      n_hashes: p-stable hashes combined into one bucket signature.
      bucket_width: the ``w`` in h(d) = floor((a.d+b)/w).
      n_buckets: the bounded bucket-id space ``K`` (~ N / compression ratio).
      base_buckets: when set, ids are nested: the signature maps into
        ``base_buckets`` fine ids and the served id is the fine id divided by
        ``base_buckets // n_buckets``.  ``None`` keeps ``sig % n_buckets``.
    """

    n_hashes: int = 4
    bucket_width: float = 4.0
    n_buckets: int = 256
    base_buckets: int | None = None

    def __post_init__(self):
        if self.base_buckets is not None:
            if self.base_buckets < self.n_buckets:
                raise ValueError(
                    f"base_buckets={self.base_buckets} < "
                    f"n_buckets={self.n_buckets}"
                )
            if self.base_buckets % self.n_buckets:
                raise ValueError(
                    "nested ids need n_buckets to divide base_buckets "
                    f"(got {self.n_buckets} / {self.base_buckets})"
                )


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Materialized random projections for one LSH family instance."""

    a: torch.Tensor  # [D, H] standard normal (2-stable)
    b: torch.Tensor  # [H]    uniform in [0, w)
    config: LSHConfig


def init_lsh(
    generator: torch.Generator, n_features: int, config: LSHConfig,
    *, device: str | torch.device = "cuda",
) -> LSHParams:
    """Draw the p-stable projection family (Definition 2 / Eq. 1).

    Draws on the generator's own device, then moves the params to
    ``device``.
    """
    dev = resolve(device)
    a = torch.randn(
        (n_features, config.n_hashes), generator=generator,
        device=generator.device, dtype=torch.float32,
    )
    b = torch.rand(
        (config.n_hashes,), generator=generator, device=generator.device,
        dtype=torch.float32,
    ) * config.bucket_width
    return LSHParams(a=a.to(dev), b=b.to(dev), config=config)


# The reference's jitted constructor; there is nothing to compile here.
fit = init_lsh


def raw_hashes(data: torch.Tensor, params: LSHParams) -> torch.Tensor:
    """h_j(d) = floor((a_j . d + b_j) / w) for every hash j.  [N, H] int32."""
    return ops.lsh_hash(data.float(), params.a, params.b,
                        params.config.bucket_width)


def fine_bucket_ids(data: torch.Tensor, params: LSHParams) -> torch.Tensor:
    """``sig % base_buckets`` (or ``n_buckets`` for flat configs), int32,
    with ``sig`` the hashes' uint32 signature."""
    cfg = params.config
    return ops.lsh_bucket_ids(data.float(), params.a, params.b,
                              cfg.bucket_width,
                              base=cfg.base_buckets or cfg.n_buckets)


def bucket_ids(data: torch.Tensor, params: LSHParams) -> torch.Tensor:
    """Combine the H hashes into a bounded bucket id in [0, K), int32.  With
    a nested config the id is the fine id divided by the nesting factor."""
    cfg = params.config
    base = cfg.base_buckets or cfg.n_buckets
    return ops.lsh_bucket_ids(data.float(), params.a, params.b,
                              cfg.bucket_width, base=base,
                              factor=base // cfg.n_buckets)


def nested_config(
    base_buckets: int, n_buckets: int, *, n_hashes: int = 4,
    bucket_width: float = 4.0,
) -> LSHConfig:
    """An ``LSHConfig`` whose ids live in the nested (prefix) id space: the
    fine id ``sig % base_buckets`` divided by ``base_buckets // n_buckets``,
    which ``bucket_ids`` takes from the ``lsh_hash`` kernel's ids
    epilogue."""
    return LSHConfig(
        n_hashes=n_hashes, bucket_width=bucket_width, n_buckets=n_buckets,
        base_buckets=base_buckets,
    )


def config_for_compression(
    n_points: int, compression_ratio: float, *, n_hashes: int = 4,
    bucket_width: float = 4.0,
) -> LSHConfig:
    """Pick K so that the expected compression ratio ``N / K`` matches."""
    n_buckets = max(1, int(round(n_points / float(compression_ratio))))
    return LSHConfig(
        n_hashes=n_hashes, bucket_width=bucket_width, n_buckets=n_buckets
    )


def shard_lsh_params(
    shards: list[torch.Tensor], compression_ratio: float, *, n_hashes: int,
    bucket_width: float, generator: torch.Generator | None = None,
    params: list[LSHParams] | None = None,
    device: str | torch.device = "cuda",
) -> list[LSHParams]:
    """Each map shard's LSH params at ``compression_ratio``: drawn from
    ``generator`` in shard order, or ``params`` (one per shard) checked
    against each shard's config."""
    out = []
    for s, x in enumerate(shards):
        cfg = config_for_compression(x.shape[0], compression_ratio,
                                     n_hashes=n_hashes,
                                     bucket_width=bucket_width)
        if params is None:
            out.append(init_lsh(generator, x.shape[1], cfg, device=device))
        elif params[s].config != cfg:
            raise ValueError(
                f"shard {s}: lsh_params config {params[s].config} != {cfg}"
            )
        else:
            out.append(params[s])
    return out
