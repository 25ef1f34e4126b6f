"""p-stable locality-sensitive hashing (Datar et al., SCG'04), AccurateML §III-B.

h(d) = floor((a·d + b) / w), ``a`` i.i.d. standard normal (2-stable, so
Euclidean), ``b ~ U[0, w)``.  The projection of a whole shard is one
``[N, D] x [D, H]`` product; the H hashes combine into one bounded bucket
id through a uint32 signature that wraps around, as
``src/repro/core/lsh.py`` computes it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve

# Large primes combining the H p-stable hashes into one bucket signature.
_SIGNATURE_PRIMES = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393, 2654435789,
    1103515245, 2971215073, 433494437, 1540483477, 2166136261, 16777619,
)
_MASK32 = 0xFFFFFFFF


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


def raw_hashes(data: torch.Tensor, params: LSHParams) -> torch.Tensor:
    """h_j(d) = floor((a_j . d + b_j) / w) for every hash j.  [N, H] int32."""
    proj = data.float() @ params.a + params.b[None, :]
    return torch.floor(proj / params.config.bucket_width).to(torch.int32)


def fine_bucket_ids(data: torch.Tensor, params: LSHParams) -> torch.Tensor:
    """``sig % base_buckets`` (or ``n_buckets`` for flat configs), int32,
    with the signature of ``wrapped_signature``."""
    cfg = params.config
    sig = wrapped_signature(raw_hashes(data, params))
    base = cfg.base_buckets or cfg.n_buckets
    return (sig % base).to(torch.int32)


def wrapped_signature(h: torch.Tensor) -> torch.Tensor:
    """[..., H] int32 hashes -> [...] int64 holding the uint32 signature
    ``sum_j uint32(h_j) * prime_j`` with uint32 wrap-around.

    torch has no uint32 arithmetic, so it runs in int64: each prime splits
    into 16-bit halves, so that every product, and the sum of the H terms,
    stays below 2^53; the sum is then taken mod 2^32.
    """
    lo, hi = _prime_halves(h.shape[-1], h.device)
    h = h.to(torch.int64) & _MASK32                          # uint32(h)
    terms = h * lo + (((h * hi) & 0xFFFF) << 16)             # mod 2^32
    return terms.sum(dim=-1) & _MASK32


_PRIME_HALVES: dict = {}


def _prime_halves(n: int, device: torch.device):
    """The low and high 16 bits of the first n signature primes, [n] int64
    on ``device``, made once per device: a copy from the host to the card
    would wait for the card at every call (every layer of every decode
    step)."""
    key = (n, str(device))
    if key not in _PRIME_HALVES:
        if n > len(_SIGNATURE_PRIMES):
            raise ValueError(f"{n} hashes: at most {len(_SIGNATURE_PRIMES)}")
        primes = _SIGNATURE_PRIMES[:n]
        _PRIME_HALVES[key] = tuple(
            torch.tensor([f(p) for p in primes], dtype=torch.int64,
                         device=device)
            for f in (lambda p: p & 0xFFFF, lambda p: p >> 16))
    return _PRIME_HALVES[key]


def bucket_ids(data: torch.Tensor, params: LSHParams) -> torch.Tensor:
    """Combine the H hashes into a bounded bucket id in [0, K), int32.  With
    a nested config the id is the fine id divided by the nesting factor."""
    cfg = params.config
    fine = fine_bucket_ids(data, params)
    if cfg.base_buckets is None or cfg.base_buckets == cfg.n_buckets:
        return fine
    return fine // (cfg.base_buckets // cfg.n_buckets)


def config_for_compression(
    n_points: int, compression_ratio: float, *, n_hashes: int = 4,
    bucket_width: float = 4.0,
) -> LSHConfig:
    """Pick K so that the expected compression ratio ``N / K`` matches."""
    n_buckets = max(1, int(round(n_points / float(compression_ratio))))
    return LSHConfig(
        n_hashes=n_hashes, bucket_width=bucket_width, n_buckets=n_buckets
    )
