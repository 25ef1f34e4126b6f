"""Inputs of every cell, drawn from ``--seed`` on the run's device.

Frozen copies of the program's stand-ins for the paper's datasets
(``repro_torch.data.synthetic``: ``make_mfeat_like``, ``make_netflix_like``,
``holdout_split``, the same distributions and the same order of draws) and
of the distributions of its p-stable LSH draw (``core.lsh.init_lsh``): a later
change of the program cannot change what the benchmark feeds it.

Every stream of random numbers has a seed of its own, ``sub_seed(seed,
stream, index)``, so that a job's draws are the same whatever ran before
it, and the reference can draw them again after the window.
"""
from __future__ import annotations

import math

import torch

_MASK64 = (1 << 64) - 1


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of draws (splitmix64 of the run's seed,
    the stream's name and an index): any whole number is a valid ``seed``."""
    x = (seed * 0x9E3779B97F4A7C15) & _MASK64
    for part in (sum(ord(c) << (8 * (i % 7)) for i, c in enumerate(stream)),
                 index):
        x = (x + part + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def generator(device: torch.device, seed: int, stream: str,
              index: int = 0) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, stream, index))


def mfeat_like(gen: torch.Generator, n_points: int, n_features: int,
               n_classes: int, modes_per_class: int, class_sep: float,
               mode_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-modal Gaussian-mixture classification data on the generator's
    device: (x [N, D] float32, y [N] int32)."""
    dev = gen.device
    labels = torch.randint(0, n_classes, (n_points,), generator=gen,
                           device=dev)
    mode_idx = torch.randint(0, modes_per_class, (n_points,), generator=gen,
                             device=dev)
    mode_means = torch.randn((n_classes, modes_per_class, n_features),
                             generator=gen, device=dev) * class_sep
    x = torch.randn((n_points, n_features), generator=gen, device=dev)
    x.mul_(mode_scale).add_(mode_means[labels, mode_idx])
    return x, labels.to(torch.int32)


def netflix_like(gen: torch.Generator, n_users: int, n_items: int, rank: int,
                 density: float, popularity_skew: float, noise: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Low-rank + bias + noise ratings quantized to 1..5 stars, Zipf item
    popularity normalised to ``density``: (ratings [U, I], mask [U, I]),
    float32, ratings 0 where missing."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    u = normal(n_users, rank) / math.sqrt(rank)
    v = normal(n_items, rank) / math.sqrt(rank)
    user_bias = normal(n_users, 1) * 0.5
    item_bias = normal(1, n_items) * 0.5
    raw = (u @ v.T).mul_(1.8).add_(3.0).add_(user_bias).add_(item_bias)
    raw.add_(normal(n_users, n_items), alpha=noise)
    ratings = raw.round_().clamp_(1.0, 5.0)
    pop = (1.0 + torch.arange(n_items, dtype=torch.float32, device=dev)
           ) ** (-popularity_skew)
    pop = torch.clamp(pop / pop.mean() * density, 0.0, 0.95)
    mask = (torch.rand((n_users, n_items), generator=gen, device=dev)
            < pop[None, :]).float()
    return ratings.mul_(mask), mask


def holdout(gen: torch.Generator, mask: torch.Tensor, frac: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(train mask, test mask): each rating held out with probability
    ``frac``."""
    coin = torch.rand(mask.shape, generator=gen, device=gen.device) < frac
    test = mask * coin
    return mask - test, test


def shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous map-task shards, as the program's jobs cut them."""
    return [(s * n // n_shards, (s + 1) * n // n_shards)
            for s in range(n_shards)]


def n_buckets(n_points: int, ratio: float) -> int:
    """Buckets of a shard at a compression ratio (N / K ~ ratio)."""
    return max(1, int(round(n_points / float(ratio))))


def lsh_draws(gen: torch.Generator, n_features: int, n_hashes: int,
              width: float, n_shards: int
              ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """One p-stable family a map task, in shard order: (a [D, H] standard
    normal, b [H] uniform in [0, w)), float32 on the generator's device,
    drawn for all map tasks in two calls."""
    dev = gen.device
    a = torch.randn((n_shards, n_features, n_hashes), generator=gen,
                    device=dev)
    b = torch.rand((n_shards, n_hashes), generator=gen, device=dev) * width
    return [(a[s], b[s]) for s in range(n_shards)]
