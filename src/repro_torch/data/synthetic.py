"""Seeded synthetic stand-ins for the paper's two datasets.

The real Multiple Features Factor set behind the paper's kNN workload has
2.3 M points x 217 features x 10 classes (paper §IV-A).  Each class occupies
several tight modes (writing styles), which is what kNN accuracy and LSH
bucket purity depend on.  The CF workload is a Netflix subset (48,019 users
x 17,700 items, density 0.012): a low-rank rating matrix with Zipf item
popularity.  The generators sample the same distributions as
``src/repro/data/synthetic.py``, from a ``torch.Generator`` (so with other
bits than the JAX generator), on the generator's device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve, to_device


def make_mfeat_like(
    generator: torch.Generator,
    n_points: int = 4096,
    n_features: int = 217,
    n_classes: int = 10,
    modes_per_class: int = 8,
    class_sep: float = 1.0,
    mode_scale: float = 0.35,
    *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-modal Gaussian-mixture classification data.  Returns (x [N, D]
    float32, y [N] int32) on ``device``; drawn on the generator's device."""
    dev = resolve(device)
    gdev = generator.device
    labels = torch.randint(0, n_classes, (n_points,), generator=generator,
                           device=gdev)
    mode_idx = torch.randint(0, modes_per_class, (n_points,),
                             generator=generator, device=gdev)
    mode_means = torch.randn(
        (n_classes, modes_per_class, n_features), generator=generator,
        device=gdev,
    ) * class_sep
    noise = torch.randn((n_points, n_features), generator=generator,
                        device=gdev) * mode_scale
    x = mode_means[labels, mode_idx] + noise
    return x.float().to(dev), labels.to(torch.int32).to(dev)


def make_netflix_like(
    generator: torch.Generator,
    n_users: int = 2048,
    n_items: int = 512,
    rank: int = 12,
    density: float = 0.08,
    popularity_skew: float = 0.8,
    noise: float = 0.5,
    *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Low-rank + bias + noise rating matrix quantized to 1..5 stars.

    Item popularity is Zipf-skewed (``popularity_skew``), normalised so that
    the mean density is ``density``.  Returns (ratings [U,I], mask [U,I]),
    both float32 on ``device``; ratings are 0 where missing.  The [U,I]
    intermediates are updated in place, so the peak is about three [U,I]
    float32 arrays.
    """
    dev = resolve(device)
    gdev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=gdev)

    u = normal(n_users, rank) / math.sqrt(rank)
    v = normal(n_items, rank) / math.sqrt(rank)
    user_bias = normal(n_users, 1) * 0.5
    item_bias = normal(1, n_items) * 0.5
    raw = (u @ v.T).mul_(1.8).add_(3.0).add_(user_bias).add_(item_bias)
    raw.add_(normal(n_users, n_items), alpha=noise)
    ratings = raw.round_().clamp_(1.0, 5.0)

    pop = (1.0 + torch.arange(n_items, dtype=torch.float32, device=gdev)
           ) ** (-popularity_skew)
    pop = torch.clamp(pop / pop.mean() * density, 0.0, 0.95)
    mask = (torch.rand((n_users, n_items), generator=generator, device=gdev)
            < pop[None, :]).float()
    return ratings.mul_(mask).to(dev), mask.to(dev)


def holdout_split(
    generator: torch.Generator, mask: torch.Tensor,
    holdout_frac: float = 0.2, *, device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a rating mask into (train_mask, test_mask) on ``device`` (paper:
    20 % of each active user's ratings are held out)."""
    dev, mask = to_device(device, mask)
    coin = torch.rand(mask.shape, generator=generator,
                      device=generator.device).to(dev) < holdout_frac
    test_mask = mask * coin
    return mask - test_mask, test_mask
