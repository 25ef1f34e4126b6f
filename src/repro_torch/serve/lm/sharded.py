"""Bucket-level failure domains for the aggregated-KV decode engine.

As ``src/repro/serve/lm/sharded.py`` defines it.  The decode analogue of
the JAX package's ``runtime.shards``: the aggregated cache's K LSH
buckets are striped round-robin over N shards (bucket ``k`` lives on shard
``k % n_shards``), so a dead shard removes an interleaved 1/N slice of
every sequence's aggregate — never a contiguous prefix of the context.
Under the anytime contract a generation served while shards are dead is a
*degraded answer, not an error*: the engine zeroes the dead buckets'
counts (they stop contributing centroids AND stop being refinable — the
same ``counts == 0`` masking that guards empty buckets), and the engine
reports the dead set (``DecodeEngine.dead_shards``).

Revival is admission-level only: cleared shards accept *new* inserts, but
the zeroed counts mean the data previously aggregated there stays lost
until the slot is re-prefilled — degraded state never silently
resurrects.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketShardPlan:
    """Static bucket -> shard striping for one engine's aggregate."""

    n_buckets: int
    n_shards: int

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("need at least one shard")
        if self.n_buckets < 1:
            raise ValueError("need at least one bucket")

    def shard_of(self, bucket: int) -> int:
        return bucket % self.n_shards

    def buckets_of(self, shard: int) -> np.ndarray:
        """All bucket ids striped onto ``shard``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} not in [0, {self.n_shards})")
        return np.arange(shard, self.n_buckets, self.n_shards)

    def keep_mask(self, dead: frozenset[int] | set[int]) -> np.ndarray:
        """[K] bool — False for buckets living on a dead shard."""
        keep = np.ones(self.n_buckets, dtype=bool)
        for shard in dead:
            keep[self.buckets_of(shard)] = False
        return keep
