"""Multi-resolution aggregate pyramid (the paper's §III-B "index file" made
hierarchical and reusable).

AccurateML builds one aggregate level per compression ratio; the pyramid
builds the finest level once (nested LSH ids, ``core.lsh.nested_config``)
and derives every coarser ratio by merging sufficient statistics:

  * additive per-bucket statistics (segment sums, counts, label histograms,
    CF rating sums, and the second moments behind the error bounds) merge
    with ``core.aggregate.merge_levels``, a reshape and a sum, the same
    arithmetic as a direct nested build, so a merged level equals a cold
    build to the bit;
  * the perm/offsets index coarsens in O(K) with ``coarsen_index``: the
    permutation is shared by all levels, because sorting by fine id also
    sorts by every nested coarse id.

A workload takes part through the ``MergeableServable`` protocol:
``fine_ids`` (level-0 bucket ids), ``mergeable_stats`` (the additive
statistics, ``"counts"`` among them) and ``assemble`` (statistics + index
-> the prepared object its ``run`` consumes).  The same module as
``src/repro/store/pyramid.py``, on torch tensors.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core import aggregate as agg_lib

# How a level's prepared object came to be (store/cache metering).
SOURCE_MEMORY = "memory"      # level already assembled and resident
SOURCE_MERGED = "merged"      # derived by merging a finer resident level
SOURCE_BUILT = "built"        # cold: LSH + segment sums from the raw shard
SOURCE_RESTORED = "restored"  # level-0 statistics came from a snapshot


@runtime_checkable
class MergeableServable(Protocol):
    """What a workload provides for pyramid (multi-resolution) storage."""

    name: str
    n_points: int

    def fine_ids(self, base_buckets: int) -> torch.Tensor:
        """Level-0 bucket id per original point (nested/prefix id space)."""
        ...

    def mergeable_stats(
        self, fine_ids: torch.Tensor, n_buckets: int
    ) -> dict[str, torch.Tensor]:
        """Additive per-bucket statistics, leading dim ``n_buckets``; must
        include ``"counts"`` (int32 points per bucket)."""
        ...

    def assemble(
        self, stats: dict[str, torch.Tensor], index: agg_lib.BucketIndex
    ) -> Any:
        """Statistics + index -> the prepared object ``run`` consumes."""
        ...


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """The resolution grid: level l has ``base_buckets // branch**l``
    buckets.  Requested compression ratios are quantized to this grid, so
    the store's keys are realized bucket counts, never raw floats: float
    drift in a request cannot split a cache entry."""

    n_points: int
    base_buckets: int
    branch: int = 2
    n_levels: int = 1

    @classmethod
    def for_points(
        cls, n_points: int, *, branch: int = 2, finest_ratio: float = 4.0,
        coarsest_ratio: float = 1024.0,
    ) -> "PyramidSpec":
        """Grid covering [finest_ratio, ~coarsest_ratio] for this shard."""
        if n_points < 1:
            raise ValueError("need at least one point")
        target = max(n_points / finest_ratio, 1.0)
        base = branch ** max(0, math.ceil(math.log(target, branch)))
        levels = 1
        k = base
        while k % branch == 0 and k // branch >= 1:
            k //= branch
            if n_points / k > coarsest_ratio:
                break
            levels += 1
        return cls(
            n_points=n_points, base_buckets=base, branch=branch,
            n_levels=levels,
        )

    def n_buckets(self, level: int) -> int:
        return self.base_buckets // self.branch ** level

    def factor(self, level: int) -> int:
        return self.branch ** level

    def ratio(self, level: int) -> float:
        """Realized (expected) compression ratio of a level."""
        return self.n_points / self.n_buckets(level)

    def level_for_ratio(self, compression_ratio: float) -> int:
        """Nearest level (log-space) for a requested compression ratio."""
        target_k = max(self.n_points / max(compression_ratio, 1e-9), 1.0)
        level = round(math.log(self.base_buckets / target_k, self.branch))
        return min(max(level, 0), self.n_levels - 1)

    def quantize_ratio(self, compression_ratio: float) -> float:
        return self.ratio(self.level_for_ratio(compression_ratio))


class Pyramid:
    """One shard's aggregates across every supported resolution.

    Holds the level-0 statistics and index resident and a small LRU of
    assembled prepared objects (``max_assembled`` levels: re-deriving an
    evicted level is one merge, so the pyramid's memory floor stays level-0
    sized).  Every coarser level is derived from level 0 in one
    ``merge_levels`` call per statistic, never chained, so any two paths to
    a level give the same bits.
    """

    def __init__(
        self, servable: MergeableServable, spec: PyramidSpec,
        *, max_assembled: int = 4,
    ):
        self.servable = servable
        self.spec = spec
        self.max_assembled = max(1, max_assembled)
        self._stats0: dict[str, torch.Tensor] | None = None
        self._index0: agg_lib.BucketIndex | None = None
        self._assembled: OrderedDict[int, Any] = OrderedDict()
        self._restored = False  # level-0 stats came from a snapshot

    # ------------------------------------------------------------------
    @property
    def built(self) -> bool:
        return self._stats0 is not None

    @property
    def assembled_levels(self) -> tuple[int, ...]:
        return tuple(sorted(self._assembled))

    def adopt_level0(
        self, stats: dict[str, torch.Tensor], index: agg_lib.BucketIndex,
        *, restored: bool = False,
    ) -> None:
        """Install level-0 state built elsewhere (a snapshot restore or a
        finalized streaming ingester)."""
        if "counts" not in stats:
            raise ValueError("level-0 stats must include 'counts'")
        for name, v in stats.items():
            if v.shape[0] != self.spec.base_buckets:
                raise ValueError(
                    f"stat {name!r} has {v.shape[0]} buckets, spec wants "
                    f"{self.spec.base_buckets}"
                )
        if index.n_buckets != self.spec.base_buckets:
            raise ValueError("index resolution does not match the spec")
        self._stats0 = dict(stats)
        self._index0 = index
        self._assembled.clear()
        self._restored = restored

    def ensure_base(self) -> str:
        """Make level-0 statistics resident; returns the source label."""
        if self._stats0 is not None:
            return SOURCE_RESTORED if self._restored else SOURCE_MEMORY
        base = self.spec.base_buckets
        fine_ids = self.servable.fine_ids(base)
        self._stats0 = dict(self.servable.mergeable_stats(fine_ids, base))
        if "counts" not in self._stats0:
            raise ValueError("mergeable_stats must include 'counts'")
        self._index0 = agg_lib.bucket_index(
            fine_ids, base, counts=self._stats0["counts"]
        )
        self._restored = False
        return SOURCE_BUILT

    # ------------------------------------------------------------------
    def stats_at(self, level: int) -> dict[str, torch.Tensor]:
        """Level statistics: level 0 as-is, coarser via one exact merge."""
        self.ensure_base()
        if level == 0:
            return dict(self._stats0)
        f = self.spec.factor(level)
        return {k: agg_lib.merge_levels(v, f) for k, v in self._stats0.items()}

    def index_at(self, level: int) -> agg_lib.BucketIndex:
        self.ensure_base()
        if level == 0:
            return self._index0
        return agg_lib.coarsen_index(self._index0, self.spec.factor(level))

    def level(self, level: int) -> tuple[Any, str]:
        """(prepared object, source) for one resolution level."""
        if not 0 <= level < self.spec.n_levels:
            raise ValueError(
                f"level {level} outside [0, {self.spec.n_levels})"
            )
        if level in self._assembled:
            self._assembled.move_to_end(level)
            return self._assembled[level], SOURCE_MEMORY
        base_source = self.ensure_base()
        prepared = self.servable.assemble(
            self.stats_at(level), self.index_at(level)
        )
        self._assembled[level] = prepared
        while len(self._assembled) > self.max_assembled:
            self._assembled.popitem(last=False)
        if base_source == SOURCE_BUILT:
            source = SOURCE_BUILT
        elif base_source == SOURCE_RESTORED:
            source = SOURCE_RESTORED
            self._restored = False  # first assembly consumes the label
        else:
            # Level-0 statistics were already resident: a coarser level is a
            # cross-ratio merge, re-assembling level 0 itself is not.
            source = SOURCE_MERGED if level > 0 else SOURCE_MEMORY
        return prepared, source

    def get(self, compression_ratio: float) -> tuple[Any, str]:
        return self.level(self.spec.level_for_ratio(compression_ratio))

    # ------------------------------------------------------------------
    def drop_assembled(self, level: int | None = None) -> None:
        """Forget assembled prepared objects (level-0 stats stay resident)."""
        if level is None:
            self._assembled.clear()
        else:
            self._assembled.pop(level, None)

    def nbytes(self) -> int:
        """Resident bytes of level-0 statistics + index (pyramid floor)."""
        if self._stats0 is None:
            return 0
        index = self._index0
        tensors = [*self._stats0.values(), index.perm, index.offsets,
                   index.bucket_of]
        return sum(t.numel() * t.element_size() for t in tensors)
