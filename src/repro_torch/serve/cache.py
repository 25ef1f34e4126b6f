"""Aggregate cache: build stage-1 aggregates once, reuse across requests.

The expensive part of AccurateML's map task is not stage 1 itself but the
aggregation *generation* (LSH projection + segment sums + the perm/offsets
index).  Offline, the paper amortizes it across one job; online, the same
aggregates serve every request that hits the same (dataset shard, LSHConfig)
pair — so the cache key is exactly that pair (delegated to
``Servable.cache_key``, which fingerprints the shard's data and quantizes
the compression ratio to the realized bucket count, so float drift in a
requested ratio can't split entries).

Misses delegate to the servable's ``repro_torch.store.AggregateStore``: a request
at a new compression ratio is answered by *merging* the shard's resident
level-0 statistics (``coarsened_hits``) instead of re-running LSH +
aggregation, and a snapshot-restored store warm-starts the cache so a fresh
process's first request is already a hit (``warm_from_store``).

LRU with hit/miss metering; the hit and coarsened-hit rates are first-class
serving metrics (``ServeMetrics`` folds them into its summary).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Iterable

from repro_torch.serve.request import Servable
from repro_torch.store.pyramid import SOURCE_MERGED, SOURCE_RESTORED


class AggregateCache:
    """LRU cache of built aggregates keyed by (dataset shard, LSHConfig)."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.coarsened_hits = 0   # miss answered by a cross-ratio merge
        self.restored_hits = 0    # miss answered from a disk snapshot
        self.last_source = "none"  # where the latest lookup was satisfied

    def __len__(self) -> int:
        return len(self._entries)

    def _insert(self, key: Hashable, prepared: Any) -> None:
        self._entries[key] = prepared
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def holds(self, servable: Servable, compression_ratio: float) -> bool:
        """Whether a lookup would hit, without touching the meters."""
        return (servable.name, servable.cache_key(compression_ratio)) \
            in self._entries

    def get_or_build(
        self, servable: Servable, compression_ratio: float
    ) -> tuple[Any, bool]:
        """Return (prepared aggregates, was_hit)."""
        key = (servable.name, servable.cache_key(compression_ratio))
        if key in self._entries:
            self.hits += 1
            self.last_source = "hit"
            self._entries.move_to_end(key)
            return self._entries[key], True
        self.misses += 1
        store = getattr(servable, "store", None)
        if store is not None:
            prepared, source = store.get(servable, compression_ratio)
            if source == SOURCE_MERGED:
                self.coarsened_hits += 1
            elif source == SOURCE_RESTORED:
                self.restored_hits += 1
            self.last_source = source
        else:
            prepared = servable.build(compression_ratio)
            self.last_source = "built"
        self._insert(key, prepared)
        return prepared, False

    def warm_from_store(
        self, servables: Iterable[Servable],
        ratios: Iterable[float] | None = None,
    ) -> int:
        """Pre-insert store-resident aggregates so first requests hit.

        With ``ratios`` given, each is materialized through the store first
        (a restored snapshot assembles in one merge); otherwise only levels
        the store has already assembled are inserted.  Entries whose
        aggregates came from a snapshot (or a cross-ratio merge) are metered
        as ``restored_hits``/``coarsened_hits`` here — by the time requests
        arrive they are plain cache hits, so this is the only place the
        warm-start source is visible.  Returns the number of cache entries
        added.
        """
        added = 0
        for servable in servables:
            store = getattr(servable, "store", None)
            if store is None:
                continue
            spec = servable.pyramid_spec
            wanted = (
                [spec.level_for_ratio(r) for r in ratios]
                if ratios is not None
                else store.pyramid(servable).assembled_levels
            )
            for level in dict.fromkeys(wanted):
                key = (servable.name, servable.cache_key(spec.ratio(level)))
                if key in self._entries:
                    continue  # already warm: no store work, no meters
                prepared, source = store.get(servable, spec.ratio(level))
                if source == SOURCE_RESTORED:
                    self.restored_hits += 1
                elif source == SOURCE_MERGED:
                    self.coarsened_hits += 1
                self._insert(key, prepared)
                added += 1
        return added

    def invalidate(self, servable: Servable) -> int:
        """Drop every entry of one servable (e.g. its shard was updated);
        cascades to the servable's store so stale pyramids can't resurface
        as coarsened hits."""
        stale = [k for k in self._entries if k[0] == servable.name]
        for k in stale:
            del self._entries[k]
        store = getattr(servable, "store", None)
        if store is not None:
            store.invalidate(servable)
        return len(stale)

    def reset_stats(self) -> None:
        """Zero the meters (entries stay cached) — e.g. after warmup."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.coarsened_hits = 0
        self.restored_hits = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "size": len(self._entries),
            "evictions": self.evictions,
            "coarsened_hits": self.coarsened_hits,
            "restored_hits": self.restored_hits,
        }
