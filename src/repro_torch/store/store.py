"""AggregateStore: lifecycle owner for aggregates across resolutions,
processes and time.

One store holds one ``Pyramid`` per (servable kind, shard fingerprint, LSH
family, resolution grid).  ``get(servable, ratio)`` quantizes the requested
compression ratio to the pyramid grid and returns the prepared aggregates
plus how they were obtained:

  * ``"memory"``   — level already assembled (free);
  * ``"merged"``   — derived from resident level-0 statistics by one exact
                     ``merge_levels`` pass (merge buckets, do not rebuild);
  * ``"built"``    — cold LSH + segment-sum build of level 0;
  * ``"restored"`` — level-0 state adopted from a disk snapshot.

The serving layer's aggregate cache delegates misses here and meters the
"merged" source as ``coarsened_hits``.  The same module as
``src/repro/store/store.py``.
"""
from __future__ import annotations

from typing import Any, Hashable, Iterable, Iterator

from repro_torch.obs.trace import current_tracer
from repro_torch.store import persist as persist_lib
from repro_torch.store.pyramid import (
    SOURCE_BUILT, SOURCE_MERGED, SOURCE_RESTORED, Pyramid,
)


class AggregateStore:
    """Tiered, mergeable, persistent home of aggregate pyramids."""

    def __init__(self):
        self._pyramids: dict[Hashable, Pyramid] = {}
        # Lifecycle meters (exposed via stats()).
        self.builds = 0
        self.merges = 0
        self.memory_hits = 0
        self.restores = 0

    # ------------------------------------------------------------------
    def _key(self, servable) -> Hashable:
        return (servable.name, servable.store_key())

    def pyramid(self, servable) -> Pyramid:
        """The servable's pyramid, created (empty) on first touch."""
        key = self._key(servable)
        pyr = self._pyramids.get(key)
        if pyr is None:
            pyr = Pyramid(servable, servable.pyramid_spec)
            self._pyramids[key] = pyr
        return pyr

    def pyramids(self) -> Iterator[tuple[Hashable, Pyramid]]:
        return iter(self._pyramids.items())

    def __len__(self) -> int:
        return len(self._pyramids)

    # ------------------------------------------------------------------
    def get(self, servable, compression_ratio: float) -> tuple[Any, str]:
        """(prepared aggregates, source) at the quantized ratio."""
        prepared, source = self.pyramid(servable).get(compression_ratio)
        if source == SOURCE_BUILT:
            self.builds += 1
        elif source == SOURCE_MERGED:
            self.merges += 1
        elif source == SOURCE_RESTORED:
            self.restores += 1
        else:
            self.memory_hits += 1
        current_tracer().event(
            "store.get", kind=servable.name, ratio=compression_ratio,
            source=source,
        )
        return prepared, source

    def adopt(
        self, servable, stats, index, *, restored: bool = False
    ) -> Pyramid:
        """Install level-0 state built elsewhere (a snapshot restore or a
        finalized ``StreamingAggregate``)."""
        pyr = self.pyramid(servable)
        pyr.adopt_level0(stats, index, restored=restored)
        return pyr

    def invalidate(self, servable) -> int:
        """Drop the servable's pyramid (e.g. its shard was updated)."""
        return 1 if self._pyramids.pop(self._key(servable), None) else 0

    def drop_assembled(self, servable, level: int | None = None) -> None:
        """Forget assembled levels but keep level-0 statistics resident."""
        key = self._key(servable)
        if key in self._pyramids:
            self._pyramids[key].drop_assembled(level)

    # ------------------------------------------------------------------
    def save(self, directory) -> int:
        """Persist every built pyramid; returns the number written."""
        return persist_lib.save_store(self, directory)

    def restore(self, directory, servables: Iterable) -> int:
        """Adopt matching snapshots for ``servables``; returns the count."""
        return persist_lib.restore_store(self, directory, servables)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "pyramids": len(self._pyramids),
            "builds": self.builds,
            "merges": self.merges,
            "memory_hits": self.memory_hits,
            "restores": self.restores,
            "resident_bytes": sum(
                p.nbytes() for p in self._pyramids.values()
            ),
        }
