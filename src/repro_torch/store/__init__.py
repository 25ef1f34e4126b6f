"""repro_torch.store — tiered, mergeable, persistent aggregate store.

AccurateML's expensive step is aggregate generation (§III-B: LSH grouping,
per-bucket aggregation and the "index file" linking aggregated points back
to their originals).  This package owns the lifecycle of aggregates along
three axes:

  resolutions  ``Pyramid`` builds the finest level once (nested LSH ids)
               and derives every coarser compression ratio by merging
               sufficient statistics; perm/offsets coarsen in O(K).

  time         ``StreamingAggregate`` delta-updates level-0 statistics in
               fixed shapes on ``append(batch)``; a staleness counter
               schedules the index re-sort.

  processes    ``persist``/``AggregateStore.save``/``restore`` snapshot
               level-0 state (npz + identity manifest) so restarted servers
               warm-start.

``AggregateStore`` is the front end: ``get(servable, ratio)`` quantizes the
ratio to the resolution grid and reports whether the answer was resident,
merged, built or restored.  The same package as ``src/repro/store/``, on
torch tensors; merged levels equal cold builds to the bit on the card too,
since every sum on this path is a deterministic segmented reduction.
"""
from repro_torch.store.ingest import StreamingAggregate
from repro_torch.store.persist import restore_store, save_store
from repro_torch.store.pyramid import (
    SOURCE_BUILT, SOURCE_MEMORY, SOURCE_MERGED, SOURCE_RESTORED,
    MergeableServable, Pyramid, PyramidSpec,
)
from repro_torch.store.store import AggregateStore

__all__ = [
    "AggregateStore",
    "MergeableServable",
    "Pyramid",
    "PyramidSpec",
    "SOURCE_BUILT",
    "SOURCE_MEMORY",
    "SOURCE_MERGED",
    "SOURCE_RESTORED",
    "StreamingAggregate",
    "restore_store",
    "save_store",
]
