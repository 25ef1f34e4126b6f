"""Streaming ingest: fixed-shape delta updates of level-0 aggregates.

A workload that writes online cannot afford a full LSH + segment-sum
rebuild per write.  ``StreamingAggregate`` keeps one shard's level-0
sufficient statistics live under appends:

  * ``append(batch)`` hashes the new rows in chunks of a fixed size (one
    ``lsh_hash`` launch a chunk), sums each chunk's contribution per bucket
    with the deterministic segment sum and adds it into the per-bucket
    sums/counts (and any extra additive statistics) in one elementwise
    pass, and writes the rows into a preallocated buffer: every state
    array keeps its shape.  No float ``index_add_``: its atomics add in
    another order on every run, and two runs must give the same bits;
  * the perm/offsets index (the paper's §III-B index file) is only needed
    by stage-2 refinement, so it is rebuilt lazily: a staleness counter
    tracks how many points the index lags and ``needs_rebucket`` schedules
    the O(N log N) re-sort.

Consistency contract: ``live_stats()`` is exact after every append;
``level0()`` returns the last rebucketed snapshot (statistics and index
from the same instant), ready for ``Pyramid.adopt_level0`` /
``AggregateStore.adopt``.  The same module as ``src/repro/store/ingest.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import aggregate as agg_lib
from repro_torch.core import lsh as lsh_lib
from repro_torch.device import resolve


def _rebucket(bucket_of: torch.Tensor, n: int, base_buckets: int):
    """Full-shape index rebuild: live rows sorted by bucket (stable), dead
    rows last.  -> ([capacity] int32 perm, [K+1] int32 offsets)."""
    live = torch.arange(bucket_of.shape[0], device=bucket_of.device) < n
    key = torch.where(live, bucket_of.long(), base_buckets)
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(base_buckets + 1, device=key.device)
    counts = torch.searchsorted(sorted_key, bounds).diff()
    return perm.to(torch.int32), agg_lib.bucket_offsets(counts)


class StreamingAggregate:
    """Online writer for one shard's level-0 aggregate state.

    Args:
      params: LSH family whose ``config.n_buckets`` is the pyramid's base
        (finest) resolution; appends hash rows with it, so streamed ids
        match what a cold rebuild over the same rows produces.
      n_features: row width.
      capacity: preallocated row budget (fixed shapes; appends beyond it
        raise).
      chunk: rows hashed and summed at a time; a short chunk is padded, and
        its padding rows are dropped, never added.
      rebucket_frac: schedule a re-bucket once the index lags more than
        this fraction of the live points.
      extra_shapes: additional additive per-bucket statistics to maintain,
        name -> trailing shape of the row contribution (e.g. a label
        one-hot ``(n_classes,)``).  ``append`` then takes matching arrays.
      device: where the state lives (the LSH draws are moved there).
    """

    def __init__(
        self,
        params: lsh_lib.LSHParams,
        n_features: int,
        *,
        capacity: int,
        chunk: int = 256,
        rebucket_frac: float = 0.25,
        extra_shapes: dict[str, tuple[int, ...]] | None = None,
        device: str | torch.device = "cuda",
    ):
        cfg = params.config
        if cfg.base_buckets not in (None, cfg.n_buckets):
            raise ValueError(
                "streaming params must be flat at the base resolution "
                "(config.n_buckets == pyramid base_buckets)"
            )
        dev = resolve(device)
        self.device = dev
        self.params = lsh_lib.LSHParams(a=params.a.to(dev),
                                        b=params.b.to(dev), config=cfg)
        self.base_buckets = cfg.n_buckets
        self.capacity = int(capacity)
        self.chunk = int(chunk)
        self.rebucket_frac = float(rebucket_frac)

        f32 = dict(dtype=torch.float32, device=dev)
        self.buffer = torch.zeros((capacity, n_features), **f32)
        self.bucket_of = torch.zeros((capacity,), dtype=torch.int32,
                                     device=dev)
        self.sums = torch.zeros((self.base_buckets, n_features), **f32)
        self.counts = torch.zeros((self.base_buckets,), dtype=torch.int32,
                                  device=dev)
        self.extras = {
            k: torch.zeros((self.base_buckets,) + tuple(shape), **f32)
            for k, shape in (extra_shapes or {}).items()
        }
        self.n = 0

        # Index snapshot (as of the last rebucket) + staleness accounting.
        self._indexed_n = 0
        self._indexed: tuple | None = None  # (stats dict, BucketIndex)

    # ------------------------------------------------------------------
    @property
    def stale_points(self) -> int:
        """Points appended since the index was last rebuilt."""
        return self.n - self._indexed_n

    @property
    def needs_rebucket(self) -> bool:
        return self.stale_points > self.rebucket_frac * max(self._indexed_n, 1)

    # ------------------------------------------------------------------
    def append(self, rows, **extra_rows) -> int:
        """Delta-update statistics with a batch of rows; returns new ``n``.

        ``extra_rows`` must provide one [B, ...] array per configured extra
        statistic.  Work is O(B·D) per chunk plus one elementwise add of
        the chunk's per-bucket sums: no rebuild.
        """
        rows = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        b = rows.shape[0]
        if set(extra_rows) != set(self.extras):
            raise ValueError(
                f"extra rows {sorted(extra_rows)} != configured "
                f"{sorted(self.extras)}"
            )
        if self.n + b > self.capacity:
            raise ValueError(
                f"append of {b} rows exceeds capacity "
                f"({self.n}/{self.capacity} used)"
            )
        extra_rows = {
            k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
            for k, v in extra_rows.items()
        }
        for start in range(0, b, self.chunk):
            stop = min(start + self.chunk, b)
            self._append_chunk(
                rows[start:stop],
                {k: v[start:stop] for k, v in extra_rows.items()},
            )
        return self.n

    def _append_chunk(self, rows, extra_rows) -> None:
        b = rows.shape[0]
        pad = self.chunk - b
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
            extra_rows = {
                k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                for k, v in extra_rows.items()
            }
        # The exact batch hash (same projection, signature and modulus), so
        # streamed ids match a cold rebuild over the same rows.
        ids = lsh_lib.fine_bucket_ids(rows, self.params)
        # Padding rows go to one extra segment past the last bucket, which
        # is dropped: they add nothing anywhere.
        valid = torch.arange(self.chunk, device=self.device) < b
        seg = torch.where(valid, ids, self.base_buckets)
        names = list(extra_rows)
        _, counts, sums = agg_lib.segment_sums(
            (rows, *(extra_rows[k] for k in names)), seg,
            self.base_buckets + 1)
        k0 = self.base_buckets
        self.sums += sums[0][:k0]
        self.counts += counts[:k0].to(torch.int32)
        for name, part in zip(names, sums[1:]):
            self.extras[name] += part[:k0]
        self.buffer[self.n:self.n + b] = rows[:b]
        self.bucket_of[self.n:self.n + b] = ids[:b]
        self.n += b

    # ------------------------------------------------------------------
    def live_stats(self) -> dict[str, torch.Tensor]:
        """Exact per-bucket statistics including every appended row.
        Returned tensors are copies: the live state is updated in place by
        the next ``append``."""
        out = {"sums": self.sums, "counts": self.counts}
        out.update(self.extras)
        return {k: v.clone() for k, v in out.items()}

    def rebucket(self) -> None:
        """Rebuild the perm/offsets index over the live rows (O(N log N))
        and snapshot the statistics at the same instant."""
        perm, offsets = _rebucket(self.bucket_of, self.n, self.base_buckets)
        index = agg_lib.BucketIndex(
            perm=perm, offsets=offsets, bucket_of=self.bucket_of.clone(),
        )
        self._indexed = (self.live_stats(), index)
        self._indexed_n = self.n

    def level0(self, *, trim: bool = True):
        """(stats, index, n) snapshot as of the last rebucket.

        Re-buckets first when the staleness schedule says so (or when no
        index exists yet).  With ``trim``, index arrays are sliced to the
        live row count so the result adopts cleanly into a ``Pyramid`` over
        the materialized ``data()`` rows.
        """
        if self._indexed is None or self.needs_rebucket:
            self.rebucket()
        stats, index = self._indexed
        n = self._indexed_n
        if trim:
            index = agg_lib.BucketIndex(
                perm=index.perm[:n],
                offsets=index.offsets,
                bucket_of=index.bucket_of[:n],
            )
        return dict(stats), index, n

    def rows(self) -> torch.Tensor:
        """The live rows, on the state's device (a view of the buffer)."""
        return self.buffer[: self.n]

    def data(self) -> np.ndarray:
        """Materialize the live rows (host copy) for servable construction."""
        return self.rows().cpu().numpy()
