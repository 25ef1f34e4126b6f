"""Shared plumbing for servables whose aggregates come from p-stable LSH.

Both shipped workloads (kNN, CF) follow the same pattern: a fixed dataset
shard, an ``LSHConfig`` derived from the requested compression ratio, a
``MapReduce`` engine for the map + combine (which meters shuffle bytes),
and a cache key of (dataset fingerprint, LSH family, realized resolution).
The key is a correctness contract (two servables with different data or
hyper-parameters must never alias), so it lives here, in one place.

Aggregates are owned by a ``repro_torch.store.AggregateStore``:
compression ratios quantize to the servable's ``PyramidSpec`` grid,
``build`` goes through the store's pyramid (finest level once, coarser
levels by exact merge), and subclasses implement the ``MergeableServable``
hooks ``hash_features`` / ``mergeable_stats`` / ``assemble``.

The reference (``src/repro/serve/servable.py``) takes a JAX PRNG key; here
the constructor takes exactly one of ``lsh_generator`` (a
``torch.Generator``, drawn from once) or ``lsh_params`` (the base
resolution's ``a`` [F, H] and ``b`` [H], e.g. the reference's draws).  The
draws do not depend on the bucket count, so every nested level reuses them,
and their identity is a digest of their bytes.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.core import aggregate as agg_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import lsh as lsh_lib
from repro_torch.store.pyramid import PyramidSpec
from repro_torch.store.store import AggregateStore


def _checksum(a: torch.Tensor) -> float:
    """Position-sensitive content checksum (permutations change it), in
    float64 and one reduction of a fixed order, so that the same tensor on
    the same device gives the same number in any process."""
    flat = a.reshape(-1).to(torch.float64)
    weights = torch.cos(
        torch.arange(flat.numel(), dtype=torch.float64, device=flat.device)
        * 0.73)
    return float((flat * weights).sum())


def _digest(*tensors: torch.Tensor) -> tuple[int, ...]:
    """The sha1 of the tensors' bytes, as five 32-bit words."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    d = h.digest()
    return tuple(int.from_bytes(d[i:i + 4], "little") for i in range(0, 20, 4))


class LSHServableBase:
    """Engine/fingerprint/cache-key plumbing shared by LSH-backed servables.

    Subclasses move their dataset arrays (leading dim = original points, the
    first one as wide as the hashed rows) to ``device`` and pass them to
    ``__init__``, and implement ``probe_payload``/``pad_batch``/``run``/
    ``unpack`` plus a class-level ``name``.
    """

    name: str = "lsh"

    def __init__(
        self,
        data_arrays: tuple[torch.Tensor, ...],
        *,
        device: torch.device,
        lsh_generator: torch.Generator | None = None,
        lsh_params=None,
        n_hashes: int,
        bucket_width: float,
        engine: engine_lib.MapReduce | None = None,
        store: AggregateStore | None = None,
        pyramid_spec: PyramidSpec | None = None,
    ):
        if (lsh_generator is None) == (lsh_params is None):
            raise ValueError("pass exactly one of lsh_generator and "
                             "lsh_params")
        self.device = device
        n_features = int(data_arrays[0].shape[1])
        if lsh_params is None:
            drawn = lsh_lib.init_lsh(
                lsh_generator, n_features,
                lsh_lib.LSHConfig(n_hashes=n_hashes,
                                  bucket_width=bucket_width),
                device=device)
            a, b = drawn.a, drawn.b
        else:
            a, b = (v.to(device=device, dtype=torch.float32)
                    if isinstance(v, torch.Tensor)
                    else torch.tensor(v, dtype=torch.float32, device=device)
                    for v in lsh_params)
            if tuple(a.shape) != (n_features, n_hashes) or tuple(
                    b.shape) != (n_hashes,):
                raise ValueError(
                    f"lsh_params a {tuple(a.shape)} / b {tuple(b.shape)}: "
                    f"expected ({n_features}, {n_hashes}) / ({n_hashes},)")
        self.lsh_a, self.lsh_b = a, b
        # Hashable identity of the draws: different projections over the
        # same data must not alias in the aggregate cache or a snapshot.
        self._lsh_key_data = _digest(a, b)
        self.n_hashes = n_hashes
        self.bucket_width = bucket_width
        self.engine = engine if engine is not None else engine_lib.MapReduce()
        self.n_points = int(data_arrays[0].shape[0])
        # Cheap shard fingerprint: shape, dtype, and a position-weighted
        # checksum per array (a plain sum would let a row-shuffled shard
        # alias its predecessor's aggregates, whose index names old rows).
        self._fingerprint = tuple(
            (tuple(a.shape), str(a.dtype), _checksum(a)) for a in data_arrays
        )
        self.pyramid_spec = (
            pyramid_spec if pyramid_spec is not None
            else PyramidSpec.for_points(self.n_points)
        )
        # A private store per servable unless one is shared across shards.
        # (Explicit None check: an empty AggregateStore is len() == 0.)
        self.store = store if store is not None else AggregateStore()

    @property
    def last_shuffle_bytes(self) -> int:
        return self.engine.last_shuffle_bytes

    def check_stage2(self, refine_budget: int) -> None:
        """Refuse stage 2 on a mesh engine.  The prepared level indexes the
        servable's whole rows, while a mesh engine maps each rank's slice of
        them: the refinement's row ids would point past the slice (the JAX
        package gathers them clamped, the port's kernels would read out of
        bounds).  Stage 1 reads the level alone and runs on a mesh."""
        if self.engine.mesh is not None and refine_budget > 0:
            raise ValueError(
                f"{self.name}: stage 2 (refine_budget {refine_budget}) on a "
                "mesh engine would index the whole shard's rows from each "
                "rank's slice; serve a mesh with one servable a rank")

    def _lsh_config(self, compression_ratio: float) -> lsh_lib.LSHConfig:
        """Nested config at the pyramid level nearest the requested ratio."""
        spec = self.pyramid_spec
        level = spec.level_for_ratio(compression_ratio)
        return lsh_lib.nested_config(
            spec.base_buckets, spec.n_buckets(level),
            n_hashes=self.n_hashes, bucket_width=self.bucket_width,
        )

    def _lsh_params(self, compression_ratio: float) -> lsh_lib.LSHParams:
        """The servable's draws under the nested config of a ratio."""
        return lsh_lib.LSHParams(a=self.lsh_a, b=self.lsh_b,
                                 config=self._lsh_config(compression_ratio))

    def quantized_ratio(self, compression_ratio: float) -> float:
        """The realized pyramid-grid ratio a request actually gets."""
        return self.pyramid_spec.quantize_ratio(compression_ratio)

    def cache_key(self, compression_ratio: float):
        """(shard, LSH family, realized resolution): all-integer resolution
        terms, so float drift in the requested ratio can't split entries."""
        cfg = self._lsh_config(compression_ratio)
        return (
            self._fingerprint, self._lsh_key_data,
            cfg.n_hashes, cfg.bucket_width, cfg.base_buckets, cfg.n_buckets,
        )

    def store_key(self):
        """Pyramid identity: one pyramid serves every resolution level."""
        spec = self.pyramid_spec
        return (
            self._fingerprint, self._lsh_key_data,
            self.n_hashes, self.bucket_width,
            spec.base_buckets, spec.branch, spec.n_levels,
        )

    # ------------------------------------------------------------------
    # MergeableServable hooks (repro_torch.store pyramid protocol)
    # ------------------------------------------------------------------
    def hash_features(self) -> torch.Tensor:
        """[N, F] rows the LSH family hashes (workload-specific)."""
        raise NotImplementedError

    def mergeable_stats(
        self, fine_ids: torch.Tensor, n_buckets: int
    ) -> dict[str, torch.Tensor]:
        """Additive per-bucket statistics (must include 'counts')."""
        raise NotImplementedError

    def assemble(self, stats: dict, index: agg_lib.BucketIndex):
        """Statistics + index -> the prepared object ``run`` consumes."""
        raise NotImplementedError

    def fine_ids(self, base_buckets: int) -> torch.Tensor:
        """Level-0 (finest) bucket ids of the shard's hash features: one
        ``lsh_hash`` launch (its ids epilogue) on the card."""
        params = lsh_lib.LSHParams(
            a=self.lsh_a, b=self.lsh_b,
            config=lsh_lib.LSHConfig(
                n_hashes=self.n_hashes, bucket_width=self.bucket_width,
                n_buckets=base_buckets,
            ),
        )
        return lsh_lib.fine_bucket_ids(self.hash_features(), params)

    def build(self, compression_ratio: float):
        """Prepared aggregates at the quantized ratio, via the store (the
        finest level is built once; coarser ratios merge, never rebuild)."""
        return self.store.get(self, compression_ratio)[0]

    def batch_tensor(self, x) -> torch.Tensor:
        """A request batch's array on the servable's device."""
        return torch.as_tensor(x, device=self.device)

    @staticmethod
    def stack_pad(payloads, batch: int) -> tuple:
        """Stack per-request payload columns and zero-pad each to ``batch``
        rows: the fixed-shape contract of ``Servable.pad_batch``."""
        out = []
        for col in zip(*payloads):
            arr = torch.stack([torch.as_tensor(c) for c in col])
            if arr.shape[0] < batch:
                pad = arr.new_zeros((batch - arr.shape[0],)
                                    + tuple(arr.shape[1:]))
                arr = torch.cat([arr, pad], dim=0)
            out.append(arr)
        return tuple(out)
