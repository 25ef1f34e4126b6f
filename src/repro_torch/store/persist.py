"""Snapshot/restore of aggregate pyramids (warm start across processes).

Aggregate generation (LSH + segment sums + the index permutation) is the
expensive step the paper amortizes across a job; persisting the result lets
a restarted server amortize it across processes.  Only level-0 state is
written (every coarser level re-derives in one exact merge), so a snapshot
is O(K0·D), not O(levels).

Layout (one directory per store), the reference's format::

    <dir>/manifest.json        # version + one entry per pyramid
    <dir>/<entry_id>.npz       # level-0 stats + perm/offsets/bucket_of

The manifest entry pins everything that makes a pyramid valid for a shard:
the servable kind, the data fingerprint, the LSH draws' digest and
hyper-parameters, and the resolution grid.  ``restore_store`` adopts a
snapshot only into a servable whose identity matches exactly: a stale
snapshot for updated data is skipped, never served.  Arrays are adopted on
the servable's device.

Writes stage to a tmp dir and swap in by renames: at every instant a
complete snapshot exists at ``<dir>`` or ``<dir>.old``, and restore falls
back to the latter.  The same module as ``src/repro/store/persist.py``.
"""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import aggregate as agg_lib

MANIFEST = "manifest.json"
FORMAT_VERSION = 1


def _fingerprint_json(fingerprint) -> list:
    """Normalize the servable fingerprint tuple for JSON round-tripping."""
    return [
        [list(shape), str(dtype), float(checksum)]
        for shape, dtype, checksum in fingerprint
    ]


def _entry_id(kind: str, key) -> str:
    digest = hashlib.sha1(repr((kind, key)).encode()).hexdigest()[:16]
    return f"{kind}_{digest}"


def _identity(servable) -> dict:
    """The JSON identity a snapshot must match to be adopted."""
    spec = servable.pyramid_spec
    return {
        "kind": servable.name,
        "n_points": servable.n_points,
        "fingerprint": _fingerprint_json(servable._fingerprint),
        "lsh_key": [int(v) for v in servable._lsh_key_data],
        "n_hashes": servable.n_hashes,
        "bucket_width": float(servable.bucket_width),
        "base_buckets": spec.base_buckets,
        "branch": spec.branch,
        "n_levels": spec.n_levels,
    }


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_store(store, directory) -> int:
    """Write every built pyramid in ``store`` to ``directory``; returns the
    number of pyramids persisted."""
    directory = Path(directory)
    tmp = directory.parent / (directory.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    entries = []
    for key, pyramid in store.pyramids():
        if not pyramid.built:
            continue
        stats, index = pyramid.stats_at(0), pyramid.index_at(0)
        ident = _identity(pyramid.servable)
        eid = _entry_id(ident["kind"], key)
        arrays = {f"stats/{k}": _host(v) for k, v in stats.items()}
        arrays["index/perm"] = _host(index.perm)
        arrays["index/offsets"] = _host(index.offsets)
        arrays["index/bucket_of"] = _host(index.bucket_of)
        np.savez(tmp / f"{eid}.npz", **arrays)
        entries.append({
            "id": eid,
            "identity": ident,
            "stats_keys": sorted(stats),
        })

    if not entries:
        # Nothing built yet (e.g. a periodic snapshot job firing before the
        # first request): never swap an empty snapshot over a good one.
        shutil.rmtree(tmp)
        return 0
    (tmp / MANIFEST).write_text(json.dumps({
        "version": FORMAT_VERSION,
        "entries": entries,
    }, indent=2))
    # Swap, never delete-then-rename: at every instant either <dir> or
    # <dir>.old holds a complete snapshot (restore falls back to .old), so
    # a crash mid-save can't lose the only copy.
    old = directory.parent / (directory.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    if directory.exists():
        directory.rename(old)
    tmp.rename(directory)
    if old.exists():
        shutil.rmtree(old)
    return len(entries)


def restore_store(store, directory, servables: Iterable) -> int:
    """Adopt matching snapshots from ``directory`` into ``store``, each on
    its servable's device.

    Each servable is matched against the manifest by its full identity; a
    mismatch (e.g. the shard was updated since the snapshot) is skipped.
    A missing snapshot directory restores nothing (returns 0) rather than
    raising.  Returns the number of pyramids restored.
    """
    directory = Path(directory)
    if not (directory / MANIFEST).exists():
        # A crash between save_store's two renames leaves the previous
        # complete snapshot at <dir>.old — recover from it.
        old = directory.parent / (directory.name + ".old")
        if (old / MANIFEST).exists():
            directory = old
        else:
            return 0
    manifest = json.loads((directory / MANIFEST).read_text())
    if manifest.get("version") != FORMAT_VERSION:
        # Incompatible snapshots are skipped like any identity mismatch:
        # warm start falls through to a cold build.
        return 0
    by_identity = {
        json.dumps(e["identity"], sort_keys=True): e
        for e in manifest["entries"]
    }

    restored = 0
    for servable in servables:
        ident = json.dumps(_identity(servable), sort_keys=True)
        entry = by_identity.get(ident)
        if entry is None:
            continue
        dev = servable.device
        with np.load(directory / f"{entry['id']}.npz") as arrays:
            stats = {
                k: torch.tensor(arrays[f"stats/{k}"], device=dev)
                for k in entry["stats_keys"]
            }
            index = agg_lib.BucketIndex(
                perm=torch.tensor(arrays["index/perm"], device=dev),
                offsets=torch.tensor(arrays["index/offsets"], device=dev),
                bucket_of=torch.tensor(arrays["index/bucket_of"], device=dev),
            )
        store.adopt(servable, stats, index, restored=True)
        restored += 1
    return restored
