"""Checkpointing with async save, atomic commit and restore by key, in the
on-disk format of ``src/repro/checkpoint/checkpoint.py``.

Layout:  <dir>/step_<N>/
           manifest.json        — step, flat keys with shapes and dtypes
           <key>.npy            — one file per leaf (``/`` in a key: ``__``)
         <dir>/LATEST           — atomically updated pointer

  * save is ATOMIC: a step directory is staged under a tmp name and renamed
    only after every leaf hit disk, so a failure mid-save never corrupts
    the restore point;
  * async save: every leaf is copied to the host before the writer thread
    starts (a CUDA tensor the train loop overwrites next is never read by
    the thread), and the disk I/O happens on the thread;
  * restore loads leaves by KEY (``repro_torch.tree``'s keys, JAX's), so a
    checkpoint of the JAX package restores here and the reverse;
  * data-pipeline state (step, rng seed) rides in the manifest's ``extra``.

Dtypes in the manifest are numpy's names.  numpy has no bfloat16: a bf16
leaf is written as the JAX package writes it (``ml_dtypes``' bfloat16
saves as the ``.npy`` descr ``<V2``: two raw bytes an element) with
``"dtype": "bfloat16"`` in the manifest, and restored by a bit-cast.
(The JAX package's own ``restore`` cannot read such a file back: ROADMAP
queue 3.)

Sharded trees: a DTensor leaf is saved whole (gathered over its mesh by
``parallel.sharding.gather``, the port's collectives: DTensor's own
``full_tensor`` crashes under gloo on CUDA tensors), so the files are the
same as an unsharded save's.  Such a save is a collective: every rank
calls it, rank 0 of the world writes, and a blocking save (or ``wait``)
ends at a barrier.  ``restore(..., shardings=)`` places each leaf by its
``NamedSharding`` (``parallel.sharding``) on that sharding's mesh, which
may differ from the one that saved: elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.device import resolve

BF16 = "bfloat16"

_NUMPY_DTYPES = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.int64: np.int64, torch.int32: np.int32,
    torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.bool: np.bool_,
}


def _is_dtensor(leaf: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` as numpy, its manifest dtype); a bf16
    tensor's copy is its bits as int16; a DTensor's, the whole tensor's."""
    if _is_dtensor(leaf):
        from repro_torch.parallel import sharding

        leaf = sharding.gather(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _save(path: Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bf16 leaf's bits under the descr ``<V2``, the
    bytes ``np.save`` writes for an ``ml_dtypes`` bfloat16 array."""
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _torch_dtype(leaf: Any) -> torch.dtype:
    """The dtype a template leaf asks for."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    np_dtype = np.asarray(leaf).dtype
    for t, n in _NUMPY_DTYPES.items():
        if np.dtype(n) == np_dtype:
            return t
    raise TypeError(f"no torch dtype for a template leaf of {np_dtype}")


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == BF16 and arr.dtype.kind == "V" and arr.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


class Checkpointer:
    """Saves and restores trees of tensors under ``directory``; restores
    onto ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, directory: str | os.PathLike, *,
                 device: str | torch.device = "cuda"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = device
        self._thread: threading.Thread | None = None
        self._collective = False

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             blocking: bool = True) -> Path:
        """Snapshot ``tree`` to the host and write step_<N> atomically."""
        leaves = tree_lib.flatten_with_path(tree)
        flat = {key: _host(leaf) for key, leaf in leaves}
        self._collective = any(_is_dtensor(leaf) for _, leaf in leaves)
        if self._thread is not None:
            self._thread.join()          # one async save in flight at a time

        def _write():
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {
                "step": step,
                "keys": {
                    k: {"shape": list(v.shape), "dtype": dtype}
                    for k, (v, dtype) in flat.items()
                },
                "extra": extra if extra is not None else {},
            }
            for k, (v, dtype) in flat.items():
                _save(tmp / (k.replace("/", "__") + ".npy"), v, dtype)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            latest_tmp = self.dir / ".LATEST.tmp"
            latest_tmp.write_text(str(step))
            latest_tmp.rename(self.dir / "LATEST")

        if self._collective and dist.get_rank() != 0:
            pass                         # rank 0 writes a sharded tree
        elif blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        if blocking:
            self._barrier()
        return self.dir / f"step_{step}"

    def _barrier(self):
        if self._collective:
            dist.barrier()
            self._collective = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> int | None:
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        return int(latest.read_text().strip())

    def restore(self, template: Any, *, step: int | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Load into the structure of ``template`` (a tree of tensors or
        numpy arrays: each leaf gives the shape and dtype), as tensors on
        the checkpointer's device.  ``shardings``, a matching tree of
        ``parallel.sharding.NamedSharding`` (or None leaves), places each
        leaf as a DTensor on its mesh: this rank's block, with no
        communication, so the mesh may differ from the one that saved.
        Returns (tree, extra)."""
        from repro_torch.parallel import sharding as sharding_lib

        dev = resolve(self.device)
        sh_leaves = (tree_lib.flatten_up_to(template, shardings)
                     if shardings is not None
                     else [None] * len(tree_lib.leaves(template)))
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        out = []
        for (key, leaf), sh in zip(tree_lib.flatten_with_path(template),
                                   sh_leaves):
            arr = np.load(d / (key.replace("/", "__") + ".npy"))
            shape = tuple(np.shape(leaf))
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"template {shape}"
                )
            dtype_name = manifest["keys"].get(key, {}).get("dtype", "")
            t = _to_tensor(arr, dtype_name).to(dtype=_torch_dtype(leaf))
            out.append(t.to(dev) if sh is None
                       else sharding_lib.place(t, sh, device=dev))
        return tree_lib.unflatten(template, out), manifest.get("extra", {})
