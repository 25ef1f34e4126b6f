"""Meshes and the launcher of the port's ranks, as ``src/repro/launch/mesh.py``
builds its meshes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
an initialised world, with the JAX package's shapes and axis names; its
axes' process groups carry the collectives (``parallel/collectives.py``).
Meshes are built by FUNCTIONS, never at import.

``run_ranks`` starts a world: N spawned processes, each running one
function, joined by the gloo backend through a ``file://`` store in a
temporary directory (no fixed port, so that worlds started at the same
time by different processes never meet).  Each rank runs on the card
(``cuda:rank % device_count``, so the ranks of a one-card machine share
it) unless the caller asks for the CPU; ``torch.set_num_threads(1)`` in
each.  It returns every rank's result, or raises the first failed rank's
error, within a timeout of its own.
"""
from __future__ import annotations

import datetime
import math
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape: tuple, axes: tuple, device, hint: str) -> DeviceMesh:
    dev = resolve(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world: start the ranks with "
                           "repro_torch.launch.mesh.run_ranks")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {world} — {hint}")
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), over
    the first prod(shape) ranks of the world."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return _mesh(shape, axes, device,
                 f"run {math.prod(shape)} ranks (launch.mesh.run_ranks)")


def make_host_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device: str | torch.device = "cuda") -> DeviceMesh:
    """A small mesh over the first prod(shape) ranks of the world."""
    return _mesh(tuple(shape), tuple(axes), device,
                 f"run {math.prod(shape)} ranks (launch.mesh.run_ranks)")


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a mapping (the
    sharding rules take either, so that they run without a world)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return mesh.get_coordinate() is not None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, tmp: str, device: str,
               timeout_s: float, args: tuple) -> None:
    torch.set_num_threads(1)
    out = Path(tmp)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
            torch.save(result, out / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(fn: Callable[..., Any], n_ranks: int, *args: Any,
              device: str | torch.device = "cuda",
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``n_ranks`` spawned ranks of one world
    and return their results in rank order (each saved by ``torch.save``).

    ``fn`` must be importable by name (a module-level function); CPU
    tensors in ``args`` reach the ranks through shared memory.  A rank that
    raises stops the world: the others are ended and its traceback raised.
    Past ``timeout`` seconds every rank is ended and ``TimeoutError``
    raised.
    """
    dev = resolve(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n_ranks, tmp, dev.type, timeout,
                                   args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks still running "
                                       f"after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.exitcode),
                          None)
        errs = {r: Path(tmp, f"rank{r}.err") for r in range(n_ranks)}
        if failed is not None:
            text = "\n".join(f"rank {r}:\n{e.read_text()}"
                             for r, e in errs.items() if e.exists())
            raise RuntimeError(f"rank {failed} of {n_ranks} failed "
                               f"(exit code {procs[failed].exitcode}):\n"
                               f"{text}")
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n_ranks)]
