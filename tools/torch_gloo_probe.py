#!/usr/bin/env python3
"""Which collectives the gloo backend takes on CUDA tensors.

For each case it spawns a world of 2 ranks on one card, both on ``cuda:0``
(NCCL refuses two ranks of one communicator on one device), joined by gloo
(``repro_torch.launch.mesh.run_ranks``), and tries one collective the mesh path uses on CUDA tensors, then on CPU
tensors: ``torch.distributed``'s own calls, its functional collectives and
the DTensor calls the port makes.  Each line says ok (and whether the
answer is right) or the error's first line.  Run from the repository root:

    python3 tools/torch_gloo_probe.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch.launch.mesh import run_ranks  # noqa: E402


def _cases(dev, rank, world):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor, Partial, Replicate, Shard, distribute_tensor,
    )

    def t(*shape):
        return (torch.arange(int(torch.tensor(shape).prod()),
                             dtype=torch.float32) + 100 * rank).reshape(
            shape).to(dev)

    def all_reduce():
        x = t(4)
        dist.all_reduce(x)
        return torch.equal(x.cpu(), sum(torch.arange(4.0) + 100 * r
                                        for r in range(world)))

    def broadcast():
        x = t(4)
        dist.broadcast(x, 0)
        return torch.equal(x.cpu(), torch.arange(4.0))

    def all_gather_list():
        out = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(out, t(4))
        return all(torch.equal(o.cpu(), torch.arange(4.0) + 100 * r)
                   for r, o in enumerate(out))

    def all_gather_into_tensor():
        out = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(out, t(4))
        return torch.equal(out.cpu(), torch.cat(
            [torch.arange(4.0) + 100 * r for r in range(world)]))

    def reduce_scatter_tensor():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, t(2 * world))
        want = sum(torch.arange(2.0 * world) + 100 * r
                   for r in range(world))[2 * rank:2 * rank + 2]
        return torch.equal(out.cpu(), want)

    def reduce_scatter_list():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter(out, list(t(2 * world).chunk(world)))
        want = sum(torch.arange(2.0 * world) + 100 * r
                   for r in range(world))[2 * rank:2 * rank + 2]
        return torch.equal(out.cpu(), want)

    def all_to_all_single():
        out = torch.empty(2 * world, device=dev)
        dist.all_to_all_single(out, t(2 * world))
        want = torch.cat([(torch.arange(2.0 * world) + 100 * r)
                          [2 * rank:2 * rank + 2] for r in range(world)])
        return torch.equal(out.cpu(), want)

    def all_to_all_list():
        out = [torch.empty(2, device=dev) for _ in range(world)]
        dist.all_to_all(out, list(t(2 * world).chunk(world)))
        return all(torch.equal(o.cpu(), (torch.arange(2.0 * world) + 100 * r)
                               [2 * rank:2 * rank + 2])
                   for r, o in enumerate(out))

    def batch_isend_irecv():
        send = t(4)
        recv = torch.empty(4, device=dev)
        peer = (rank + 1) % world
        src = (rank - 1) % world
        ops = [dist.P2POp(dist.isend, send, peer),
               dist.P2POp(dist.irecv, recv, src)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.equal(recv.cpu(), torch.arange(4.0) + 100 * src)

    def funcol_all_gather():
        out = funcol.all_gather_tensor(t(4), 0, dist.group.WORLD)
        out = funcol.wait_tensor(out)
        return torch.equal(out.cpu(), torch.cat(
            [torch.arange(4.0) + 100 * r for r in range(world)]))

    def funcol_all_reduce():
        out = funcol.wait_tensor(funcol.all_reduce(t(4), "sum",
                                                   dist.group.WORLD))
        return torch.equal(out.cpu(), sum(torch.arange(4.0) + 100 * r
                                          for r in range(world)))

    def funcol_reduce_scatter():
        out = funcol.wait_tensor(funcol.reduce_scatter_tensor(
            t(2 * world), "sum", 0, dist.group.WORLD))
        want = sum(torch.arange(2.0 * world) + 100 * r
                   for r in range(world))[2 * rank:2 * rank + 2]
        return torch.equal(out.cpu(), want)

    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))

    def dtensor_from_local_full():
        d = DTensor.from_local(t(4), mesh, [Shard(0)], run_check=False)
        return torch.equal(d.full_tensor().cpu(), torch.cat(
            [torch.arange(4.0) + 100 * r for r in range(world)]))

    def dtensor_distribute():
        full = torch.arange(4.0 * world).to(dev)
        d = distribute_tensor(full, mesh, [Shard(0)])
        return torch.equal(d.to_local().cpu(),
                           torch.arange(4.0 * world)[4 * rank:4 * rank + 4])

    def dtensor_partial_to_replicate():
        d = DTensor.from_local(t(4), mesh, [Partial()], run_check=False)
        return torch.equal(d.redistribute(mesh, [Replicate()]).to_local()
                           .cpu(), sum(torch.arange(4.0) + 100 * r
                                       for r in range(world)))

    def dtensor_matmul():
        a = DTensor.from_local(t(2, 3), mesh, [Shard(0)], run_check=False)
        b = distribute_tensor(torch.ones(3, 2, device=dev), mesh,
                              [Replicate()])
        return tuple((a @ b).full_tensor().shape) == (2 * world, 2)

    return [all_reduce, broadcast, all_gather_list, all_gather_into_tensor,
            reduce_scatter_tensor, reduce_scatter_list, all_to_all_single,
            all_to_all_list, batch_isend_irecv, funcol_all_gather,
            funcol_all_reduce, funcol_reduce_scatter,
            dtensor_from_local_full, dtensor_distribute,
            dtensor_partial_to_replicate, dtensor_matmul]


def _case(rank, name, device):
    """One case on one world (a case gloo mishandles can break the world's
    connections, so each gets its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    case = {c.__name__: c for c in _cases(dev, rank,
                                           dist.get_world_size())}[name]
    try:
        ok = case()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return "ok" if ok else "WRONG ANSWER"
    except Exception as e:  # the probe records what each call does
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


CASES = ("all_reduce", "broadcast", "all_gather_list",
         "all_gather_into_tensor", "reduce_scatter_tensor",
         "reduce_scatter_list", "all_to_all_single", "all_to_all_list",
         "batch_isend_irecv", "funcol_all_gather", "funcol_all_reduce",
         "funcol_reduce_scatter", "dtensor_from_local_full",
         "dtensor_distribute", "dtensor_partial_to_replicate",
         "dtensor_matmul")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    results = {}
    for name in CASES:
        try:
            got = run_ranks(_case, 2, name, args.device,
                            device=args.device, timeout=args.timeout)
            results[name] = got[0] if got[0] == got[1] else \
                f"{got[0]} (rank 1: {got[1]})"
        except (RuntimeError, TimeoutError) as e:
            lines = [ln for ln in str(e).splitlines() if "Error" in ln]
            results[name] = "world failed: " + (lines[-1] if lines
                                                else str(e)[:160])
        print(f"gloo {args.device} {name}: {results[name]}", flush=True)
    print(json.dumps({"gloo_probe": args.device, "torch": torch.__version__,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
