#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's kNN jobs, on one NVIDIA GPU.

    python3 tools/torch_knn_profile.py [--out results/knn_profile.json]
                                       [--src DIR] [--runs N]

Builds the data and the jobs of ``chip_smoke.py``'s main path (its
``make_data`` and ``knn_jobs``: mfeat-factors scale, 2.3 M points x 217
features x 10 classes, 1024 queries, 8 shards), runs each job once to warm
up, then for each job:

- its warm time on the host clock up to a synchronise, the median of
  ``--runs`` runs, three by default (``job_ms``; host times spread, so
  compare medians of many runs);
- one more run under ``torch.profiler`` with CPU and CUDA activity: the
  device time summed over every kernel and copy (``device_ms``), the idle
  share of the card over that run (1 - device / wall), the number of
  kernels and copies the card ran (``device_launches``), and the device
  time of the ten costliest operations by name, with the ported kernels'
  share.

and ``lsh_step``: ``run_accurateml``'s LSH step alone, ``core.lsh.bucket_ids``
on each of the 8 shards with the job's own draws (seed 1, in shard order),
once warm and once under the profiler: its device ms and its number of
kernels and copies a job.

Prints one JSON line with the results and the card's name and power limit,
and writes the same object to ``--out`` when given.  ``--src`` is the
``src`` directory whose ``repro_torch`` is imported (the repository's own
by default), so that two versions can be compared in one call.  Exits
non-zero when there is no CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Names of the kNN path's kernels' launches, as the profiler lists them
# (refine_distances makes refine_mark_kernel, refine_plan_kernel, ...).
PORTED = ("distance_topk", "candidate_topk", "knn_distance", "refine_",
          "lsh_kernel")


def _device_us(evt) -> float:
    """Device time of one averaged event; 0 for host operations, whose
    kernels are events of their own (counting both would count twice)."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profiled(torch, fn):
    """(wall ms, [(name, device ms)], device launches) of one call of fn
    under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    ops = sorted(((e.key, _device_us(e) / 1e3) for e in events),
                 key=lambda kv: -kv[1])
    return wall_ms, ops, sum(e.count for e in events)


def lsh_step(torch, knn, lsh, tx, n_shards, ratio) -> dict:
    """run_accurateml's LSH step alone: bucket_ids of every shard with the
    job's draws (seed 1, in shard order), warm, then profiled."""
    gen = torch.Generator("cuda").manual_seed(1)
    calls = []
    for sl in knn._shard_slices(tx.shape[0], n_shards):
        sx = tx[sl]
        cfg = lsh.config_for_compression(sx.shape[0], ratio)
        calls.append((sx, lsh.init_lsh(gen, sx.shape[1], cfg)))

    def step():
        for sx, params in calls:
            lsh.bucket_ids(sx, params)

    step()
    _, ops, launches = _profiled(torch, step)
    return {"device_ms": sum(ms for _, ms in ops),
            "device_launches": launches,
            "top_ops_device_ms": [[name[:80], ms] for name, ms in ops[:5]]}


def profile_job(torch, fn, runs: int) -> dict:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms, ops, launches = _profiled(torch, fn)
    device_ms = sum(ms for _, ms in ops)
    ported_ms = sum(ms for name, ms in ops
                    if any(p in name for p in PORTED))
    return {
        "job_ms": statistics.median(times),
        "job_ms_runs": times,
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms if device_ms > 0 else "not measured",
        "idle_share": (1.0 - device_ms / wall_ms) if device_ms > 0
        else "not measured",
        "device_launches": launches,
        "ported_kernels_ms": ported_ms,
        "top_ops_device_ms": [[name[:80], ms] for name, ms in ops[:10]],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_knn_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke
    from repro_torch.apps import knn
    from repro_torch.core import lsh
    from repro_torch.data.synthetic import make_mfeat_like

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    tx, ty, qx, _ = chip_smoke.make_data(torch, make_mfeat_like)
    jobs = chip_smoke.knn_jobs(torch, knn, tx, ty, qx)
    for fn in jobs.values():          # warm-up: build, load, first launches
        fn()
    result = {"device": smi, "torch": torch.__version__,
              "src": str(args.src),
              "jobs": {name: profile_job(torch, fn, args.runs)
                       for name, fn in jobs.items()},
              "lsh_step": lsh_step(torch, knn, lsh, tx, chip_smoke.N_SHARDS,
                                   chip_smoke.RATIO)}
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
