#!/usr/bin/env python3
"""Times the port's ``lsh_hash`` kernel and the LSH step at the kNN and CF
paths' shard shapes, on one NVIDIA GPU, for one source tree of the port.

    python3 tools/torch_lsh_bench.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
repository's own by default), so that two versions can be compared in one
call on one card: run it on each, in turns (A, B, B, A).  The data, shapes
and yardstick are ``chip_smoke.py``'s (this checkout's): kNN shard 0 of
``make_data`` (287,500 x 217) and CF shard 0's centred profiles of
``make_cf_data`` (6,002 x 17,700), each with its path's LSH config drawn
from seed 14 as ``lsh_phase`` draws it, and ``bench_ms`` (median of
CUDA-event runs, the L2 cache flushed before each, read with and without a
head start for the card in alternate runs).  For each shard:

- ``raw``: ``ops.lsh_hash``, the kernel's [N, H] hashes;
- ``ids``: ``ops.lsh_bucket_ids``, the kernel's [N] bucket ids, where the
  tree has it;
- ``step``: ``core.lsh.bucket_ids``, the LSH step as the path runs it (in a
  tree without the ids epilogue: the product and the signature's eager
  operations), with its count of CUDA kernel launches (``torch.profiler``);

each beside the plain version's time (``ref.lsh_hash``; for ids and step
``ref.lsh_bucket_ids`` where the tree has it) and the bound (``work`` and
``bound_ms``); and ``read``, one ``torch.sum`` over the shard, the time of
one PyTorch pass that reads X once under the same timing (a yardstick of
what a read stream reaches with the L2 cache flushed before each run, not
a function the port calls).  Prints one JSON line with the card's name and
power limit.
Exits non-zero when there is no CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def kernel_launches(torch, fn) -> int:
    """CUDA kernels one warm call of fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_lsh_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import lsh
    from repro_torch.data.synthetic import (
        holdout_split, make_mfeat_like, make_netflix_like,
    )
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tx, _, _, _ = cs.make_data(torch, make_mfeat_like)
    knn_x = tx[:tx.shape[0] // cs.N_SHARDS].clone()
    del tx
    nr, nm, _, _, _, _ = cs.make_cf_data(torch, make_netflix_like,
                                         holdout_split)
    cf_n = nr.shape[0] // cs.N_SHARDS
    cf_x = ref._centred(nr[:cf_n], nm[:cf_n])
    del nr, nm
    torch.cuda.empty_cache()

    out = {"src": str(args.src)}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    ids_op = getattr(ops, "lsh_bucket_ids", None)
    ids_plain = getattr(ref, "lsh_bucket_ids", None)
    for shard, x, cfg in (
        ("kNN", knn_x, lsh.config_for_compression(knn_x.shape[0], cs.RATIO)),
        ("CF", cf_x, lsh.config_for_compression(
            cf_x.shape[0], cs.CF_RATIO, n_hashes=4, bucket_width=8.0)),
    ):
        params = lsh.init_lsh(torch.Generator(dev).manual_seed(14),
                              x.shape[1], cfg)
        w = cfg.bucket_width
        raw = (x, params.a, params.b, w)
        ids_kw = {"base": cfg.n_buckets}
        calls = {
            "raw": (lambda: ops.lsh_hash(*raw),
                    lambda: ref.lsh_hash(*raw), {}),
            "ids": (ids_op and (lambda: ids_op(*raw, **ids_kw)),
                    ids_plain and (lambda: ids_plain(*raw, **ids_kw)),
                    ids_kw),
            "step": (lambda: lsh.bucket_ids(x, params),
                     ids_plain and (lambda: ids_plain(*raw, **ids_kw)),
                     ids_kw),
        }
        for name, (fn, plain, kw) in calls.items():
            if fn is None:
                continue
            key = f"{shard} {name} {'x'.join(map(str, x.shape))}"
            ms, ms_nh = cs.bench_ms(torch, fn, flush)
            entry = {"ms": ms, "no_head_start_ms": ms_nh,
                     "bound_ms": cs.bound_ms(*cs.work(
                         torch, "lsh_hash", raw, kw))[0]}
            if plain is not None:
                entry["plain_ms"], entry["plain_no_head_start_ms"] = (
                    cs.bench_ms(torch, plain, flush))
            if name == "step":
                entry["kernel_launches"] = kernel_launches(torch, fn)
            out[key] = entry
        out[f"{shard} read {'x'.join(map(str, x.shape))}"] = dict(zip(
            ("ms", "no_head_start_ms"),
            cs.bench_ms(torch, lambda: torch.sum(x), flush)))
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
