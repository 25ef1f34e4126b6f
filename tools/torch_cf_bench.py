#!/usr/bin/env python3
"""Times the port's CF kernels at the CF path's shapes, on one NVIDIA GPU,
for one source tree of the port.

    python3 tools/torch_cf_bench.py [--src DIR] [--profile] [--small-check N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
repository's own by default), so that two versions can be compared in one
call on one card: run it on each, in turns (A, B, B, A).  The data, shapes
and yardstick are ``chip_smoke.py``'s: the Netflix subset from seed 1
(``make_cf_data``), its shard 0 of CF_USERS / N_SHARDS users, and its
``bench_ms`` (median of CUDA-event runs, the L2 cache flushed before each,
read with and without a head start for the card in alternate runs).  The
kernels' inputs are captured from the path's own map tasks on shard 0:

- ``cf_weights`` at the exact shard (``exact_map``), the sampled shard
  (``sampled_map`` at CF_SAMPLE_FRAC, permutation from seed 13) and stage
  1 against the shard's centroid profiles (``accurateml_map``);
- ``cf_refine`` at eps 0.05 (``accurateml_map``, LSH from seed 11, as
  ``run_accurateml`` draws shard 0's);
- ``cf_aggregate`` and ``lsh_hash`` in that map task's aggregation
  (``build_cf_aggregates``), where the tree has them.

Prints one JSON line: each entry's time with the head start, the same runs'
time without it under ``"... no head start"``, its bound (``chip_smoke.py``'s
``work`` and ``bound_ms``), the device memory a call allocates beyond its
inputs and outputs under ``"... scratch bytes"`` (the peak of
``torch.cuda.max_memory_allocated`` over a call, less the memory held
before it and the outputs), and the card's name and power limit.  With
``--profile`` each entry also gets ``"... kernels"``: the device ms of each
CUDA kernel of one call (``torch.profiler``), so that the compaction and
the kernel's main launch show apart.  With
``--small-check N`` it then runs ``chip_smoke.py``'s small CF check (card
against CPU, seeds 6 and 7) N times and reports each failure's message.
Exits non-zero when there is no CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def device_ms(torch, fn) -> dict[str, float]:
    """Device ms of each CUDA kernel in one warm call of fn (torch.profiler),
    by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.device_time_total > 0}


def scratch_bytes(torch, fn) -> int:
    """Peak device memory one call of fn allocates beyond what it returns."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    outs = result if isinstance(result, tuple) else (result,)
    kept = sum(t.numel() * t.element_size() for t in outs)
    return torch.cuda.max_memory_allocated() - before - kept


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--small-check", type=int, default=0, metavar="N")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_cf_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.apps import cf
    from repro_torch.core import lsh, refine
    from repro_torch.data.synthetic import holdout_split, make_netflix_like
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"src": str(args.src)}
    nr, nm, a, am, _, _ = cs.make_cf_data(torch, make_netflix_like,
                                          holdout_split)
    n_s = nr.shape[0] // cs.N_SHARDS
    sr, sm = nr[:n_s], nm[:n_s]
    del nr, nm
    torch.cuda.empty_cache()

    probe = cs.CaptureProbe(torch)
    ops.set_probe(probe)
    probe.tag = "exact shard"
    cf.exact_map(sr, sm, a, am)
    probe.tag = "sampled shard"
    perm = torch.randperm(n_s, generator=torch.Generator(dev).manual_seed(13),
                          device=dev)
    cf.sampled_map(sr, sm, a, am, perm,
                   n_sample=max(1, int(cs.CF_SAMPLE_FRAC * n_s)))
    probe.tag = f"eps {cs.CF_EPS_LEVELS[-1]}"
    cfg = lsh.config_for_compression(n_s, cs.CF_RATIO, n_hashes=4,
                                     bucket_width=8.0)
    params = lsh.init_lsh(torch.Generator(dev).manual_seed(11), cs.CF_ITEMS,
                          cfg)
    agg = cf.build_cf_aggregates(sr, sm, params)
    cf.accurateml_map(sr, sm, agg, a, am, refine_budget=refine.eps_to_budget(
        n_s, cs.CF_EPS_LEVELS[-1]))
    ops.set_probe(None)

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    for op in cs.CF_KERNELS:
        for key, (call_args, kwargs) in probe.calls.get(op, {}).items():
            wrapper = cs.kernel_fns(ops, ref, op, kwargs)[0]
            name = f"{op} {cs._shape(key, call_args, kwargs)}"
            out[name], out[f"{name} no head start"] = cs.bench_ms(
                torch, lambda: wrapper(*call_args, **kwargs), flush)
            out[f"{name} bound"] = cs.bound_ms(
                *cs.work(torch, op, call_args, kwargs))[0]
            out[f"{name} scratch bytes"] = scratch_bytes(
                torch, lambda: wrapper(*call_args, **kwargs))
            if args.profile:
                out[f"{name} kernels"] = device_ms(
                    torch, lambda: wrapper(*call_args, **kwargs))
    del probe, flush, agg, sr, sm

    fails = []
    for _ in range(args.small_check):
        try:
            cs.cf_small_check(torch, cf, lsh, refine, ops, make_netflix_like,
                              holdout_split)
        except SystemExit as e:   # chip_smoke.fail: the check's own message
            fails.append(str(e))
    if args.small_check:
        out["small_check"] = {"runs": args.small_check, "failures": fails}

    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
