#!/usr/bin/env python3
"""Times the port's two distance kernels at the main path's shapes, on one
NVIDIA GPU, for one source tree of the port.

    python3 tools/torch_select_bench.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
repository's own by default), so that two versions can be compared in one
call on one card: run it on each, in turns (A, B, B, A).  The shapes and
the yardstick are ``chip_smoke.py``'s: its constants, and its
``bench_ms`` (median of CUDA-event runs, the L2 cache flushed before each,
read with and without a head start for the card in alternate runs).  On
random inputs from seed 0:

- ``knn_distance`` at kNN stage 1, [N_QUERY, shard / RATIO] x N_FEATURES
  ([1024, 2875] x 217), and ``torch.cdist`` on the same inputs;
- ``distance_topk`` (l2) at the kNN shapes: a shard [1024, 287,500] x 217
  at k K (5), the sampled shard [1024, 28,750] at k 5, stage 1
  [1024, 2875] at k 5 and 6 (a tenth of the centroids masked as empty);
- ``models.aggregated_kv.select_buckets``, the LM's stage-1 selection of a
  layer (LM_ARCH's KV heads, query groups and head width; LM_S_MAX /
  LM_COMPRESSION buckets, a tenth empty), at B LM_SLOTS with R from
  each refine_frac of LM_SWEEP above 0, and at B 1 with R of rf 1.0 (a
  prefill token): the call's time and its ``distance_topk`` launches.

Prints one JSON line: each entry's time with the head start, the same
runs' time without it under ``"... no head start"``, and the card's name
and power limit.  Exits non-zero when there is no CUDA device.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_select_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.distance_topk import distance_topk_cuda
    from repro_torch.models.aggregated_kv import refine_count, select_buckets

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {"src": str(args.src)}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def bench(key, fn):
        out[key], out[f"{key} no head start"] = cs.bench_ms(torch, fn, flush)

    shard = cs.N_TRAIN // cs.N_SHARDS
    n_cents = int(shard / cs.RATIO)
    d = cs.N_FEATURES
    queries = randn(cs.N_QUERY, d)
    cents = randn(n_cents, d)
    bench(f"knn_distance [{cs.N_QUERY},{n_cents}]x{d}",
          lambda: ops.knn_distance(queries, cents))
    bench(f"torch.cdist [{cs.N_QUERY},{n_cents}]x{d}",
          lambda: torch.cdist(queries, cents))
    for n, k in ((shard, cs.K), (int(shard * cs.SAMPLE_FRAC), cs.K),
                 (n_cents, cs.K), (n_cents, cs.K + 1)):
        pts = randn(n, d)
        labels = torch.randint(0, cs.N_CLASSES, (n,), generator=gen,
                               device=dev, dtype=torch.int32)
        valid = (torch.rand(n, generator=gen, device=dev) >= 0.1
                 if n == n_cents else None)
        bench(f"distance_topk [{cs.N_QUERY},{n}]x{d} k={k}",
              lambda: ops.distance_topk(queries, pts, labels, valid, k=k))
        del pts

    cfg = get_config(cs.LM_ARCH)
    groups = cfg.n_heads // cfg.n_kv_heads
    n_buckets = cs.LM_S_MAX // cs.LM_COMPRESSION
    cases = [(cs.LM_SLOTS, refine_count(rf, n_buckets))
             for rf in cs.LM_SWEEP if rf > 0]
    cases.append((1, refine_count(1.0, n_buckets)))
    for b, r in cases:
        qg = randn(b, cfg.n_kv_heads, groups, cfg.head_dim).to(torch.bfloat16)
        mean_k = randn(b, n_buckets, cfg.n_kv_heads, cfg.head_dim)
        counts = torch.randint(1, 20, (b, n_buckets), generator=gen,
                               device=dev, dtype=torch.int32)
        counts[torch.rand(b, n_buckets, generator=gen, device=dev) < 0.1] = 0
        before = distance_topk_cuda.launches
        select_buckets(qg, mean_k, counts, n_refine=r)
        torch.cuda.synchronize()
        key = f"select_buckets B={b} R={r}"
        out[f"{key} launches"] = distance_topk_cuda.launches - before
        bench(key, lambda: select_buckets(qg, mean_k, counts, n_refine=r))

    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
