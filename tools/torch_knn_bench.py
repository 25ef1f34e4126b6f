#!/usr/bin/env python3
"""Times the kNN path's stage-2 kernels, ``refine_distances`` and
``candidate_topk``, on the path's own selection, on one NVIDIA GPU, for one
source tree of the port.

    python3 tools/torch_knn_bench.py [--src DIR] [--profile]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (the
repository's own by default), so that two versions can be compared in one
call on one card: run it on each, in turns (A, B, B, A).  The inputs are
those of ``chip_smoke.py``'s ``run_accurateml`` at eps_max 0.01 on shard 0:
its ``make_data`` (mfeat-factors scale, seed 0), the first LSH draw of seed
1, the shard's aggregates, each query's ranking by its centroid distances
and ``refinement_indices`` at the shard's budget.  A random ``idx`` has
none of the path's reuse and is not timed.  Timed, with ``chip_smoke.py``'s
``bench_ms`` (the L2 cache flushed before each run, with and without the
card's head start, in alternate runs):

- ``refine_distances`` on the selection ([1024, 2875] slots of 217
  features), the bucket of each row passed where the tree's kernel takes it;
- ``candidate_topk`` at the path's calls: the seed from the masked
  centroids ([1024, 2875], k 5), the refined candidates into it ([1024,
  2875], seeded, k 5 and the with-bound k 6), and ``apps.knn.merge_topk``
  over 8 shards' [1024, 5] lists (its launches are reported: the pairwise
  folds, or one launch over the stack).

It also reports the selection's reuse (valid slots against distinct rows),
and with ``--profile`` the device time of each kernel of one
``refine_distances`` call by name (``torch.profiler``): the schedule's
share.  Each source's registers and spills come from its ``-Xptxas -v``
log.  Prints one JSON line with the card's name and power limit.  Exits
non-zero when there is no CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EPS = 0.01


def kernel_device_ms(torch, fn) -> dict:
    """Device ms of each kernel one call of fn() launches, by name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = next((float(getattr(evt, a)) for a in
                   ("self_device_time_total", "self_cuda_time_total")
                   if hasattr(evt, a)), 0.0)
        if us > 0 and "kernel" in evt.key.lower():
            out[evt.key[:80]] = us / 1e3
    return out or {"device time": "not measured"}


def ptxas(log: Path) -> list[str]:
    """Per-kernel registers and spills from an nvcc -Xptxas=-v log."""
    lines, name = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name[:60]}: {m.group(1)} registers")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and lines:
            lines[-1] += f", spills {m.group(1)}/{m.group(2)} B"
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_knn_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.apps import knn
    from repro_torch.core import aggregate as agg_lib
    from repro_torch.core import correlation, lsh, refine
    from repro_torch.data.synthetic import make_mfeat_like
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.candidate_topk import candidate_topk_cuda
    from repro_torch.kernels.topk_stream import BIG

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"src": str(args.src)}
    build = _build.build_all()
    for name in ("refine_distances", "candidate_topk"):
        out[f"{name} ptxas"] = ptxas(build / f"{name}.log")

    tx, ty, qx, _ = cs.make_data(torch, make_mfeat_like)
    n_s = tx.shape[0] // cs.N_SHARDS
    sx, sy = tx[:n_s].contiguous(), ty[:n_s].contiguous()
    del tx, ty
    cfg = lsh.config_for_compression(n_s, cs.RATIO)
    params = lsh.init_lsh(torch.Generator("cuda").manual_seed(1), sx.shape[1],
                          cfg, device="cuda")
    knn_agg = knn.build_knn_aggregates(sx, sy, params, cs.N_CLASSES)
    agg = knn_agg.agg
    budget = refine.eps_to_budget(n_s, EPS)
    d_cent = ops.knn_distance(qx, agg.means)
    d_cent = torch.where(agg.counts[None, :] > 0, d_cent, BIG)
    ranking = correlation.rank_buckets_multi(-d_cent, agg.counts)
    idx, valid = agg_lib.refinement_indices(agg, ranking, budget)
    covered = agg_lib.buckets_fully_covered(agg, ranking, budget)
    d_masked = torch.where(covered & (agg.counts[None, :] > 0), BIG, d_cent)
    cent_l = knn_agg.bucket_labels[None, :].expand(d_cent.shape).contiguous()
    rows = idx[valid]
    out["selection"] = {
        "slots": list(idx.shape), "valid": int(valid.sum()),
        "distinct_rows": int(torch.unique(rows).numel()),
        "buckets": agg.n_buckets,
        "reads_per_row": int(valid.sum()) / max(1, int(torch.unique(rows)
                                                       .numel())),
    }
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def bench(key, fn):
        out[key], out[f"{key} no head start"] = cs.bench_ms(torch, fn, flush)

    takes_buckets = "bucket_of" in inspect.signature(
        ops.refine_distances).parameters
    if takes_buckets:
        def refine_call():
            return ops.refine_distances(qx, sx, idx, valid, agg.bucket_of,
                                        n_buckets=agg.n_buckets)
    else:
        def refine_call():
            return ops.refine_distances(qx, sx, idx, valid)
    d_ref = refine_call()
    want = ops.ref.refine_distances(qx, sx, idx, valid)
    out["refine_distances max_abs_err"] = float(
        (d_ref - want)[valid].abs().max())
    del want
    bench(f"refine_distances {list(idx.shape)}x{sx.shape[1]}", refine_call)
    if args.profile:
        out["refine_distances kernels device ms"] = kernel_device_ms(
            torch, refine_call)

    ref_y = sy[idx.long()]
    best_d, best_l = ops.candidate_topk(d_masked, cent_l, k=cs.K)
    bench(f"candidate_topk seed {list(d_masked.shape)} k={cs.K}",
          lambda: ops.candidate_topk(d_masked, cent_l, k=cs.K))
    bench(f"candidate_topk refined {list(d_ref.shape)} k={cs.K} seeded",
          lambda: ops.candidate_topk(d_ref, ref_y, best_d, best_l, k=cs.K))
    kk = cs.K + 1
    best6 = ops.candidate_topk(d_masked, cent_l, k=kk)
    bench(f"candidate_topk refined {list(d_ref.shape)} k={kk} seeded",
          lambda: ops.candidate_topk(d_ref, ref_y, *best6, k=kk))

    gen = torch.Generator("cuda").manual_seed(2)
    shards_d = torch.sort(torch.rand((cs.N_SHARDS, cs.N_QUERY, cs.K),
                                     generator=gen, device="cuda"),
                          dim=-1).values
    shards_l = torch.randint(0, cs.N_CLASSES, shards_d.shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    before = candidate_topk_cuda.launches
    knn.merge_topk(shards_d, shards_l, cs.K)
    out["merge_topk launches"] = candidate_topk_cuda.launches - before
    bench(f"merge_topk {list(shards_d.shape)}",
          lambda: knn.merge_topk(shards_d, shards_l, cs.K))

    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
