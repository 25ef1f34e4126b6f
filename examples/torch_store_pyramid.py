"""Aggregate-store walkthrough on the PyTorch port: pyramid reuse,
streaming ingest, warm-start.

Demonstrates the three lifecycle axes ``repro_torch.store`` owns, as
``examples/store_pyramid.py`` does with the JAX package:

  1. resolutions — build the finest aggregate level once, answer every
     other compression ratio by merging (bit-identical to a cold build);
  2. time        — stream new points into level-0 statistics with
     fixed-shape delta updates; the index re-sorts on a staleness schedule;
  3. processes   — snapshot to disk and warm-start a "restarted server"
     whose first request is already a cache hit.

It runs on the card unless ``--device cpu`` asks for the plain versions.

    PYTHONPATH=src python examples/torch_store_pyramid.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

import torch

from repro_torch.apps.knn import KNNServable
from repro_torch.core import lsh as lsh_lib
from repro_torch.data.synthetic import make_mfeat_like
from repro_torch.device import block_until_ready, resolve
from repro_torch.serve.cache import AggregateCache
from repro_torch.store import AggregateStore, StreamingAggregate

N, D, C = 20_000, 32, 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    def key(seed):
        return torch.Generator(dev).manual_seed(seed)

    x, y = make_mfeat_like(
        key(0), n_points=N, n_features=D, n_classes=C,
        modes_per_class=24, mode_scale=0.5, device=dev,
    )
    servable = KNNServable(
        x, y, n_classes=C, k=5, lsh_generator=key(7), device=dev
    )
    spec = servable.pyramid_spec
    print(f"pyramid: base K={spec.base_buckets}, {spec.n_levels} levels, "
          f"ratios {spec.ratio(0):.0f}..{spec.ratio(spec.n_levels - 1):.0f}")

    # ---- 1. multi-resolution reuse ----
    t0 = time.perf_counter()
    fine, source = servable.store.get(servable, 8.0)
    block_until_ready(fine.agg.means)
    t_build = time.perf_counter() - t0
    print(f"ratio 8   -> {source:8s} K={fine.agg.n_buckets:5d} "
          f"({t_build * 1e3:.1f} ms)")
    for ratio in (16.0, 64.0, 256.0):
        t0 = time.perf_counter()
        lvl, source = servable.store.get(servable, ratio)
        block_until_ready(lvl.agg.means)
        print(f"ratio {ratio:<4.0f}-> {source:8s} K={lvl.agg.n_buckets:5d} "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    print("store:", servable.store.stats())

    # ---- 2. streaming ingest ----
    cfg = lsh_lib.LSHConfig(
        n_hashes=4, bucket_width=4.0, n_buckets=spec.base_buckets
    )
    params = lsh_lib.init_lsh(key(7), D, cfg, device=dev)
    stream = StreamingAggregate(
        params, D, capacity=4096, chunk=256,
        extra_shapes={"label_hist": (C,)}, device=dev,
    )
    onehot = torch.nn.functional.one_hot(y[:3000].long(), C).float()
    for start in range(0, 3000, 500):
        stream.append(
            x[start:start + 500], label_hist=onehot[start:start + 500]
        )
        print(f"appended 500 rows -> n={stream.n}, "
              f"stale={stream.stale_points}, "
              f"rebucket due={stream.needs_rebucket}")
    stats, index, n = stream.level0()   # runs the scheduled re-sort
    print(f"level0 snapshot: {n} rows indexed, "
          f"{int(stats['counts'].sum())} counted, stale={stream.stale_points}")

    # ---- 3. snapshot -> warm-started "restarted server" ----
    snap = tempfile.mkdtemp(prefix="store_demo_")
    try:
        servable.store.save(os.path.join(snap, "agg"))
        restarted = KNNServable(          # fresh process stand-in
            x, y, n_classes=C, k=5, lsh_generator=key(7),
            store=AggregateStore(), device=dev,
        )
        t0 = time.perf_counter()
        restarted.store.restore(os.path.join(snap, "agg"), [restarted])
        cache = AggregateCache()
        warmed = cache.warm_from_store([restarted], ratios=[8.0])
        t_warm = time.perf_counter() - t0
        _, hit = cache.get_or_build(restarted, 8.0)
        print(f"warm-start: {warmed} cache entry in {t_warm * 1e3:.1f} ms "
              f"(vs {t_build * 1e3:.1f} ms cold build); "
              f"first request hit={hit}")
        check, _ = restarted.store.get(restarted, 8.0)
        same = bool(torch.equal(check.agg.means, fine.agg.means))
        print(f"restored means bit-identical to original build: {same}")
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
