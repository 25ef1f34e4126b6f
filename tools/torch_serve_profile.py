#!/usr/bin/env python3
"""Where a served kNN or CF batch's time goes, on one NVIDIA GPU: the
cost model's fit against the runs it prices, and each host step of the
server around them.

    python3 tools/torch_serve_profile.py [--waves N]

The data, servers and yardsticks are ``chip_smoke.py``'s serve phase: a
``KNNServable`` over all 2.3 M mfeat-factors points and a ``CFServable``
over all 48,019 Netflix users on one ``AggregateStore``, ``BudgetPolicy``
at the jobs' ratio and eps, ``ContinuousBatcher(max_batch=64)``, a live
tracer, flight recorder, 1 s rollup and the default SLO objectives.  For
each kind it prints:

- the fitted ``CostModel`` and, on the host clock up to a synchronise
  (median of five), one ``run`` at budget 0 and at eps_max's budget on
  ``calibrate``'s probe batch and on a batch of 64 real requests, beside
  what the model predicts for each;
- N waves (default 4) of 64 relaxed requests (a deadline ten times the
  relaxed class's, so every batch is granted eps_max), with each host step
  the server takes around a batch timed by wrapping it (``pad_batch``,
  ``run``, ``unpack``, ``error_bounds``, ``accuracy_proxy``,
  ``metrics.record``, ``metrics.record_batch``, ``slo.evaluate``, the
  whole ``_execute``): calls, median ms a call, and ms a batch (their sum
  over the batches);
- the load correction after the waves.

Ends with the card's name and power limit.  Exits non-zero when there is
no CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = ("pad_batch", "run", "unpack", "error_bounds", "accuracy_proxy")


def host_ms(torch, fn, n=5) -> float:
    """Median host ms of fn() up to a synchronise, after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def timed(acc, name, fn):
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        acc[name].append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def profile_kind(torch, cs, server, kind, rows, waves):
    from repro_torch.core.refine import eps_to_budget

    sv = server.servables[kind]
    server.calibrate(kind)
    server.controller.ema = 0.0
    server.prewarm(kind)
    server.reset_metrics()
    ctl = server.controller
    model, ratio = ctl.models[kind], ctl.policy.compression_ratio
    print(f"{kind}: CostModel {model}")
    prepared = sv.build(ratio)
    budget = eps_to_budget(sv.n_points, ctl.policy.eps_max)
    for name, batch in (("probe", sv.pad_batch([sv.probe_payload()] * 64,
                                                64)),
                        ("real", sv.pad_batch(rows[:64], 64))):
        for b in (0, budget):
            ms = host_ms(torch, lambda: sv.run(prepared, batch,
                                               refine_budget=b))
            want = model.predict(sv.n_points, ratio, b / sv.n_points) * 1e3
            print(f"{kind} {name} batch, budget {b}: run {ms:.3f} ms "
                  f"(the model's pass {want:.3f} ms)")
    acc = collections.defaultdict(list)
    for name in STEPS:
        setattr(sv, name, timed(acc, name, getattr(sv, name)))
    for name in ("record", "record_batch"):
        setattr(server.metrics, name,
                timed(acc, f"metrics.{name}", getattr(server.metrics, name)))
    server.slo.evaluate = timed(acc, "slo.evaluate", server.slo.evaluate)
    server._execute = timed(acc, "batch", server._execute)
    deadline = 10 * cs.slo_classes(server, kind)["relaxed"]
    for _ in range(waves):
        for p in rows[:64]:
            server.submit(kind, p, deadline)
        server.drain()
    batches = len(acc["batch"])
    for name, xs in acc.items():
        print(f"{kind} {name}: {len(xs)} calls, median "
              f"{statistics.median(xs):.3f} ms, {sum(xs) / batches:.3f} ms "
              f"a batch")
    print(f"{kind}: load correction {ctl.correction(kind):.4f} after "
          f"{batches} batches")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waves", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.apps import cf, knn
    from repro_torch.data.synthetic import (
        holdout_split, make_mfeat_like, make_netflix_like,
    )
    from repro_torch.kernels import _build
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.store import AggregateStore

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels(_build)
    train_x, train_y, test_x, _ = cs.make_data(torch, make_mfeat_like)
    nr, nm, a, am = cs.make_cf_data(torch, make_netflix_like,
                                    holdout_split)[:4]
    store = AggregateStore()
    for kind, app, data, rows in (
            ("knn", knn, (train_x, train_y), [(q,) for q in test_x[:64]]),
            ("cf", cf, (nr, nm), [(a[i], am[i]) for i in range(64)])):
        server = cs._make_server(
            [cs._servable(torch, kind, app, data, store)], kind,
            ContinuousBatcher(max_batch=cs.SERVE_BATCH), **cs._observed())
        profile_kind(torch, cs, server, kind, rows, args.waves)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
