"""Fault-domain serving demo on the PyTorch port: the front door under a
burst and a killed shard, end to end in thread mode, as
``examples/chaos_serving.py`` does with the JAX package.

A sharded kNN fleet behind ``FrontDoor``:

  1. healthy phase — the worker thread serves a trickle;
  2. burst phase — the front door is paused and a burst larger than the
     admission queue arrives: the load-shed ladder walks down (fleet-wide
     eps degradation) rung by rung BEFORE the first typed ``Overloaded``
     rejection, deterministically;
  3. chaos phase — shard 1 is killed: batches complete from the three
     survivors (answers flagged ``partial_shards``), then the shard
     restores from its aggregate snapshot and answers lose the flag.

Exits non-zero unless: >=1 shed step happened, >=1 shard kill was
recovered, the shed-before-reject ordering held, and *every* submitted
rid has a terminal answer (degraded/rejected answers count, silent drops
fail).  CI runs this as the chaos smoke step.  The fleet runs on the card
unless ``--device cpu`` asks for the plain versions.

    PYTHONPATH=src python examples/torch_chaos_serving.py [--device cpu]
    REPRO_BENCH_TINY=1 ...   # CI smoke sizes
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core.budget import BudgetPolicy
from repro_torch.device import resolve
from repro_torch.runtime import ChaosInjector, sharded_knn
from repro_torch.serve import (
    ContinuousBatcher, DeadlineController, FrontDoor, Overloaded, Response,
    Server,
)

TINY = bool(os.environ.get("REPRO_BENCH_TINY"))
N_POINTS = 2_048 if TINY else 8_192
DIM, CLASSES, SHARDS, BATCH = 16, 10, 4, 4
QUEUE_LIMIT = 4
BURST = 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    snapshot_dir = tempfile.mkdtemp(prefix="chaos_serving_snap_")
    try:
        return _serve(dev, snapshot_dir)
    finally:
        shutil.rmtree(snapshot_dir, ignore_errors=True)


def _serve(dev, snapshot_dir) -> int:
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(N_POINTS, DIM)), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.integers(0, CLASSES, size=N_POINTS),
                     dtype=torch.int32, device=dev)
    queries = torch.tensor(rng.normal(size=(64, DIM)), dtype=torch.float32,
                           device=dev)

    chaos = ChaosInjector(seed=3)
    # one generator for the fleet: each domain draws its own LSH family
    lsh = torch.Generator(dev).manual_seed(5)
    fleet = sharded_knn(
        x, y, n_shards=SHARDS, n_classes=CLASSES, k=5,
        lsh_generators=[lsh] * SHARDS, chaos=chaos,
        recovery_batches=2, snapshot_dir=snapshot_dir, device=dev,
    )
    server = Server(
        [fleet],
        controller=DeadlineController(
            BudgetPolicy(compression_ratio=16.0, eps_max=0.08,
                         degrade_floor=0.002)
        ),
        batcher=ContinuousBatcher(max_batch=BATCH),
    )
    server.calibrate("knn", batch=BATCH)
    server.prewarm("knn", batch=BATCH)
    fleet.save_snapshot(snapshot_dir)
    deadline_s = max(
        20.0 * server.controller.deadline_for("knn", fleet.n_points, 0.08),
        0.05,
    )
    fd = FrontDoor(
        server, queue_limit=QUEUE_LIMIT, default_deadline_s=deadline_s,
        poll_s=0.001,
    )

    all_rids: list[int] = []
    failures: list[str] = []

    def submit(n, offset=0):
        rids = [
            fd.submit("knn", (queries[(offset + i) % queries.shape[0]],))
            for i in range(n)
        ]
        all_rids.extend(rids)
        return rids

    # ---- phase 1: healthy trickle through the worker thread ----
    # Closed-loop one-at-a-time: a trickle, not a burst — the ladder must
    # stay at rung 0 and every answer must be clean (all four shards).
    fd.start()
    healthy = []
    for i in range(2 * BATCH):
        (rid,) = submit(1, offset=i)
        healthy.append(rid)
        r = fd.wait(rid, timeout_s=60.0)
        if not isinstance(r, Response) or r.partial_shards:
            failures.append(f"healthy rid {rid} not served cleanly: {r!r}")
    print(f"healthy: {len(healthy)} served, shed level {fd.ladder.level}")

    # ---- phase 2: burst while paused -> shed ladder, then rejects ----
    fd.stop()  # deterministic: nothing drains while the burst lands
    burst = submit(BURST, offset=8)
    stats = fd.stats()
    print(
        f"burst: admitted {stats['admitted']}, "
        f"rejected {stats['rejected']}, "
        f"shed transitions {[t['to'] for t in stats['shed_transitions']]}"
    )
    fd.start()  # drain the backlog
    burst_results = [fd.wait(rid, timeout_s=120.0) for rid in burst]
    n_rej = sum(1 for r in burst_results if isinstance(r, Overloaded))
    downs = [
        t for t in fd.stats()["shed_transitions"] if t["to"] > t["from"]
    ]
    if not downs:
        failures.append("burst phase produced no shed step")
    if n_rej < 1:
        failures.append("burst phase produced no Overloaded rejection")
    if not fd.stats()["shed_before_reject"]:
        failures.append("rejection happened before the first shed step")

    # ---- phase 3: kill shard 1, serve through it, recover ----
    fd.stop()
    chaos.kill(1, fleet.step)
    fd.start()
    partial_seen = 0
    for wave in range(6):
        rids = submit(BATCH, offset=16 + wave * BATCH)
        for rid in rids:
            r = fd.wait(rid, timeout_s=60.0)
            if isinstance(r, Response) and r.partial_shards:
                partial_seen += 1
    fd.stop()
    fleet_summary = fleet.summary()
    if fleet_summary["kills"] < 1:
        failures.append("chaos phase killed no shard")
    if fleet_summary["recoveries"] < 1:
        failures.append("killed shard was not recovered")
    if partial_seen < 1:
        failures.append("no partial (degraded) answers while shard was down")
    if fleet_summary["state"] != ["healthy"] * SHARDS:
        failures.append(f"fleet did not heal: {fleet_summary['state']}")

    # ---- the contract: every rid has a terminal answer ----
    unanswered = [rid for rid in all_rids if fd.result(rid) is None]
    if unanswered:
        failures.append(f"{len(unanswered)} rids unanswered: {unanswered[:5]}")

    print("\nfleet:", json.dumps(fleet_summary))
    print("front door:", json.dumps(
        {k: fd.stats()[k] for k in
         ("admitted", "rejected", "shed_level", "shed_before_reject")}
    ))
    print(
        f"answers: {len(all_rids)} submitted, "
        f"{sum(1 for rid in all_rids if isinstance(fd.result(rid), Response))}"
        f" served, "
        f"{sum(1 for rid in all_rids if isinstance(fd.result(rid), Overloaded))}"
        f" refused, {len(unanswered)} unanswered; "
        f"{partial_seen} partial while a shard was down"
    )

    if failures:
        print("\nCHAOS_SMOKE_FAIL:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("\nchaos smoke: shed before reject, shard kill recovered, "
          "every rid answered")
    return 0


if __name__ == "__main__":
    sys.exit(main())
