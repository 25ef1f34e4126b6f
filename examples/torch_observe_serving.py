"""Observability demo on the PyTorch port: one served request -> a full
span tree + metrics, as ``examples/observe_serving.py`` does with the JAX
package.

Runs the kNN + CF demo server with a ``repro_torch.obs.Tracer`` attached, a
kernel probe installed, and the closed-loop decision layer on (windowed
rollup, burn-rate SLO monitor, flight recorder), serves a couple of
healthy batches plus an overload phase with impossible deadlines, then
exports and *validates* everything the obs subsystem produces:

  * the latest span tree, rendered (batcher wait -> deadline grant -> cache
    lookup -> per-shard map -> stage-2 refinement, with shuffle bytes);
  * the JSON-lines trace export (schema-checked by validate_trace_jsonl);
  * the serving metrics registry snapshot + Prometheus text (schema-checked
    by validate_snapshot), including the stage-1 vs refined accuracy proxy;
  * the process-wide registry with per-kernel measured p50s AND a fired
    deadline burn-rate alert from the overload phase;
  * the flight-recorder jsonl (schema-checked by validate_flight_jsonl)
    retaining a full span tree for every SLO-missed request.

Exits non-zero if any required span is missing, any export drifts from its
pinned schema, the overload phase fails to fire an alert, or an SLO-missed
request is absent from the flight dump — CI runs this as the obs smoke
step.  The servables run on the card unless ``--device cpu`` asks for the
plain versions.

    PYTHONPATH=src python examples/torch_observe_serving.py [--out DIR]
        [--device cpu]
    REPRO_BENCH_TINY=1 ...   # CI smoke sizes
"""
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

from repro_torch.device import resolve
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import (
    FlightRecorder, Tracer, default_objectives, default_registry,
    install_kernel_probe, uninstall_kernel_probe, validate_flight_jsonl,
    validate_snapshot, validate_trace_jsonl,
)
from repro_torch.serve.demo import build_demo_server

TINY = bool(os.environ.get("REPRO_BENCH_TINY"))

# Every one of these must appear in the served batch's span tree.
REQUIRED_SPANS = (
    "serve.batch", "batcher.wait", "deadline.grant", "cache.lookup",
    "store.get", "mapreduce", "map.shard", "reduce", "stage1",
    "stage2.refine",
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for trace/metrics exports")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    out_dir = args.out or Path(tempfile.mkdtemp(prefix="repro_obs_"))
    out_dir.mkdir(parents=True, exist_ok=True)

    sizes = (
        {"knn_points": 2_048, "cf_users": 512} if TINY
        else {"knn_points": 8_192, "cf_users": 1_024}
    )
    flight = FlightRecorder(capacity=32, tail_fraction=0.1)
    server, queries, active, active_mask = build_demo_server(
        batch=2, **sizes, device=dev,
        window_s=0.5, slo_objectives=default_objectives(), flight=flight,
    )
    # No calibration on purpose: an uncalibrated controller grants full
    # eps_max, so stage 2 always runs and the refinement span (plus the
    # accuracy proxy) is guaranteed to appear — and the demo stays fast.
    server.tracer = tracer = Tracer(clock=server.clock)
    probe = install_kernel_probe()  # measured p50 per kernel op
    try:
        for i in range(2):  # batch 0 builds aggregates, batch 1 cache-hits
            server.submit("knn", (queries[i],), deadline_s=30.0)
            server.submit("knn", (queries[i + 2],), deadline_s=30.0)
            server.drain()
        server.submit("cf", (active[0], active_mask[0]), deadline_s=30.0)
        server.submit("cf", (active[1], active_mask[1]), deadline_s=30.0)
        responses = server.drain()
        # ---- overload phase: deadlines no execution can meet ----
        # Every request misses its SLO, the deadline burn-rate alert fires,
        # and the flight recorder must keep each missed batch's span tree.
        overload_rids = []
        for i in range(4):
            overload_rids.append(
                server.submit("knn", (queries[4 + i],), deadline_s=1e-6)
            )
        responses += server.drain()
        # A direct host-level dispatch on the run's device shows the
        # measured-time channel working, as the reference's does.
        points = queries[:32].to(dev)
        for _ in range(3):
            kernel_ops.knn_distance(points[:8], points)
    finally:
        uninstall_kernel_probe()

    # ---- the span tree for the last served batch ----
    tree = tracer.render()
    print(tree)

    failures: list[str] = []
    names = {sp.name for root in tracer.traces() for sp in root.walk()}
    for required in REQUIRED_SPANS:
        if required not in names:
            failures.append(f"missing span: {required}")
    knn_trace = tracer.traces()[0]
    shuffled = [
        sp for sp in knn_trace.walk() if "shuffle_bytes" in sp.attrs
    ]
    if not any(sp.attrs["shuffle_bytes"] > 0 for sp in shuffled):
        failures.append("no span recorded positive shuffle_bytes")

    # ---- schema checks on every export ----
    trace_jsonl = tracer.to_jsonl()
    failures += validate_trace_jsonl(trace_jsonl)
    serve_snap = server.metrics.snapshot()
    failures += validate_snapshot(serve_snap)
    global_snap = default_registry().snapshot()
    failures += validate_snapshot(global_snap)

    # ---- content checks: accuracy proxy + measured kernel p50s ----
    if not any(r.accuracy_proxy is not None for r in responses):
        failures.append("no response carried an accuracy proxy")
    measured = probe.summary()
    if not measured:
        failures.append("kernel probe recorded no host-level op calls")

    # ---- overload outcome 1: the burn-rate alert is in the registry ----
    fired = [
        e for e in global_snap["counters"]
        if e["name"] == "slo_alerts_total"
        and e["labels"].get("transition") == "fired" and e["value"] >= 1
    ]
    if not fired:
        failures.append("overload did not fire a burn-rate alert")
    missed_rids = {
        r.rid for r in responses if not r.deadline_met and not r.reexecuted
    }
    if not missed_rids >= set(overload_rids):
        failures.append("overload requests unexpectedly met their deadlines")

    # ---- overload outcome 2: flight recorder kept every missed batch ----
    flight_jsonl = flight.to_jsonl()
    failures += validate_flight_jsonl(flight_jsonl)
    flight_entries = [
        json.loads(line) for line in flight_jsonl.splitlines()
    ]
    covered = {
        rid for e in flight_entries for rid in e["missed_rids"]
    }
    if not covered >= missed_rids:
        failures.append(
            f"flight dump is missing SLO-missed rids: "
            f"{sorted(missed_rids - covered)}"
        )
    for e in flight_entries:
        if e["reason"] not in ("slo_missed", "escalated", "tail"):
            failures.append(f"unexpected flight reason {e['reason']!r}")
        if e["reason"] == "slo_missed" and not any(
            sp["name"] == "serve.batch" for sp in e["spans"]
        ):
            failures.append("slo_missed flight entry lacks its span tree")
    healthy_kept = [
        e for e in flight_entries if not e["missed_rids"]
    ]
    if len(healthy_kept) > flight.considered - len(overload_rids) // 2:
        failures.append("flight recorder retained too many healthy batches")

    (out_dir / "flight.jsonl").write_text(flight_jsonl)
    (out_dir / "trace.jsonl").write_text(trace_jsonl)
    (out_dir / "trace.txt").write_text(tree + "\n")
    (out_dir / "metrics.json").write_text(
        json.dumps({"serve": serve_snap, "process": global_snap}, indent=2)
        + "\n"
    )
    (out_dir / "metrics.prom").write_text(server.metrics.to_prometheus())

    print(f"\nexports -> {out_dir}")
    print("\nmeasured kernel p50s (host-level dispatches):")
    for op, row in sorted(measured.items()):
        print(f"  {op:.<44} {row['p50_s'] * 1e6:>9.1f}us  "
              f"x{row['count']}")
    summary = server.summary()
    print("\nserving summary (excerpt):")
    print(json.dumps(
        {k: summary[k] for k in
         ("n_requests", "stage1_latency_ms", "accuracy_proxy", "cache",
          "windowed")
         if k in summary},
        indent=2,
    ))
    print("\nflight recorder:", json.dumps(flight.summary()))
    if server.slo is not None:
        print("slo alerts:", [
            (a.objective, a.transition) for a in server.slo.history
        ])

    if failures:
        print("\nOBS_SMOKE_FAIL:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("\nobs smoke: span tree complete, all export schemas valid, "
          "overload fired an alert and was flight-recorded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
