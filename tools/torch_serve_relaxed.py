#!/usr/bin/env python3
"""How often the relaxed kNN class loses eps_max, over repeated servings of
``chip_smoke.py``'s serve phase, on one NVIDIA GPU.

    python3 tools/torch_serve_relaxed.py [--servings N] [--tree DIR]
                                         [--variants NAME,...]

Each serving is the serve phase's kNN serving on a fresh store and a fresh
server (``chip_smoke._make_server`` with its observability: a live tracer,
a flight recorder, a 1 s rollup and the default SLO objectives, so the
load correction is the p90 of the last 20 windows): ``calibrate``, the
correction's EMA set to 0, ``prewarm``, ``reset_metrics``, the SLO
classes from the fitted model (``slo_classes``), then ``SERVE_WAVES``
waves of each class, 64 of the 2.3 M-point set's queries a wave, drawn
as the phase draws them.  A serving fails as the phase's check fails: a
relaxed batch granted less than eps_max, or escalated.

It prints a line a serving (ok or FAILED, the correction, the relaxed
batches' span over their predicted time, p50 and largest, the window over
the prediction of the batches the controller observed, by granted eps,
p50 and largest, the garbage collector's full collections and longest
pause, the fitted ``CostModel``), then the count of failures, and the
card's name and power limit.  ``--tree`` is the checkout whose
``src/repro_torch`` and ``chip_smoke.py`` are imported (default: this
one), so that an older tree is served by its own harness; run two trees
in turns in one call to compare them on one card.

``--variants`` serves the repaired calibration with one of its parts
taken out, each variant in turn within every round (``VARIANTS``):
``as-is``; ``no-host-term`` (``c_fixed`` 0, the two probes' times
without the batch's host work); ``no-turns`` (each probe warmed and
timed in a row of its own, not in turns with the other); ``no-gc-guard``
(batches with a full garbage collection fed to the load correction);
``no-class-margin`` (the SLO classes' deadlines not raised off a power of
two).  Only ``as-is`` applies to a tree that lacks these parts.  A failed serving's line also lists the
grants below eps_max of a remaining budget of at least the tight class's
deadline (remaining ms, the correction, eps).  Exits non-zero when there is no CUDA device.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _sequential_median_times(clock, fns):
    """``server._median_times`` without its turns: each function warmed
    and timed CALIBRATE_RUNS times in a row of its own."""
    from repro_torch.serve import server

    out = []
    for fn in fns:
        fn()
        ts = []
        for _ in range(server.CALIBRATE_RUNS):
            t0 = clock()
            fn()
            ts.append(clock() - t0)
        out.append(statistics.median(ts))
    return out


def _without_host_term(cost_model):
    class NoHostTerm(cost_model):
        @classmethod
        def fit(cls, n_points, r, t_eps0, t_eps1, eps1, *, t_fixed=0.0):
            return cost_model.fit(n_points, r, t_eps0 - t_fixed,
                                  t_eps1 - t_fixed, eps1)
    return NoHostTerm


# variant -> [(module name, attribute, new value from the old)]
VARIANTS = {
    "as-is": [],
    "no-host-term": [("repro_torch.serve.deadline", "CostModel",
                      _without_host_term)],
    "no-turns": [("repro_torch.serve.server", "_median_times",
                  lambda _: _sequential_median_times)],
    "no-gc-guard": [("repro_torch.serve.server", "_full_collections",
                     lambda _: lambda: 0)],
    "no-class-margin": [("chip_smoke", "SLO_CLASS_MARGIN", lambda _: 0.0)],
}


def patched(variant):
    """Apply a variant's patches (to modules already imported); returns the
    function that undoes them."""
    undo = []
    for module, attr, new in VARIANTS[variant]:
        mod = sys.modules[module]
        old = getattr(mod, attr)
        setattr(mod, attr, new(old))
        undo.append((mod, attr, old))

    def restore():
        for mod, attr, old in reversed(undo):
            setattr(mod, attr, old)
    return restore


def serving(torch, cs, knn, knn_data, payloads) -> dict:
    """One fresh kNN serving; returns what its relaxed batches got."""
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.store import AggregateStore

    train_x, train_y = knn_data[:2]
    server = cs._make_server(
        [cs._servable(torch, "knn", knn, (train_x, train_y),
                      AggregateStore())],
        "knn", ContinuousBatcher(max_batch=cs.SERVE_BATCH), **cs._observed())
    ctl = server.controller
    grant, observe, ratios = ctl.grant, ctl.observe, []

    grants = []

    def granting(kind, n_points, remaining_s, **kwargs):
        g = grant(kind, n_points, remaining_s, **kwargs)
        ratios.append([g.eps, None])
        grants.append((remaining_s, ctl.correction(kind), g.eps))
        return g

    def observing(kind, predicted_s, observed_s):
        ratios[-1][1] = observed_s / predicted_s
        observe(kind, predicted_s, observed_s)

    ctl.grant, ctl.observe = granting, observing
    pauses, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((info["generation"],
                           time.perf_counter() - started.pop()))

    gc.callbacks.append(on_gc)
    try:
        server.calibrate("knn")
        server.controller.ema = 0.0
        server.prewarm("knn")
        server.reset_metrics()
        slos = cs.slo_classes(server, "knn")
        pick = random.Random(cs.SERVE_SEED)
        class_of, responses = {}, []
        for _ in range(cs.SERVE_WAVES):
            for cls, deadline in slos.items():
                chosen = [payloads[i] for i in
                          pick.sample(range(len(payloads)), cs.SERVE_BATCH)]
                responses += cs._serve_wave(server, "knn", chosen, deadline,
                                            cls, class_of)
    finally:
        gc.callbacks.remove(on_gc)
    relaxed = cs._serve_stats(responses, class_of,
                              server.tracer.traces())["relaxed"]
    eps_max = server.controller.policy.eps_max
    waits = [r.queue_wait_s / r.deadline_s for r in responses
             if class_of.get(r.rid) == "relaxed" and not r.reexecuted]
    by_eps = {}
    for eps, ratio in ratios:
        if ratio is not None:
            by_eps.setdefault(eps, []).append(ratio)
    return {"ok": not relaxed["escalated"] and relaxed["eps"] == [eps_max],
            "ratios": {e: (statistics.median(xs), max(xs))
                       for e, xs in sorted(by_eps.items())},
            "eps": relaxed["eps"], "escalated": relaxed["escalated"],
            "correction": server.controller.correction("knn"),
            "batches": relaxed["batches"], "wait": max(waits),
            "cut": [(rem * 1e3, corr, eps) for rem, corr, eps in grants
                    if eps < eps_max and rem >= slos["tight"]],
            "over": relaxed["batch_over_predicted"],
            "model": server.controller.models["knn"],
            "gc": (sum(g == 2 for g, _ in pauses),
                   max((d for _, d in pauses), default=0.0))}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--servings", type=int, default=30)
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--variants", default="as-is",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    args = ap.parse_args()
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("torch_serve_relaxed: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.apps import knn
    from repro_torch.data.synthetic import make_mfeat_like
    from repro_torch.kernels import _build
    from repro_torch.serve import server  # noqa: F401  (variants patch it)

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels(_build)
    knn_data = cs.make_data(torch, make_mfeat_like)
    payloads = [(q,) for q in knn_data[2]]
    failed = dict.fromkeys(variants, 0)
    t_start = time.perf_counter()
    for i in range(args.servings):
        for variant in variants:
            restore = patched(variant)
            try:
                r = serving(torch, cs, knn, knn_data, payloads)
            finally:
                restore()
            failed[variant] += not r["ok"]
            over = r["over"] or {}
            print(f"serving {i} {variant}: {'ok' if r['ok'] else 'FAILED'}, "
                  f"relaxed eps {r['eps']}, {r['escalated']} escalated, "
                  f"correction {r['correction']:.4f}, batch / predicted p50 "
                  f"{over.get('p50', float('nan')):.4f} max "
                  f"{over.get('max', float('nan')):.4f}, observed / "
                  "predicted by eps (p50, max) "
                  + ", ".join(f"{e}: {m:.3f} {x:.3f}"
                              for e, (m, x) in r["ratios"].items())
                  + f", {r['gc'][0]} full collections, longest collection "
                  f"{r['gc'][1] * 1e3:.1f} ms, {r['batches']} relaxed "
                  f"batches, longest relaxed wait {r['wait']:.3f} of the "
                  f"deadline, {r['model']}"
                  + ("" if r["ok"] else ", grants cut "
                     + ", ".join(f"({m:.3f} ms, {c:.4f}, {e})"
                                 for m, c, e in r["cut"])),
                  flush=True)
    print(f"{len(variants) * args.servings} servings in "
          f"{time.perf_counter() - t_start:.1f} s")
    for variant, n in failed.items():
        print(f"{tree} {variant}: {n} of {args.servings} servings failed")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
