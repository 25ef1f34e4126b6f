#!/usr/bin/env python3
"""How often the relaxed class of kNN (or CF) fails the serve phase's check,
over repeated servings of ``chip_smoke.py``'s serve phase, on one NVIDIA
GPU.

    python3 tools/torch_serve_relaxed.py [--kind knn|cf] [--servings N]
                                         [--keep] [--tree DIR]
                                         [--variants NAME,...]

Each serving is the serve phase's serving of the kind on a fresh store
and a fresh server (``chip_smoke._make_server`` with its observability: a
live tracer, a flight recorder, a 1 s rollup and the default SLO
objectives, so the load correction is the p90 of the last 20 windows):
``calibrate``, the correction's EMA set to 0, ``prewarm``,
``reset_metrics``, the SLO classes from the fitted model
(``slo_classes``), then ``SERVE_WAVES`` waves of each class, 64 requests
a wave (the 2.3 M-point set's queries, or the Netflix subset's active
users), drawn as the phase draws them.  A serving fails as the phase's
check fails: a relaxed batch escalated or, for kNN, granted less than
eps_max.  ``--keep`` holds every serving's responses to the end, as the
phase's one serving holds its own: each batch's answers then take new
host memory.

It prints a line a serving (ok or FAILED, the correction, the relaxed
batches' span over their predicted time, p50 and largest, the window over
the prediction of the batches the controller observed, by granted eps,
p50 and largest, the garbage collector's full collections and longest
pause, the fitted ``CostModel``, and each batch in order: its class, the
correction its grant read, its eps, its window over the prediction, and
its window in parts), then the count of failures, and the card's name
and power limit.  The first serving of each variant also prints a served
pass's time over a batch of the probe payload and over real requests at
each grantable eps, and the host copy of a batch's answers dropped at
once and held.  ``--tree`` is the checkout whose ``src/repro_torch`` and
``chip_smoke.py`` are imported (default: this one), so that an older tree
is served by its own harness; run two trees in turns in one call to
compare them on one card.

``--variants`` serves the repaired calibration with one of its parts
taken out, each variant in turn within every round (``VARIANTS``):
``as-is``; ``no-host-term`` (``c_fixed`` 0, the two probes' times
without the batch's host work); ``no-turns`` (each probe warmed and
timed in a row of its own, not in turns with the other); ``no-gc-guard``
(batches with a full garbage collection fed to the load correction);
``no-class-margin`` (the SLO classes' deadlines not raised off a power of
two); ``no-held-answers`` (``calibrate``'s passes drop their answers at
once).  Only ``as-is`` applies to a tree that lacks these parts.  A
failed serving's line also lists the grants below eps_max of a remaining
budget of at least the tight class's deadline (remaining ms, the
correction, eps).  Exits non-zero when there is no CUDA device.  Imports
nothing of JAX.
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


def _dropping_answers(calibrate):
    """``Server.calibrate`` whose passes drop their answers at once."""
    def calibrate_(self, kind, **kwargs):
        servable = self.servables[kind]
        unpack = servable.unpack

        def dropped(out, n):
            unpack(out, n)
        servable.unpack = dropped
        try:
            return calibrate(self, kind, **kwargs)
        finally:
            del servable.unpack
    return calibrate_


# variant -> [(module name[:class], attribute, new value from the old)]
VARIANTS = {
    "as-is": [],
    "no-host-term": [("repro_torch.serve.deadline", "CostModel",
                      _without_host_term)],
    "no-turns": [("repro_torch.serve.server", "_median_times",
                  lambda _: _sequential_median_times)],
    "no-gc-guard": [("repro_torch.serve.server", "_full_collections",
                     lambda _: lambda: 0)],
    "no-class-margin": [("chip_smoke", "SLO_CLASS_MARGIN", lambda _: 0.0)],
    "no-held-answers": [("repro_torch.serve.server:Server", "calibrate",
                         _dropping_answers)],
}


def patched(variant):
    """Apply a variant's patches (to modules already imported); returns the
    function that undoes them."""
    undo = []
    for module, attr, new in VARIANTS[variant]:
        module, _, cls = module.partition(":")
        mod = sys.modules[module]
        if cls:
            mod = getattr(mod, cls)
        old = getattr(mod, attr)
        setattr(mod, attr, new(old))
        undo.append((mod, attr, old))

    def restore():
        for mod, attr, old in reversed(undo):
            setattr(mod, attr, old)
    return restore


def serving(torch, cs, app, data, payloads, kind="knn",
            costs=False, keep=None) -> dict:
    """One fresh serving of ``kind``; returns what its relaxed batches got
    and, batch by batch, the class, the correction the grant read, the
    granted eps and the observed over predicted time fed back (None where
    the server kept the batch out of the correction)."""
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.store import AggregateStore

    server = cs._make_server(
        [cs._servable(torch, kind, app, data[:2], AggregateStore())],
        kind, ContinuousBatcher(max_batch=cs.SERVE_BATCH), **cs._observed())
    ctl = server.controller
    grant, observe, ratios = ctl.grant, ctl.observe, []

    grants, seq, wave_class = [], [], [None]

    def granting(kind, n_points, remaining_s, **kwargs):
        g = grant(kind, n_points, remaining_s, **kwargs)
        ratios.append([g.eps, None])
        grants.append((remaining_s, ctl.correction(kind), g.eps))
        if wave_class[0] is not None:       # not calibrate's own grants
            seq.append([wave_class[0], ctl.correction(kind), g.eps, None])
        return g

    def observing(kind, predicted_s, observed_s):
        ratios[-1][1] = seq[-1][3] = observed_s / predicted_s
        observe(kind, predicted_s, observed_s)

    ctl.grant, ctl.observe = granting, observing
    pauses, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            t0 = started.pop()
            pauses.append((info["generation"], time.perf_counter() - t0, t0))

    gc.callbacks.append(on_gc)
    try:
        server.calibrate(kind)
        server.controller.ema = 0.0
        server.prewarm(kind)
        server.reset_metrics()
        slos = cs.slo_classes(server, kind)
        pick = random.Random(cs.SERVE_SEED)
        class_of, responses = {}, []
        for _ in range(cs.SERVE_WAVES):
            for cls, deadline in slos.items():
                chosen = [payloads[i] for i in
                          pick.sample(range(len(payloads)), cs.SERVE_BATCH)]
                wave_class[0] = cls
                responses += cs._serve_wave(server, kind, chosen, deadline,
                                            cls, class_of)
    finally:
        gc.callbacks.remove(on_gc)
    if keep is not None:
        keep.append(responses)
    relaxed = cs._serve_stats(responses, class_of,
                              server.tracer.traces())["relaxed"]
    eps_max = server.controller.policy.eps_max
    # each batch's window in parts, ms: its stage 1 and stage 2 runs, its
    # grant and cache lookup, the rest of the window the controller timed
    # (padding, unpacking, bounds, accuracy proxy), and the garbage
    # collections of any generation that started inside its span
    roots = server.tracer.traces()
    for entry, root in zip(seq, roots):
        grant_sp = root.find("deadline.grant")[0]
        parts = [sum(sp.duration_s for sp in root.find(name)) * 1e3
                 for name in ("stage1", "stage2.refine")]
        parts.append((grant_sp.duration_s + root.find("cache.lookup")[0]
                      .duration_s) * 1e3)
        if entry[3] is not None:
            window = entry[3] * grant_sp.attrs["predicted_s"] * 1e3
            parts.append(window - sum(parts))
        else:
            parts.append(None)
        parts.append(sum(d for _, d, t in pauses
                         if root.t_start <= t <= root.t_end) * 1e3)
        entry.append(parts)
    # the phase's check of the relaxed class (chip_smoke._serve_lsh_kind)
    ok = not relaxed["escalated"] and (
        kind not in cs.SERVE_KEEPS_EPS_MAX or relaxed["eps"] == [eps_max])
    waits = [r.queue_wait_s / r.deadline_s for r in responses
             if class_of.get(r.rid) == "relaxed" and not r.reexecuted]
    by_eps = {}
    for eps, ratio in ratios:
        if ratio is not None:
            by_eps.setdefault(eps, []).append(ratio)
    return {"ok": ok,
            "ratios": {e: (statistics.median(xs), max(xs))
                       for e, xs in sorted(by_eps.items())},
            "eps": relaxed["eps"], "escalated": relaxed["escalated"],
            "correction": server.controller.correction(kind),
            "batches": relaxed["batches"], "wait": max(waits),
            "cut": [(rem * 1e3, corr, eps) for rem, corr, eps in grants
                    if eps < eps_max and rem >= slos["tight"]],
            "over": relaxed["batch_over_predicted"],
            "model": server.controller.models[kind],
            "seq": seq,
            "rows": row_costs(server, kind, payloads) if costs else None,
            "unpack": (unpack_costs(torch, server, kind, payloads)
                       if costs else None),
            "gc": (sum(g == 2 for g, _, _ in pauses),
                   max((d for _, d, _ in pauses), default=0.0))}


def row_costs(server, kind, payloads, seed=0) -> dict:
    """A served pass (padding, the run, unpacking, the bounds: what
    ``calibrate`` times) over a full batch of the probe payload and over a
    full batch of real requests, at budget 0 and at each grantable eps up
    to eps_max, each pass once and then the median of 5 in turns: ms."""
    import random

    from repro_torch.core.refine import eps_to_budget
    from repro_torch.device import block_until_ready
    from repro_torch.serve.server import _median_times

    servable = server.servables[kind]
    ctl = server.controller
    prepared, _ = server.cache.get_or_build(servable,
                                            ctl.policy.compression_ratio)
    n = server.batcher.pad_sizes[-1]
    rows = {"probe": [servable.probe_payload()] * n,
            "real": random.Random(seed).sample(payloads, n)}
    eps = [e for e in ctl.eps_grid
           if e == 0 or ctl.policy.degrade_floor <= e <= ctl.policy.eps_max]
    cases = [(name, e) for name in rows for e in eps]

    def served(name, e):
        def run():
            padded = servable.pad_batch(rows[name], n)
            out = block_until_ready(servable.run(
                prepared, padded,
                refine_budget=eps_to_budget(servable.n_points, e)))
            servable.unpack(out, n)
            if hasattr(servable, "error_bounds"):
                servable.error_bounds(out, n)
        return run

    times = _median_times(server.clock, [served(*c) for c in cases])
    return {f"{name} eps {e}": t * 1e3 for (name, e), t in zip(cases, times)}


def unpack_costs(torch, server, kind, payloads, reps=20, seed=1) -> dict:
    """The host's share of a served batch over real requests at eps_max:
    ``unpack`` with its answers dropped at once (as ``calibrate``'s passes
    drop them) and with them held (as a served batch's responses hold
    them), and the same copy through a page-locked host tensor: the
    median and the largest of ``reps`` calls, ms."""
    import random

    from repro_torch.core.refine import eps_to_budget
    from repro_torch.device import block_until_ready

    servable = server.servables[kind]
    ctl = server.controller
    prepared, _ = server.cache.get_or_build(servable,
                                            ctl.policy.compression_ratio)
    n = server.batcher.pad_sizes[-1]
    padded = servable.pad_batch(random.Random(seed).sample(payloads, n), n)
    out = block_until_ready(servable.run(
        prepared, padded,
        refine_budget=eps_to_budget(servable.n_points, ctl.policy.eps_max)))
    first = out[0][:n]

    def pinned():
        host = torch.empty(first.shape, dtype=first.dtype,
                           pin_memory=first.is_cuda)
        host.copy_(first, non_blocking=True)
        if first.is_cuda:
            torch.cuda.current_stream().synchronize()
        return list(host.numpy())

    cases = {"unpack": lambda: servable.unpack(out, n), "pinned": pinned}
    res = {}
    for name, fn in cases.items():
        for hold in (False, True):
            held, ts = [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                got = fn()
                ts.append(time.perf_counter() - t0)
                if hold:
                    held.append(got)
            res[f"{name} {'held' if hold else 'dropped'}"] = (
                statistics.median(ts) * 1e3, max(ts) * 1e3)
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--servings", type=int, default=30)
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--kind", choices=("knn", "cf"), default="knn")
    ap.add_argument("--keep", action="store_true",
                    help="hold every serving's responses to the end")
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
    from repro_torch.apps import cf, knn
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.serve import server  # noqa: F401  (variants patch it)

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels(_build)
    if args.kind == "knn":
        app, data = knn, cs.make_data(torch, synthetic.make_mfeat_like)
        payloads = [(q,) for q in data[2]]
    else:
        app = cf
        data = cs.make_cf_data(torch, synthetic.make_netflix_like,
                               synthetic.holdout_split)
        payloads = [(data[2][i], data[3][i]) for i in range(data[2].shape[0])]
    failed = dict.fromkeys(variants, 0)
    kept = []
    t_start = time.perf_counter()
    for i in range(args.servings):
        for variant in variants:
            restore = patched(variant)
            try:
                r = serving(torch, cs, app, data, payloads, args.kind,
                            costs=i == 0, keep=kept if args.keep else None)
                if r["rows"]:
                    print(f"{variant}: served pass ms " + ", ".join(
                        f"{k} {v:.3f}" for k, v in r["rows"].items()),
                        flush=True)
                    print(f"{variant}: host copy of the answers ms (median, "
                          "largest) " + ", ".join(
                              f"{k} {m:.3f} {x:.3f}"
                              for k, (m, x) in r["unpack"].items()),
                          flush=True)
            finally:
                restore()
            gc.collect()          # the servers' cycles hold card memory
            torch.cuda.empty_cache()
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
                                 for m, c, e in r["cut"]))
                  + ", batches (class, correction, eps, observed / "
                  "predicted; stage 1, stage 2, grant and lookup, rest, "
                  "collections ms) " + " ".join(
                      f"({c}, {k:.3f}, {e}, "
                      + ("-" if x is None else f"{x:.3f}") + "; "
                      + ", ".join("-" if v is None else f"{v:.2f}"
                                  for v in parts) + ")"
                      for c, k, e, x, parts in r["seq"]),
                  flush=True)
    print(f"{len(variants) * args.servings} servings in "
          f"{time.perf_counter() - t_start:.1f} s")
    for variant, n in failed.items():
        print(f"{tree} {args.kind} {variant}: {n} of {args.servings} "
              "servings failed")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
