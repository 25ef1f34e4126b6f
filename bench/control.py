#!/usr/bin/env python3
"""Readings that a cell's limits are set from, at the cell's own size.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \\
        [--precision tf32] [--out FILE]

For each seed: the cell's data, then the jobs a run checks (the same
sample of the window's jobs, with the same inputs), each run through the
program (the lower reading: sound runs) and through the reference in the
lower precision put in the program's place (the control, the upper
reading); both held against the float64 reference as a run holds them.
Prints one JSON line a seed: each side's worst-job share of rows off at
several row tolerances, its widest finite gap, and the seconds the
reference took.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOLS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)


def control_answer(want):
    """The control's answer in the shape ``compare`` takes: (out,
    captured)."""
    if hasattr(want, "votes"):
        return want.votes, (want.dist, want.labels)
    return want.pred, None


def readings(cell, seed: int, precision: str, device) -> dict:
    from bench import harness, judge

    drv, spec = cell.driver, cell.workload["check"]
    state = drv.setup(cell.config, cell.traffic, seed, device)
    for j in range(harness.WARM_JOBS):
        harness.run_job(cell, state, device, "warm", j, None)
    sides = {"program": [], "control": []}
    ref_s = []
    for j in sorted(harness.check_sample(seed, spec["jobs"], spec["span"])):
        probe = harness.Probe(drv.CAPTURE)
        inp, _, out = harness.run_job(cell, state, device, "job", j, probe)
        t0 = time.perf_counter()
        want = drv.reference(state, inp, "float64")
        harness.sync(device)
        ref_s.append(time.perf_counter() - t0)
        sides["program"].append(drv.compare(state, out, probe.captured, want))
        ctrl = drv.reference(state, inp, precision)
        sides["control"].append(drv.compare(state, *control_answer(ctrl),
                                            want))
    row = {"seed": seed, "reference_s": ref_s}
    for side, gaps in sides.items():
        s = judge.summarize(gaps, spec["row_tol"])
        s["rows_off_at"] = {f"{t:g}": judge.summarize(gaps, t)["rows_off"]
                            for t in TOLS}
        row[side] = s
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--precision", default="tf32")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import cells

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    from repro_torch.kernels import _build
    _build.build_all()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload,
                           **readings(cell, seed, args.precision, device)})
        print(line, flush=True)
        if args.out is not None:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
