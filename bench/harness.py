"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the check against the reference, and the result line.

The window is a closed loop with one client: a job starts when the last
one has returned (its result synchronised), for ``seconds`` seconds; the
job that is running when they end finishes and counts.  Each job's inputs
(its batch and its LSH draws) are made before its clock starts.  A sample
of the window's jobs, drawn from the seed, is kept and, once the window
has closed and the memory peak has been read, held against the reference.
With ``trace`` a slice of further jobs runs under ``torch.profiler``
(its trace kept as ``build/bench/<cell>.trace.json``);
those jobs are checked too, and their work feeds the per-layer metrics.
"""
from __future__ import annotations

import gc
import random
import sys
import time
import traceback
from pathlib import Path

import torch

from bench import cells, data, judge, record, stats, trace as trace_lib

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # the JAX package is repro
WARM_JOBS = 2


class Probe:
    """The program's ``ops`` probe: forwards every op call, keeps the last
    output of the driver module's ``CAPTURE`` op, and in the traced slice
    wraps each call in a profiler annotation ``op:<name>``."""

    def __init__(self, capture: str | None, annotate: bool = False):
        self.capture = capture
        self.annotate = annotate
        self.captured = None

    def timed(self, op, fn, args, kwargs):
        if self.annotate:
            with torch.profiler.record_function(trace_lib.OP_PREFIX + op):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        if op == self.capture:
            self.captured = out
        return out


def set_probe(probe) -> None:
    from repro_torch.kernels import ops

    ops.set_probe(probe)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_job(cell, state, device, stream, j, probe):
    """(inputs, seconds, output or None) of one job; its inputs are made
    before its clock starts."""
    drv = cell.driver
    inp = drv.inputs(state, stream, j)
    sync(device)
    set_probe(probe)
    t0 = time.perf_counter()
    try:
        out = drv.run(state, inp)
        sync(device)
    except Exception:                      # a failed job counts as failed
        traceback.print_exc()
        out = None
    seconds = time.perf_counter() - t0
    set_probe(None)
    return inp, seconds, out


def check_sample(seed: int, jobs: int, span: int) -> set[int]:
    """The window's jobs to check: the first, and jobs - 1 more drawn from
    the seed among the first ``span``."""
    rng = random.Random(data.sub_seed(seed, "check"))
    return {0} | set(rng.sample(range(1, span), jobs - 1))


def _traced_slice(cell, state, device, n_jobs, path: Path):
    """Run ``n_jobs`` under the profiler, its trace written to ``path``;
    returns (kept jobs, Trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    capture = cell.driver.CAPTURE
    kept = []
    with torch.profiler.profile(activities=acts) as prof:
        run_job(cell, state, device, "trace-warm", 0, Probe(capture, True))
        with torch.profiler.record_function(trace_lib.SLICE):
            for j in range(n_jobs):
                probe = Probe(capture, True)
                inp, _, out = run_job(cell, state, device, "trace", j, probe)
                kept.append((inp, out, probe.captured))
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return kept, trace_lib.reduce_file(path, cells.op_kernels())


def _window(cell, state, device, seed: int, seconds: float):
    """The measured window: (kept jobs {index: (inputs, output, captured)}
    of the seed's sample, every completed job's seconds, failed jobs,
    attempted jobs, the window's seconds)."""
    spec = cell.workload["check"]
    sample = check_sample(seed, spec["jobs"], spec["span"])
    kept, job_s, failed = {}, [], 0
    t0 = time.perf_counter()
    deadline, end, j = t0 + seconds, t0, 0
    while j == 0 or time.perf_counter() < deadline:
        probe = Probe(cell.driver.CAPTURE) if j in sample else None
        inp, sec, out = run_job(cell, state, device, "job", j, probe)
        end = time.perf_counter()
        if out is None:
            failed += 1
        else:
            job_s.append(sec)
        if probe is not None:
            kept[j] = (inp, out, probe.captured)
        j += 1
    return kept, job_s, failed, j, end - t0


def _check(cell, state, checked: list, log):
    """Each checked job against the float64 reference: (the numbers
    compared, each job's operations, each job's launches)."""
    drv = cell.driver
    gaps, flops, launches = [], [], []
    for n, (inp, out, captured) in enumerate(checked):
        want = drv.reference(state, inp, "float64")
        gaps.append(drv.compare(state, out, captured, want))
        flops.append(drv.job_flops(state, want))
        launches.append(drv.launches(state, want))
        if n == 0 and out is not None:
            print(f"{cell.name}: job 0: {drv.quality(state, inp, out)}",
                  file=log)
    numbers = judge.summarize(gaps, cell.workload["check"]["row_tol"])
    print(f"{cell.name}: {len(checked)} jobs checked: " + ", ".join(
        f"{k} {v}" for k, v in numbers.items()), file=log)
    return numbers, flops, launches


def run_cell(cell: cells.Cell, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, log=sys.stderr) -> dict:
    """One run; returns the result line's object."""
    torch.set_float32_matmul_precision("highest")   # fp32, TF32 off
    if device.type == "cuda":
        from repro_torch.kernels import _build   # first run: nvcc builds
        _build.build_all()
    state = cell.driver.setup(cell.config, cell.traffic, seed, device)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for j in range(WARM_JOBS):
        run_job(cell, state, device, "warm", j, None)
    gc.collect()
    setup_s = time.perf_counter() - t_start

    kept, job_s, failed, attempted, window_s = _window(
        cell, state, device, seed, seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced, tr = [], None
    if trace:
        traced, tr = _traced_slice(
            cell, state, device, cell.workload["trace_jobs"],
            cells.ROOT / "build" / "bench" / f"{cell.name}.trace.json")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, flops, launches = _check(
        cell, state, [kept[i] for i in sorted(kept)] + traced, log)
    ok, checks = judge.verdict(numbers, cell.workload["check"]["limits"])

    result = {"correct": ok and failed == 0, "attempted": attempted,
              "failed": failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if not trace:
        e2e = stats.window_metrics(job_s, window_s) if job_s else {}
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in e2e.items() if k in units}
    else:
        rec = record.Record(
            tr, len(traced), [x for job in launches[len(kept):] for x in job],
            sum(flops) / len(flops), sum(job_s) / max(len(job_s), 1))
        result["metrics"] = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(rec)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["device"] = dev
    result["checks"] = checks
    return result
