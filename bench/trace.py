"""Reduction of a ``torch.profiler`` trace (its Chrome JSON export) to what
the per-layer metrics read.

The traced slice is the host annotation ``bench.slice``.  Each kernel is
attributed to the program's op whose annotation (``op:<name>``, put
around every ``ops`` call by the harness's probe) encloses the host call
that launched it, matched through the launch's correlation id; a kernel
launched outside every op annotation is the op's whose kernel names alone
list it, or no op's (torch glue).  Busy time is the union of the device's
intervals (kernels, copies, sets), so work that overlaps on two streams
counts once.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from pathlib import Path

SLICE = "bench.slice"
OP_PREFIX = "op:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float          # µs, the trace's clock, clipped to the slice
    end: float
    op: str | None        # the program's op it belongs to, if any


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: list          # DeviceOp within the slice
    gaps: list            # (seconds, what the host launched after it)

    def kernels(self) -> list:
        return [d for d in self.device if d.cat == "kernel"]

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = defaultdict(float)
        for d in self.kernels():
            by_name[d.name[:120]] += (d.end - d.start) * 1e-6
        by_host: dict = defaultdict(float)
        for seconds, label in self.gaps:
            by_host[label] += seconds
        order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [list(kv) for kv in order],
                "idle_gaps": [list(kv) for kv in gaps]}


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::foo_kernel<8>(float const*, ...)`` ->
    ``foo_kernel``."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").strip()
    for stop in "(<":
        name = name.split(stop, 1)[0]
    return name.strip().split("::")[-1]


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by the intervals, overlaps counted once."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def innermost(intervals: list[tuple[float, float, str]],
              points: list[float]) -> list[str | None]:
    """For each point the label of the innermost interval holding it; the
    intervals nest (one host thread)."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out: list = [None] * len(points)
    stack: list = []
    i = 0
    for t, qi in sorted((t, qi) for qi, t in enumerate(points)):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] < ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[qi] = stack[-1][2] if stack else None
    return out


def reduce_events(events: list[dict], op_kernels: dict[str, tuple]) -> Trace:
    """``events``: the ``traceEvents`` of a Chrome trace; ``op_kernels``:
    each op's kernel names (``__global__`` names of its sources)."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise ValueError(f"{len(marks)} '{SLICE}' annotations in the trace")
    s0, s1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    thread = (marks[0].get("pid"), marks[0].get("tid"))
    host = [e for e in spans if e.get("cat") in HOST_CATS
            and (e.get("pid"), e.get("tid")) == thread
            and e.get("name") != SLICE]
    op_ivs = [(e["ts"], e["ts"] + e["dur"], e["name"][len(OP_PREFIX):])
              for e in host if e["name"].startswith(OP_PREFIX)]
    host_ivs = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host]
    launched = {e["args"]["correlation"]: e["ts"] for e in spans
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    owners: dict = defaultdict(list)
    for op, names in op_kernels.items():
        for n in names:
            owners[n].append(op)

    dev = sorted((e for e in spans if e.get("cat") in DEVICE_CATS
                  and e["ts"] + e["dur"] > s0 and e["ts"] < s1),
                 key=lambda e: e["ts"])
    when = [launched.get(e.get("args", {}).get("correlation"), -1.0)
            for e in dev]
    op_of = innermost(op_ivs, when)
    label_of = innermost(host_ivs, when)
    device = []
    for e, op in zip(dev, op_of):
        if op is None and e["cat"] == "kernel":
            mine = owners.get(base_name(e["name"]), [])
            op = mine[0] if len(mine) == 1 else None
        device.append(DeviceOp(e["name"], e["cat"], max(e["ts"], s0),
                               min(e["ts"] + e["dur"], s1), op))
    busy = union_length([(d.start, d.end) for d in device])
    gaps, end = [], s0
    for d, label in zip(device, label_of):
        if d.start > end:
            gaps.append(((d.start - end) * 1e-6,
                         label or f"launch of {base_name(d.name)}"))
        end = max(end, d.end)
    if s1 > end:
        gaps.append(((s1 - end) * 1e-6, "after the last launch"))
    return Trace((s1 - s0) * 1e-6, busy * 1e-6, device, gaps)


def reduce_file(path: Path, op_kernels: dict[str, tuple]) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return reduce_events(events, op_kernels)
