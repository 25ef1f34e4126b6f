"""The traced slice split by the program's stage spans.

While ``torch.profiler`` records, the port mirrors each span of its jobs
(``repro_torch.obs.trace``) as a ``span:<name>`` range: the root ``job``
and its stages ``map.lsh``, ``map.aggregate``, ``map.stage1``,
``map.select``, ``map.refine`` and ``reduce``.  This module finds the
run's trace file and reduces it with ``bench.trace.reduce_events`` itself
(the same slice, clipping, correlation join, innermost range and gap
rule), with the stage ranges in the place of the ``op:`` annotations:

  * each device op (kernel, copy or set) is charged to the innermost
    ``span:`` range that holds its launch;
  * each idle gap to the range that holds the launch ending it;
  * what lies outside every ``span:job`` (the harness's own work between
    jobs: its inputs, its LSH draws, its synchronise), and the slice's tail
    after the last device op, to ``between_jobs``.

A trace without ``span:job`` ranges (a program without stage spans)
reads None.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from collections import defaultdict

from bench import cells
from bench import trace as trace_lib

SPAN = "span:"
JOB = "job"
BETWEEN = "between_jobs"
TRACES = cells.ROOT / "build" / "bench"   # where the harness keeps them


@dataclasses.dataclass
class Split:
    window_s: float       # the slice's length
    jobs: int             # span:job ranges that start in the slice
    device_s: dict        # stage -> device seconds of the ops it launched
    idle_s: dict          # stage -> idle seconds ended by its launches
    seen: frozenset       # stages with a range in the slice


def _stage_of(label: str | None) -> str:
    """A range's label, as the reduction gives it back -> its stage."""
    for prefix in (trace_lib.OP_PREFIX + SPAN, SPAN):
        if label and label.startswith(prefix):
            return label[len(prefix):]
    return BETWEEN


def split_events(events: list[dict]) -> Split:
    """The stage split of a Chrome trace's ``traceEvents``: every host
    range but the slice and the ``span:`` ranges is left out, and those
    are renamed ``op:span:<name>``, so that ``reduce_events`` charges each
    device op and each gap to its innermost stage."""
    kept, ranges = [], []
    for e in events:
        if e.get("cat") not in trace_lib.HOST_CATS:
            kept.append(e)
        elif e.get("name") == trace_lib.SLICE:
            kept.append(e)
        elif e.get("name", "").startswith(SPAN) and e.get("ph") == "X":
            kept.append({**e, "name": trace_lib.OP_PREFIX + e["name"]})
            ranges.append(e)
    tr = trace_lib.reduce_events(kept, {})
    device_s: dict = defaultdict(float)
    for d in tr.device:
        device_s[_stage_of(d.op)] += (d.end - d.start) * 1e-6
    idle_s: dict = defaultdict(float)
    for seconds, label in tr.gaps:
        idle_s[_stage_of(label)] += seconds
    (mark,) = [e for e in kept if e.get("name") == trace_lib.SLICE
               and e.get("cat") == "user_annotation"]
    s0, s1 = mark["ts"], mark["ts"] + mark["dur"]
    inside = [e for e in ranges if s0 <= e["ts"] < s1]
    return Split(tr.window_s,
                 sum(_stage_of(e["name"]) == JOB for e in inside),
                 dict(device_s), dict(idle_s),
                 frozenset(_stage_of(e["name"]) for e in inside))


@functools.lru_cache(maxsize=8)
def _split_file(path: str, mtime_ns: int) -> Split | None:
    try:
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return split_events(events)
    except (OSError, ValueError, KeyError):
        return None


def of(record) -> Split | None:
    """The split of this run's trace: the newest ``*.trace.json`` whose
    slice lasts ``record.trace.window_s`` to the microsecond; None where
    there is none, or where it holds no job span or no device op."""
    if not record.trace.device:
        return None
    found = []
    for path in TRACES.glob("*.trace.json"):
        try:
            found.append((path.stat().st_mtime_ns, path))
        except OSError:
            continue
    for mtime, path in sorted(found, reverse=True):
        split = _split_file(str(path), mtime)
        if (split is not None
                and abs(split.window_s - record.trace.window_s) < 0.5e-6):
            return split if split.jobs else None
    return None


def device_ms(record, stage: str) -> float | None:
    """Device ms a job of the ops launched in ``stage``."""
    split = of(record)
    if split is None or record.jobs <= 0 or stage not in split.seen:
        return None
    return split.device_s.get(stage, 0.0) * 1e3 / record.jobs


def idle_ms(record, stage: str) -> float | None:
    """Idle ms a job ended by a launch in ``stage`` (``between_jobs``: by
    a launch outside every job, and the slice's tail)."""
    split = of(record)
    if split is None or record.jobs <= 0 or (
            stage != BETWEEN and stage not in split.seen):
        return None
    return split.idle_s.get(stage, 0.0) * 1e3 / record.jobs
