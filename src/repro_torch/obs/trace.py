"""Lightweight span-tree tracing for the port: the anytime serving path
and the stages of a batch job.

A ``Span`` is one named unit of host-side work; spans nest into a tree
rooted at the outermost open span (one root per served batch in
``repro_torch.serve``, one per ``run_accurateml`` job in ``repro_torch.apps``).
Two kinds of span share this one API:

  * **synchronised spans** (the serving path, the ``MapReduce`` engine) —
    a tracer owns one host clock (``perf_counter`` by default, injectable
    for tests); these spans are only ever opened and closed around points
    where the card has finished (the engine synchronises at its stage
    boundaries under a live tracer), never around a bare launch, since a
    clock read after a launch records launch time, not run time.  Work
    whose start predates the current span (a request waiting in the queue)
    is recorded with ``add_span(name, t0, t1)`` using clock values captured
    where they were meaningful;
  * **launch-side spans** (the stages of a job) — opened and closed around
    launches without any synchronise, so that a job whose host paces the
    card runs as it does untraced.  Their host clock times the launches;
    the device time of each stage comes from ``torch.profiler``: while it
    records, every span, of either kind, is mirrored as a
    ``record_function("span:<name>")`` range, so it sits on the device
    trace's own timeline and the profiler's correlation ids join each
    kernel to the stage whose span holds its launch.

The stages of a job (``apps/knn.py`` and ``apps/cf.py``, ``run_accurateml``):
``job`` (the root; attrs ``app``, ``shards``, ``queries``, ``eps_max``),
then per map task ``map.lsh`` (bucket ids; CF's centring),
``map.aggregate`` (the segment sums and the prepared aggregates; attr
``n_buckets``), ``map.stage1`` (the centroid distances or weights and the
surrogate), and with a refinement budget ``map.select`` (ranking and the
refined rows; attr ``refine_budget``) and ``map.refine`` (the refined
terms and their merge), and ``reduce`` (kNN: once, the merge and vote; CF:
each map task's partial-sum add and the prediction).  Inside ``job``
every torch op lies inside exactly one stage.

Propagation uses a ``contextvars.ContextVar``: the server installs its
tracer with ``use_tracer`` around batch execution and deeper layers (the
``MapReduce`` engine, the aggregate store, the apps) pick it up via
``current_tracer()`` — no tracer parameter threads through the stack, and
the default is ``NULL_TRACER``, which records nothing: with no profiler
recording its ``span`` returns the shared ``_NULL_SPAN`` (no allocation,
no ``record_function``, which costs microseconds even with no profiler
running), so the un-observed hot path stays lean.

Export: ``to_jsonl`` (one flat JSON object per span, schema pinned by
``validate_trace_jsonl``) and ``render`` (human-readable tree dump).
Finished traces are kept in a bounded deque (``max_traces``) so a
long-running server's tracer cannot grow without bound.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import time
from collections import deque
from typing import Any, Callable, Iterator

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# Flat-span schema (one JSON object per line of to_jsonl). Bump SCHEMA_VERSION
# when a key is added/removed; validate_trace_jsonl pins it in CI.
SCHEMA_VERSION = 1
SPAN_KEYS = ("schema", "trace", "span", "parent", "name", "t0", "t1",
             "dur_s", "attrs")


class Span:
    """One named, timed node of a trace tree."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id",
                 "t_start", "t_end", "attrs", "children")

    def __init__(
        self, name: str, span_id: int, parent_id: int | None,
        trace_id: int, t_start: float,
    ):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.t_start = t_start
        self.t_end = t_start
        self.attrs: dict[str, Any] = {}
        self.children: list[Span] = []

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (grant eps, shuffle bytes, cache source, ...)."""
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    def walk(self) -> Iterator["Span"]:
        """Depth-first iteration over this span and its descendants."""
        yield self
        for child in self.children:
            yield from child.walk()

    def find(self, name: str) -> list["Span"]:
        return [s for s in self.walk() if s.name == name]

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "t0": self.t_start,
            "t1": self.t_end,
            "dur_s": self.duration_s,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """Shared do-nothing span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()

# The prefix of a span's profiler range, apart from other annotations.
SPAN_PREFIX = "span:"


class _ProfiledSpan:
    """A span as the profiler alone sees it: a ``span:<name>`` range."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = record_function(SPAN_PREFIX + name)

    def __enter__(self) -> "_ProfiledSpan":
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        return False

    def set(self, **attrs: Any) -> "_ProfiledSpan":
        return self


def _profiled(name: str) -> _ProfiledSpan | _NullSpan:
    """The span's profiler range while ``torch.profiler`` records, else
    the shared no-op."""
    return _ProfiledSpan(name) if _profiler_enabled() else _NULL_SPAN


class NullTracer:
    """API-compatible no-op tracer (the off-by-default recorder); its spans
    reach the profiler alone, while it records."""

    enabled = False

    def span(self, name: str, **attrs: Any) -> _ProfiledSpan | _NullSpan:
        return _profiled(name)

    def add_span(
        self, name: str, t_start: float, t_end: float, **attrs: Any
    ) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def traces(self) -> list:
        return []

    def reset(self) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Collects span trees; one instance per server (not thread-safe)."""

    enabled = True

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        *,
        max_traces: int = 4096,
    ):
        self.clock = clock
        self.max_traces = max_traces
        self.dropped_traces = 0
        self._stack: list[Span] = []
        self._finished: deque[Span] = deque()
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        """Open a child of the current span (or a new root), close on exit;
        mirrored into the profiler while it records."""
        sp = self._open(name, self.clock())
        if attrs:
            sp.attrs.update(attrs)
        try:
            with _profiled(name):
                yield sp
        finally:
            sp.t_end = self.clock()
            self._close(sp)

    def add_span(
        self, name: str, t_start: float, t_end: float, **attrs: Any
    ) -> Span:
        """Record an already-elapsed span from explicit clock values (e.g.
        queue wait measured from the request's own arrival timestamp)."""
        sp = self._open(name, t_start)
        sp.t_end = t_end
        if attrs:
            sp.attrs.update(attrs)
        self._close(sp)
        return sp

    def event(self, name: str, **attrs: Any) -> Span:
        """Zero-duration marker at the current clock (straggler signals,
        store lookups, per-shard shuffle attribution)."""
        now = self.clock()
        return self.add_span(name, now, now, **attrs)

    # ------------------------------------------------------------------
    def _open(self, name: str, t_start: float) -> Span:
        parent = self._stack[-1] if self._stack else None
        sp = Span(
            name=name,
            span_id=next(self._span_ids),
            parent_id=parent.span_id if parent else None,
            trace_id=parent.trace_id if parent else next(self._trace_ids),
            t_start=t_start,
        )
        self._stack.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        popped = self._stack.pop()
        if popped is not sp:
            raise RuntimeError("span closed out of order")
        if self._stack:
            self._stack[-1].children.append(sp)
        else:
            self._finished.append(sp)
            if len(self._finished) > self.max_traces:
                self._finished.popleft()
                self.dropped_traces += 1

    # ------------------------------------------------------------------
    def traces(self) -> list[Span]:
        """Finished root spans, oldest first."""
        return list(self._finished)

    def reset(self) -> None:
        self._finished.clear()
        self._stack.clear()
        self.dropped_traces = 0

    def to_jsonl(self) -> str:
        """One flat JSON object per span, depth-first per trace."""
        lines = []
        for root in self._finished:
            for sp in root.walk():
                lines.append(json.dumps(sp.to_dict(), sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def render(self, trace: Span | None = None) -> str:
        """Human-readable tree dump of one trace (default: the latest)."""
        roots = [trace] if trace is not None else list(self._finished)
        if trace is None and roots:
            roots = roots[-1:]
        out: list[str] = []

        def _fmt(sp: Span, prefix: str, is_last: bool, is_root: bool):
            attrs = " ".join(f"{k}={_short(v)}" for k, v in sp.attrs.items())
            stem = "" if is_root else prefix + ("└─ " if is_last else "├─ ")
            out.append(
                f"{stem}{sp.name}  {sp.duration_s * 1e3:.3f}ms"
                + (f"  [{attrs}]" if attrs else "")
            )
            child_prefix = (
                "" if is_root else prefix + ("   " if is_last else "│  ")
            )
            for i, child in enumerate(sp.children):
                _fmt(child, child_prefix, i == len(sp.children) - 1, False)

        for root in roots:
            _fmt(root, "", True, True)
        return "\n".join(out)


def _short(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


# ---------------------------------------------------------------------------
# context propagation
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar[NullTracer | Tracer] = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=NULL_TRACER
)


def current_tracer() -> NullTracer | Tracer:
    """The tracer installed by the nearest enclosing ``use_tracer``."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_tracer(tracer: NullTracer | Tracer) -> Iterator[NullTracer | Tracer]:
    """Install ``tracer`` as the context tracer for the enclosed block."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


# ---------------------------------------------------------------------------
# schema validation (CI smoke + golden tests)
# ---------------------------------------------------------------------------

def validate_trace_jsonl(text: str) -> list[str]:
    """Validate exported span lines against the pinned schema.

    Returns a list of human-readable problems (empty == valid).  CI runs
    this over the serving path's export and fails on drift.
    """
    problems: list[str] = []
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            problems.append(f"line {i}: not JSON ({e})")
            continue
        if tuple(sorted(obj)) != tuple(sorted(SPAN_KEYS)):
            problems.append(
                f"line {i}: keys {sorted(obj)} != schema {sorted(SPAN_KEYS)}"
            )
            continue
        if obj["schema"] != SCHEMA_VERSION:
            problems.append(f"line {i}: schema version {obj['schema']}")
        if not isinstance(obj["name"], str) or not obj["name"]:
            problems.append(f"line {i}: bad span name")
        if not isinstance(obj["attrs"], dict):
            problems.append(f"line {i}: attrs not a dict")
        if obj["t1"] < obj["t0"]:
            problems.append(f"line {i}: t1 < t0")
    return problems
