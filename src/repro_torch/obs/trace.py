"""Span-tree tracing that deeper layers pick up from the context.

A ``Span`` is one named, timed unit of host work; spans nest into a tree
rooted at the outermost open span.  A tracer owns one host clock
(``perf_counter`` by default, injectable for tests).  Work on the card is
asynchronous, so a layer that times it under a live tracer synchronises the
card before it closes the span.

The tracer travels in a ``contextvars.ContextVar``: ``use_tracer`` installs
one around a block and ``current_tracer()`` finds it, so no tracer parameter
threads through the stack.  The default ``NULL_TRACER`` does nothing.
This is the part of ``src/repro/obs/trace.py`` that the map/reduce engine
and the aggregate store need (spans, already-elapsed spans and events);
export and rendering come with the observability slice.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import time
from typing import Any, Callable, Iterator


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
        """Attach attributes (shuffle bytes, mode, ...)."""
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


class NullTracer:
    """API-compatible no-op tracer (the off-by-default recorder)."""

    enabled = False

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

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

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._stack: list[Span] = []
        self._finished: list[Span] = []
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        """Open a child of the current span (or a new root), close on exit."""
        sp = self._open(name, self.clock())
        if attrs:
            sp.attrs.update(attrs)
        try:
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
        """Zero-duration marker at the current clock (store lookups, ...)."""
        now = self.clock()
        return self.add_span(name, now, now, **attrs)

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

    def traces(self) -> list[Span]:
        """Finished root spans, oldest first."""
        return list(self._finished)

    def reset(self) -> None:
        self._finished.clear()
        self._stack.clear()


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
