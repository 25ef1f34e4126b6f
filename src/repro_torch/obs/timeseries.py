"""Aligned fixed-width windowed rollups: the time axis the registry lacks.

``MetricsRegistry`` answers "what happened since the process started" —
lifetime counters and reservoirs.  The decision layer (``repro_torch.obs.slo``)
needs "what happened in the last N seconds": a burn rate is a *rate*, a
load signal is a *recent* quantile, and a straggler is slow *now*.
``WindowedRollup`` provides that axis:

  * windows are **aligned** to multiples of ``window_s`` on the injected
    clock (``floor(now / window_s) * window_s``), so two rollups over the
    same clock agree on window boundaries and tests can pin them exactly;
  * closed windows live in a **bounded ring** (``max_windows``) and each
    window's value streams are bounded reservoirs (``samples_per_window``),
    so memory stays flat under unbounded traffic — same discipline as the
    registry's reservoirs;
  * queries (``rate`` / ``total`` / ``quantile`` / ``stats``) pool the
    windows that overlap the last ``windows * window_s`` seconds.  Missing
    windows (idle periods) count as zero events — a rate over a quiet span
    is genuinely low, not "no data".

Two feeding modes:

  * **push** — ``observe`` / ``count`` / ``set`` record directly into the
    current window (``ServeMetrics`` pushes per-request latencies and
    deadline outcomes this way);
  * **pull** — ``sample_registry`` diffs counter families of a
    ``MetricsRegistry`` against the previous sample and records the deltas,
    turning any lifetime counter into a windowed rate without touching its
    writers.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Iterable

from repro_torch.obs.metrics import MetricsRegistry, Reservoir, percentile

DEFAULT_WINDOW_S = 1.0
DEFAULT_MAX_WINDOWS = 64
DEFAULT_SAMPLES_PER_WINDOW = 256


class _Window:
    """One aligned window: bounded value streams + counts + last-gauges."""

    __slots__ = ("start", "values", "counts", "gauges", "_capacity")

    def __init__(self, start: float, capacity: int):
        self.start = start
        self.values: dict[str, Reservoir] = {}
        self.counts: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self._capacity = capacity

    def series(self, name: str) -> Reservoir:
        s = self.values.get(name)
        if s is None:
            s = Reservoir(capacity=self._capacity)
            self.values[name] = s
        return s


class WindowedRollup:
    """Fixed-width aligned windows over named value/count/gauge streams."""

    def __init__(
        self,
        window_s: float = DEFAULT_WINDOW_S,
        *,
        max_windows: int = DEFAULT_MAX_WINDOWS,
        samples_per_window: int = DEFAULT_SAMPLES_PER_WINDOW,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        if max_windows < 1:
            raise ValueError("need at least one retained window")
        self.window_s = float(window_s)
        self.max_windows = max_windows
        self.samples_per_window = samples_per_window
        self.clock = clock
        self._closed: deque[_Window] = deque(maxlen=max_windows)
        self._current: _Window | None = None
        self._last_totals: dict[tuple[str, tuple[str, ...]], float] = {}

    # ------------------------------------------------------------------
    # window management
    # ------------------------------------------------------------------
    def window_start(self, t: float) -> float:
        """Aligned start of the window containing clock value ``t``."""
        return math.floor(t / self.window_s) * self.window_s

    def _advance(self) -> _Window:
        start = self.window_start(self.clock())
        cur = self._current
        if cur is None:
            cur = self._current = _Window(start, self.samples_per_window)
        elif cur.start != start:
            self._closed.append(cur)
            cur = self._current = _Window(start, self.samples_per_window)
        return cur

    def tick(self) -> None:
        """Roll the current window forward if the clock crossed a boundary
        (queries do this implicitly; call explicitly from idle loops)."""
        self._advance()

    # ------------------------------------------------------------------
    # push feeds
    # ------------------------------------------------------------------
    def observe(self, name: str, v: float) -> None:
        """Record one value sample (latency, ratio, ...) in the current
        window's bounded stream."""
        self._advance().series(name).observe(v)

    def count(self, name: str, v: float = 1.0) -> None:
        """Add to the current window's event count for ``name``."""
        cur = self._advance()
        cur.counts[name] = cur.counts.get(name, 0.0) + v

    def set(self, name: str, v: float) -> None:
        """Record a last-value-wins gauge for the current window."""
        self._advance().gauges[name] = float(v)

    # ------------------------------------------------------------------
    # pull feed: counter deltas from a registry
    # ------------------------------------------------------------------
    def sample_registry(
        self, registry: MetricsRegistry, names: Iterable[str] | None = None,
    ) -> None:
        """Diff counter families against the previous sample; record deltas
        as window counts keyed ``name[v1,v2]`` (label values in order)."""
        wanted = set(names) if names is not None else None
        for fam in registry.families():
            if fam.kind != "counter":
                continue
            if wanted is not None and fam.name not in wanted:
                continue
            for labels, series in fam.series():
                label_key = tuple(labels[k] for k in fam.label_names)
                key = (fam.name, label_key)
                prev = self._last_totals.get(key, 0.0)
                delta = series.value - prev
                self._last_totals[key] = series.value
                if delta:
                    self.count(_keyed(fam.name, label_key), delta)

    # ------------------------------------------------------------------
    # queries (pool the windows overlapping the last windows*window_s)
    # ------------------------------------------------------------------
    def _recent(self, windows: int) -> list[_Window]:
        cur = self._advance()
        cutoff = cur.start - (windows - 1) * self.window_s
        out = [w for w in self._closed if w.start >= cutoff - 1e-12]
        out.append(cur)
        return out

    def values(self, name: str, windows: int = 10) -> list[float]:
        """Pooled retained samples of ``name`` over the last N windows."""
        out: list[float] = []
        for w in self._recent(windows):
            s = w.values.get(name)
            if s is not None:
                out.extend(s.samples)
        return out

    def quantile(self, name: str, p: float, *, windows: int = 10) -> float:
        """Percentile of pooled samples over the last N windows (nan if
        nothing was observed there)."""
        return percentile(self.values(name, windows), p)

    def total(self, name: str, windows: int = 10) -> float:
        """Summed event count over the last N windows (idle windows = 0)."""
        return sum(
            w.counts.get(name, 0.0) for w in self._recent(windows)
        )

    def rate(self, name: str, windows: int = 10) -> float:
        """Events/second over the last N aligned windows' full span."""
        return self.total(name, windows) / (windows * self.window_s)

    def last(self, name: str, windows: int = 10) -> float | None:
        """Most recent gauge value for ``name`` within the last N windows."""
        for w in reversed(self._recent(windows)):
            if name in w.gauges:
                return w.gauges[name]
        return None

    def stats(self, name: str, windows: int = 10) -> dict:
        """Exact pooled count/sum/min/max + sampled percentiles of a value
        stream over the last N windows."""
        count, total = 0, 0.0
        lo, hi = math.inf, -math.inf
        for w in self._recent(windows):
            s = w.values.get(name)
            if s is None or not s.count:
                continue
            count += s.count
            total += s.sum
            lo = min(lo, s.min)
            hi = max(hi, s.max)
        samples = self.values(name, windows)
        return {
            "count": count,
            "sum": total,
            "min": lo if count else math.nan,
            "max": hi if count else math.nan,
            "mean": total / count if count else math.nan,
            "p50": percentile(samples, 50),
            "p99": percentile(samples, 99),
        }

    # ------------------------------------------------------------------
    @property
    def n_windows(self) -> int:
        """Retained windows (closed ring + the current one)."""
        return len(self._closed) + (1 if self._current is not None else 0)

    def window_starts(self) -> list[float]:
        out = [w.start for w in self._closed]
        if self._current is not None:
            out.append(self._current.start)
        return out


def _keyed(name: str, label_values: tuple[str, ...]) -> str:
    if not label_values:
        return name
    return f"{name}[{','.join(label_values)}]"
