"""Typed metrics registry: counters, gauges, bounded histograms, reservoirs.

Every metric is a *family* — a name + help string + a fixed tuple of label
names — holding one series per label-value combination (``family.labels(
kind="knn")``).  A family declared with no labels exposes the series API
directly, so ``registry.counter("x").inc()`` works without ceremony.

Two bounded sample types fix the unbounded-list growth the old
``ServeMetrics`` had under sustained load:

  * ``Histogram`` — fixed cumulative buckets (Prometheus semantics):
    O(#buckets) memory forever, exact counts/sum, quantiles bounded by
    bucket resolution;
  * ``Reservoir`` — uniform reservoir sampling (Vitter's algorithm R) with
    exact count/sum/min/max and interpolated percentiles over at most
    ``capacity`` retained samples.  Deterministic RNG per series, so
    exports are reproducible.

Exports: ``snapshot()`` (JSON-able, schema pinned by
``validate_snapshot``) and ``to_prometheus()`` (text exposition format).
``default_registry()`` is the process-wide registry used by the kernel
probes and the benchmark harness; serving metrics use a private registry
per server so concurrent servers never share counters.
"""
from __future__ import annotations

import math
import random
from typing import Iterable, Iterator, Sequence

SCHEMA_VERSION = 1
SNAPSHOT_KEYS = ("schema", "counters", "gauges", "histograms", "reservoirs")

# Prometheus-style default latency buckets (seconds).
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)
DEFAULT_RESERVOIR = 1024


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile, numpy-``linear``-compatible.

    Pinned edge cases: empty input -> nan; single sample -> that sample;
    p=0 -> min; p=100 -> exactly the max (no interpolation overshoot).
    ``p`` outside [0, 100] is clamped.
    """
    xs = sorted(float(v) for v in values)
    n = len(xs)
    if n == 0:
        return math.nan
    if n == 1:
        return xs[0]
    p = min(max(p, 0.0), 100.0)
    rank = (p / 100.0) * (n - 1)
    lo = int(math.floor(rank))
    hi = int(math.ceil(rank))
    if lo == hi:
        return xs[lo]
    frac = rank - lo
    return xs[lo] + (xs[hi] - xs[lo]) * frac


# ---------------------------------------------------------------------------
# series types
# ---------------------------------------------------------------------------

class Counter:
    """Monotonically increasing count (requests, bytes, events)."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def reset(self) -> None:
        self.value = 0.0

    def to_dict(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Point-in-time value (queue depth, resident bytes, correction)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v

    def reset(self) -> None:
        self.value = 0.0

    def to_dict(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed cumulative-bucket histogram — O(#buckets) memory forever."""

    kind = "histogram"
    __slots__ = ("buckets", "bucket_counts", "count", "sum")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """Prometheus-style cumulative (le, count) pairs ending at +Inf."""
        out, acc = [], 0
        for le, c in zip(self.buckets, self.bucket_counts):
            acc += c
            out.append((le, acc))
        out.append((math.inf, self.count))
        return out

    def reset(self) -> None:
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0

    def to_dict(self) -> dict:
        return {
            "buckets": [
                ["+Inf" if math.isinf(le) else le, c]
                for le, c in self.cumulative()
            ],
            "count": self.count,
            "sum": self.sum,
        }


class Reservoir:
    """Bounded uniform sample (algorithm R) with exact count/sum/min/max.

    Percentiles are computed over at most ``capacity`` retained samples, so
    memory stays flat no matter how many observations arrive — the fix for
    the old unbounded per-request latency lists.
    """

    kind = "reservoir"
    __slots__ = ("capacity", "samples", "count", "sum", "min", "max", "_rng")

    def __init__(self, capacity: int = DEFAULT_RESERVOIR, seed: int = 0):
        if capacity < 1:
            raise ValueError("reservoir capacity must be >= 1")
        self.capacity = capacity
        self.samples: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < self.capacity:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.samples[j] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def percentile(self, p: float) -> float:
        return percentile(self.samples, p)

    def reset(self) -> None:
        self.samples.clear()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def to_dict(self) -> dict:
        finite = self.count > 0
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if finite else None,
            "max": self.max if finite else None,
            "mean": self.mean if finite else None,
            "p50": _none_if_nan(self.percentile(50)),
            "p90": _none_if_nan(self.percentile(90)),
            "p99": _none_if_nan(self.percentile(99)),
        }


def _none_if_nan(v: float) -> float | None:
    return None if math.isnan(v) else v


# ---------------------------------------------------------------------------
# labeled families
# ---------------------------------------------------------------------------

class Family:
    """Name + help + label names -> one series per label-value tuple.

    A label-less family proxies the series API of its single default child,
    so ``registry.counter("x").inc()`` needs no ``.labels()`` call.
    """

    def __init__(self, name: str, help: str, label_names: tuple[str, ...],
                 factory):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._factory = factory
        self._children: dict[tuple[str, ...], object] = {}
        self.kind = factory().kind

    def labels(self, **labels: object):
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._factory()
            self._children[key] = child
        return child

    def _default(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} is labeled {self.label_names}: use .labels()"
            )
        return self.labels()

    # --- proxy API for label-less families ---
    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    # --- aggregation over series (summary helpers) ---
    def series(self) -> Iterator[tuple[dict[str, str], object]]:
        for key in sorted(self._children):
            yield dict(zip(self.label_names, key)), self._children[key]

    def total(self) -> float:
        """Sum of counter/gauge values (or observation counts) across series."""
        out = 0.0
        for _, s in self.series():
            out += s.value if hasattr(s, "value") else s.count
        return out

    def merged_samples(self) -> list[float]:
        """Reservoir families: pooled retained samples across all series."""
        out: list[float] = []
        for _, s in self.series():
            out.extend(s.samples)
        return out

    def merged_stats(self) -> dict:
        """Reservoir families: exact pooled count/sum/min/max + percentiles."""
        count, total = 0, 0.0
        lo, hi = math.inf, -math.inf
        for _, s in self.series():
            count += s.count
            total += s.sum
            if s.count:
                lo = min(lo, s.min)
                hi = max(hi, s.max)
        samples = self.merged_samples()
        return {
            "count": count,
            "sum": total,
            "min": lo if count else math.nan,
            "max": hi if count else math.nan,
            "mean": total / count if count else math.nan,
            "p50": percentile(samples, 50),
            "p99": percentile(samples, 99),
        }

    def reset(self) -> None:
        for s in self._children.values():
            s.reset()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Owns metric families; re-declaring a name returns the existing family
    (declarations are idempotent so modules can declare where they record),
    but a kind/label mismatch is a hard error — silent aliasing of two
    different metrics under one name is how dashboards lie."""

    def __init__(self):
        self._families: dict[str, Family] = {}

    def _declare(self, name: str, help: str, labels: Iterable[str],
                 factory) -> Family:
        labels = tuple(labels)
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != factory().kind or fam.label_names != labels:
                raise ValueError(
                    f"metric {name!r} re-declared as {factory().kind}"
                    f"{labels}, existing {fam.kind}{fam.label_names}"
                )
            return fam
        fam = Family(name, help, labels, factory)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Family:
        return self._declare(name, help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Family:
        return self._declare(name, help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        return self._declare(
            name, help, labels, lambda: Histogram(buckets)
        )

    def reservoir(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  capacity: int = DEFAULT_RESERVOIR) -> Family:
        return self._declare(
            name, help, labels, lambda: Reservoir(capacity)
        )

    def families(self) -> Iterator[Family]:
        for name in sorted(self._families):
            yield self._families[name]

    def get(self, name: str) -> Family | None:
        return self._families.get(name)

    def reset(self) -> None:
        """Zero every series (families and label sets stay declared)."""
        for fam in self._families.values():
            fam.reset()

    # ------------------------------------------------------------------
    # exports
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot grouped by metric kind (schema pinned)."""
        out: dict = {
            "schema": SCHEMA_VERSION,
            "counters": [], "gauges": [], "histograms": [], "reservoirs": [],
        }
        for fam in self.families():
            for labels, s in fam.series():
                entry = {"name": fam.name, "help": fam.help,
                         "labels": labels}
                entry.update(s.to_dict())
                out[fam.kind + "s"].append(entry)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (reservoirs export as summaries)."""
        lines: list[str] = []
        for fam in self.families():
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram", "reservoir": "summary"}
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {ptype[fam.kind]}")
            for labels, s in fam.series():
                base = _labels_str(labels)
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{fam.name}{base} {_num(s.value)}")
                elif fam.kind == "histogram":
                    for le, c in s.cumulative():
                        le_s = "+Inf" if math.isinf(le) else _num(le)
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_labels_str(labels, le=le_s)} {c}"
                        )
                    lines.append(f"{fam.name}_sum{base} {_num(s.sum)}")
                    lines.append(f"{fam.name}_count{base} {s.count}")
                else:  # reservoir -> summary quantiles
                    for q in (0.5, 0.9, 0.99):
                        v = s.percentile(q * 100)
                        if not math.isnan(v):
                            lines.append(
                                f"{fam.name}"
                                f"{_labels_str(labels, quantile=_num(q))}"
                                f" {_num(v)}"
                            )
                    lines.append(f"{fam.name}_sum{base} {_num(s.sum)}")
                    lines.append(f"{fam.name}_count{base} {s.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _labels_str(labels: dict[str, str], **extra: str) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def _num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# default (process-wide) registry + snapshot schema validation
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry (kernel probes, runtime events, BENCH embed)."""
    return _DEFAULT


def validate_snapshot(snap: dict) -> list[str]:
    """Validate a ``snapshot()`` dict; returns problems (empty == valid)."""
    problems: list[str] = []
    if tuple(sorted(snap)) != tuple(sorted(SNAPSHOT_KEYS)):
        return [f"top-level keys {sorted(snap)} != {sorted(SNAPSHOT_KEYS)}"]
    if snap["schema"] != SCHEMA_VERSION:
        problems.append(f"schema version {snap['schema']}")
    required = {
        "counters": {"name", "help", "labels", "value"},
        "gauges": {"name", "help", "labels", "value"},
        "histograms": {"name", "help", "labels", "buckets", "count", "sum"},
        "reservoirs": {"name", "help", "labels", "count", "sum", "min",
                       "max", "mean", "p50", "p90", "p99"},
    }
    for kind, keys in required.items():
        for i, entry in enumerate(snap[kind]):
            if set(entry) != keys:
                problems.append(
                    f"{kind}[{i}] keys {sorted(entry)} != {sorted(keys)}"
                )
    return problems
