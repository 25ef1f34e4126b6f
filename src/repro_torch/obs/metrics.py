"""Host-side metrics registry of the port: counters, gauges and bounded
reservoirs, as ``src/repro/obs/metrics.py`` defines them (the part the
decode engine uses; histograms and the Prometheus and schema-checked
exports come with the observability slice).

Every metric is a *family*: a name, a help string and a fixed tuple of
label names, holding one series per label-value combination
(``family.labels(kind="knn")``).  A family declared with no labels exposes
the series API directly, so ``registry.counter("x").inc()`` works.  A
``Reservoir`` keeps a uniform sample (Vitter's algorithm R) of at most
``capacity`` observations with exact count, sum, min and max, so memory
stays flat under any load; its RNG is seeded per series, so exports are
reproducible.
"""
from __future__ import annotations

import math
import random
from typing import Iterable, Iterator, Sequence

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

    def reset(self) -> None:
        self.value = 0.0

    def to_dict(self) -> dict:
        return {"value": self.value}


class Reservoir:
    """Bounded uniform sample (algorithm R) with exact count/sum/min/max.

    Percentiles are computed over at most ``capacity`` retained samples, so
    memory stays flat no matter how many observations arrive.
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

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    def series(self) -> Iterator[tuple[dict[str, str], object]]:
        for key in sorted(self._children):
            yield dict(zip(self.label_names, key)), self._children[key]

    def reset(self) -> None:
        for s in self._children.values():
            s.reset()


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

    def snapshot(self) -> dict:
        """JSON-able snapshot: {kind: {name: {label string: series}}}."""
        out: dict = {}
        for fam in self.families():
            out.setdefault(fam.kind + "s", {})[fam.name] = {
                ",".join(f"{k}={v}" for k, v in labels.items()): s.to_dict()
                for labels, s in fam.series()}
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _DEFAULT
