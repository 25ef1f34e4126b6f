"""Kernel and accuracy probes: measured-time telemetry for the hot path.

``KernelProbe`` hooks the public dispatch wrappers in
``repro_torch.kernels.ops``: when installed, every kernel call is timed
until the card has finished it and recorded into a metrics registry as a
reservoir (measured p50 per op) plus byte counters, labeled by op name,
dispatch path (``cuda`` for a CUDA tensor, ``ref`` for a CPU one) and the
dominant input's shape.

Three rules keep the numbers honest:

  * a launch returns before the card has run it, so the probe synchronises
    the device of the output's tensors before it reads the clock: without
    that it would time the launch, not the kernel;
  * a call made while a CUDA graph is being captured is passed through
    untimed: synchronising inside a capture is an error, and a clock read
    there records capture time, not run time;
  * when no probe is installed the wrappers in ``ops.py`` fall through with
    a single ``is None`` test, so the un-observed hot path stays lean.

The accuracy-proxy channel rides ``repro_torch.serve`` instead: servables
define ``accuracy_proxy(stage1_out, refined_out, n)`` (top-k overlap
divergence for kNN, rating-MAE delta for CF) and ``ServeMetrics`` records
it.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable

import torch

from repro_torch.device import block_until_ready, tensors
from repro_torch.kernels import ops as ops_lib
from repro_torch.obs.metrics import (
    MetricsRegistry, default_registry, percentile,
)


def _tree_nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (0 stays 0)."""
    return 1 << (int(n) - 1).bit_length() if n > 0 else 0


def dominant_shape_label(args: tuple) -> str:
    """Problem-size label for one op call: the largest input tensor's dims,
    each rounded up to a power of two.

    The raw shape would be an unbounded label set (every N is its own
    series); bucketing to powers of two bounds cardinality at ~log(N) per
    axis while keeping regression comparisons like-for-like — a 10k-point
    and a 1M-point ``distance_topk`` dispatch never share a series.
    """
    best_shape: tuple | None = None
    best_bytes = -1
    for leaf in tensors(args):
        nbytes = leaf.numel() * leaf.element_size()
        if nbytes > best_bytes:
            best_bytes = nbytes
            best_shape = tuple(leaf.shape)
    if not best_shape:
        return "scalar"
    return "x".join(str(_pow2_bucket(d)) for d in best_shape)


class KernelProbe:
    """Per-op measured wall time + bytes, recorded into a registry."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        clock: Callable[[], float] = time.perf_counter,
        capacity: int = 512,
    ):
        self.registry = (registry if registry is not None
                         else default_registry())
        self.clock = clock
        # "shape" is the dominant input's pow2-bucketed dims (bounded
        # cardinality), so regression comparisons match like-for-like
        # dispatches instead of averaging a 2k probe into a 1M sweep.
        self._latency = self.registry.reservoir(
            "kernel_latency_s",
            "Measured host wall time per kernel-op call (card synchronised).",
            labels=("op", "path", "shape"), capacity=capacity,
        )
        self._bytes = self.registry.counter(
            "kernel_bytes_total",
            "Input+output tensor bytes moved per kernel op call.",
            labels=("op", "path", "shape"),
        )
        self._calls = self.registry.counter(
            "kernel_calls_total",
            "Kernel-op calls (calls under a graph capture are not counted).",
            labels=("op", "path", "shape"),
        )

    # Called by the ops.py dispatch wrappers.
    def timed(self, op: str, fn: Callable, args: tuple, kwargs: dict) -> Any:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            return fn(*args, **kwargs)
        t0 = self.clock()
        out = block_until_ready(fn(*args, **kwargs))
        dt = self.clock() - t0
        first = next(tensors(args), None)
        path = ops_lib.dispatch_path(first) if first is not None else "ref"
        shape = dominant_shape_label(args)
        self._latency.labels(op=op, path=path, shape=shape).observe(dt)
        self._calls.labels(op=op, path=path, shape=shape).inc()
        self._bytes.labels(op=op, path=path, shape=shape).inc(
            _tree_nbytes(args) + _tree_nbytes(out)
        )
        return out

    def summary(self, *, by_shape: bool = False) -> dict:
        """Per-dispatch stats.

        Default keys are ``"op[path]"`` (shapes pooled); ``by_shape=True``
        keys ``"op[path][shape]"`` so regression gates compare like-for-like
        problem sizes.
        """
        byte_series = {
            tuple(sorted(labels.items())): s.value
            for labels, s in self._bytes.series()
        }
        grouped: dict[str, dict] = {}
        for labels, s in self._latency.series():
            key = f"{labels['op']}[{labels['path']}]"
            if by_shape:
                key += f"[{labels['shape']}]"
            row = grouped.setdefault(
                key, {"count": 0, "sum_s": 0.0, "bytes": 0.0, "samples": []}
            )
            row["count"] += s.count
            row["sum_s"] += s.sum
            row["samples"].extend(s.samples)
            row["bytes"] += byte_series.get(
                tuple(sorted(labels.items())), 0.0
            )
        out: dict = {}
        for key, row in grouped.items():
            out[key] = {
                "count": row["count"],
                "p50_s": percentile(row["samples"], 50),
                "mean_s": (
                    row["sum_s"] / row["count"] if row["count"] else math.nan
                ),
                "bytes": row["bytes"],
            }
        return out

    def calls(self) -> dict[str, int]:
        """Calls per op label, pooled over paths and shapes."""
        out: dict[str, int] = {}
        for labels, s in self._calls.series():
            out[labels["op"]] = out.get(labels["op"], 0) + int(s.value)
        return out


def install_kernel_probe(
    registry: MetricsRegistry | None = None, **kwargs: Any
) -> KernelProbe:
    """Create a probe and hook it into the kernel dispatch layer."""
    probe = KernelProbe(registry, **kwargs)
    ops_lib.set_probe(probe)
    return probe


def uninstall_kernel_probe() -> None:
    """Detach any installed probe (dispatch reverts to the lean path)."""
    ops_lib.set_probe(None)
