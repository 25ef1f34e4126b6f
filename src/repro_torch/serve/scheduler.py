"""Request queue + continuous-batching scheduler.

Admission is heterogeneous — kNN queries, CF recommendations, and any other
``Servable`` share one queue — but execution is homogeneous: each scheduled
batch holds requests of a single kind so it maps onto one fixed-shape
call.  Whenever the server frees capacity it calls ``next_batch``, which

  1. picks the most urgent waiting request (earliest absolute deadline),
  2. packs further requests of the same kind *and a compatible SLO class*
     (quantized log2 of remaining budget) in deadline order, up to
     ``max_batch``,
  3. quantizes the batch size up to the next configured pad size so the
     cache sees a bounded set of shapes.

The SLO-class gate is what keeps continuous batching deadline-aware: a
relaxed request must not be dragged down to an urgent co-passenger's eps
grant (the controller grants per batch on the minimum remaining budget),
and an urgent request must not wait for a relaxed one's refinement.
Re-execution requests (the escalation fault path) carry their own relaxed
deadline and are queued like any other request.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.serve.request import Request

PAD_SIZES = (1, 2, 4, 8, 16, 32, 64)


def slo_class(remaining_s: float) -> int:
    """Quantize remaining budget to a log2 class; co-batchable iff equal."""
    return int(math.floor(math.log2(max(remaining_s, 1e-6))))


def pad_size(n: int, sizes: Sequence[int] = PAD_SIZES) -> int:
    """Smallest configured size >= n (largest size if n exceeds them all)."""
    for s in sizes:
        if s >= n:
            return s
    return sizes[-1]


@dataclasses.dataclass
class ScheduledBatch:
    """One fixed-shape unit of work: same kind, compatible deadlines."""

    kind: str
    requests: list[Request]
    padded_size: int

    @property
    def n(self) -> int:
        return len(self.requests)

    def min_remaining(self, now: float) -> float:
        return min(r.remaining(now) for r in self.requests)


class ContinuousBatcher:
    """Deadline-ordered queue that emits kind-homogeneous padded batches."""

    def __init__(
        self,
        *,
        max_batch: int = 8,
        pad_sizes: Sequence[int] = PAD_SIZES,
        slo_aware: bool = True,
    ):
        self.pad_sizes = tuple(sorted(pad_sizes))
        # A batch larger than the largest pad size could not be padded to a
        # fixed shape; clamp rather than emit shape-breaking batches.
        self.max_batch = min(max_batch, self.pad_sizes[-1])
        self.slo_aware = slo_aware
        self._queue: list[Request] = []

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, request: Request) -> None:
        self._queue.append(request)

    def pending_kinds(self) -> set[str]:
        return {r.kind for r in self._queue}

    def next_batch(self, now: float) -> ScheduledBatch | None:
        """Pop the next batch: most urgent head + compatible co-passengers."""
        if not self._queue:
            return None
        # Earliest absolute deadline first (stable for equal deadlines).
        self._queue.sort(key=lambda r: r.arrival_t + r.deadline_s)
        head = self._queue[0]
        head_class = slo_class(head.remaining(now))
        picked = [head]
        for r in self._queue[1:]:
            if len(picked) >= self.max_batch:
                break
            if r.kind != head.kind:
                continue
            # The fault path (re-execution) runs at full eps; never mix it
            # with deadline-granted traffic in one grant.
            if r.reexecution != head.reexecution:
                continue
            if self.slo_aware and slo_class(r.remaining(now)) != head_class:
                continue
            picked.append(r)
        picked_ids = {id(r) for r in picked}
        self._queue = [r for r in self._queue if id(r) not in picked_ids]
        return ScheduledBatch(
            kind=head.kind,
            requests=picked,
            padded_size=pad_size(len(picked), self.pad_sizes),
        )
