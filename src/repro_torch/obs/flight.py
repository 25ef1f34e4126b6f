"""Tail-sampling flight recorder: keep the traces worth explaining.

A tracer that retains *every* span tree is memory-bounded only by its ring
— under sustained traffic the interesting traces (the request that missed
its SLO three hours ago) age out long before anyone asks.  The flight
recorder inverts the policy: it looks at each finished batch trace once
and retains the full span tree only when the batch is worth a post-mortem:

  * **slo_missed** — a first-execution response blew its deadline: always
    kept (these are the traces the burn-rate alert will point at);
  * **escalated**  — the grant fell below the eps floor and the batch went
    to the re-execution fault path: always kept;
  * **tail**       — the batch landed in the slowest ``tail_fraction`` of
    recent root durations (threshold from a bounded history of recent
    durations): kept as context for "what does slow-but-passing look
    like".

Retention is a bounded ring with priority eviction: when the ring is full,
tail entries are evicted oldest-first before any slo_missed/escalated
entry is touched, so unbounded traffic stays memory-flat while every bad
request stays fully explainable.  ``to_jsonl``/``dump`` export one JSON
object per retained entry — reason, request ids, and the *complete* span
tree — with the schema pinned by ``validate_flight_jsonl``.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Iterable, Sequence

from repro_torch.obs.metrics import percentile
from repro_torch.obs.trace import Span, validate_trace_jsonl

SCHEMA_VERSION = 1
ENTRY_KEYS = ("schema", "seq", "reason", "dur_s", "rids", "missed_rids",
              "spans")

# Reasons that are never evicted in favour of tail samples.
PRIORITY_REASONS = ("slo_missed", "escalated")


class FlightEntry:
    """One retained batch: why it was kept + its full span tree."""

    __slots__ = ("seq", "reason", "root", "rids", "missed_rids")

    def __init__(
        self, seq: int, reason: str, root: Span,
        rids: tuple[int, ...], missed_rids: tuple[int, ...],
    ):
        self.seq = seq
        self.reason = reason
        self.root = root
        self.rids = rids
        self.missed_rids = missed_rids

    @property
    def priority(self) -> bool:
        return self.reason in PRIORITY_REASONS

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "seq": self.seq,
            "reason": self.reason,
            "dur_s": self.root.duration_s,
            "rids": list(self.rids),
            "missed_rids": list(self.missed_rids),
            "spans": [sp.to_dict() for sp in self.root.walk()],
        }


class FlightRecorder:
    """Bounded, priority-evicting ring of post-mortem-worthy traces."""

    def __init__(
        self,
        capacity: int = 64,
        *,
        tail_fraction: float = 0.1,
        duration_history: int = 256,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not 0.0 <= tail_fraction <= 1.0:
            raise ValueError("tail_fraction must be in [0, 1]")
        self.capacity = capacity
        self.tail_fraction = tail_fraction
        self._entries: deque[FlightEntry] = deque()
        self._durations: deque[float] = deque(maxlen=duration_history)
        self._seq = 0
        self.considered = 0
        self.dropped_tail = 0      # not retained at consideration time
        self.evicted_tail = 0      # retained, later evicted by the bound
        self.evicted_priority = 0  # priority entries lost to the bound

    # ------------------------------------------------------------------
    def record(
        self,
        root: Span,
        responses: Sequence = (),
        *,
        slo_missed: bool | None = None,
        escalated: bool | None = None,
    ) -> str | None:
        """Consider one finished batch trace; returns the retention reason
        or None when the batch was healthy and not in the slow tail.

        ``slo_missed``/``escalated`` are derived from ``responses`` when not
        given explicitly: re-execution responses carry a server-invented
        relaxed deadline, so only first executions can miss an SLO.
        """
        self.considered += 1
        missed_rids = tuple(
            r.rid for r in responses
            if not r.deadline_met and not r.reexecuted
        )
        if slo_missed is None:
            slo_missed = bool(missed_rids)
        if escalated is None:
            escalated = any(r.escalated for r in responses)
        dur = root.duration_s
        # Tail decision against history *before* this batch joins it — the
        # first batch ever seen is trivially the slowest so far, and a
        # fraction of 1.0 means "the slowest 100%", i.e. everything.
        in_tail = (
            self.tail_fraction > 0.0
            and (
                self.tail_fraction >= 1.0
                or not self._durations
                or dur >= percentile(
                    self._durations, 100.0 * (1.0 - self.tail_fraction)
                )
            )
        )
        self._durations.append(dur)

        if slo_missed:
            reason = "slo_missed"
        elif escalated:
            reason = "escalated"
        elif in_tail:
            reason = "tail"
        else:
            self.dropped_tail += 1
            return None

        self._seq += 1
        rids = tuple(r.rid for r in responses)
        self._entries.append(
            FlightEntry(self._seq, reason, root, rids, missed_rids)
        )
        self._enforce_bound()
        return reason

    def _enforce_bound(self) -> None:
        while len(self._entries) > self.capacity:
            # Evict the oldest tail entry first; only when the ring is all
            # priority entries does the oldest of those go.
            victim_i = next(
                (i for i, e in enumerate(self._entries) if not e.priority),
                0,
            )
            victim = self._entries[victim_i]
            del self._entries[victim_i]
            if victim.priority:
                self.evicted_priority += 1
            else:
                self.evicted_tail += 1

    # ------------------------------------------------------------------
    def entries(self, reasons: Iterable[str] | None = None) -> list[FlightEntry]:
        """Retained entries, oldest first (optionally filtered by reason)."""
        if reasons is None:
            return list(self._entries)
        wanted = set(reasons)
        return [e for e in self._entries if e.reason in wanted]

    def __len__(self) -> int:
        return len(self._entries)

    def reset(self) -> None:
        self._entries.clear()
        self._durations.clear()
        self.considered = 0
        self.dropped_tail = 0
        self.evicted_tail = 0
        self.evicted_priority = 0

    # ------------------------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per retained entry, full span tree inlined."""
        lines = [
            json.dumps(e.to_dict(), sort_keys=True) for e in self._entries
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path) -> str:
        """Write the jsonl export to ``path`` (dump-on-demand)."""
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return str(path)

    def summary(self) -> dict:
        by_reason: dict[str, int] = {}
        for e in self._entries:
            by_reason[e.reason] = by_reason.get(e.reason, 0) + 1
        return {
            "retained": len(self._entries),
            "by_reason": by_reason,
            "considered": self.considered,
            "dropped_tail": self.dropped_tail,
            "evicted_tail": self.evicted_tail,
            "evicted_priority": self.evicted_priority,
        }


def validate_flight_jsonl(text: str) -> list[str]:
    """Validate a flight-recorder export; returns problems (empty == valid).

    Each line must carry the pinned entry keys and every inlined span must
    itself satisfy the trace span schema.
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
        if tuple(sorted(obj)) != tuple(sorted(ENTRY_KEYS)):
            problems.append(
                f"line {i}: keys {sorted(obj)} != schema {sorted(ENTRY_KEYS)}"
            )
            continue
        if obj["schema"] != SCHEMA_VERSION:
            problems.append(f"line {i}: schema version {obj['schema']}")
        if obj["reason"] not in PRIORITY_REASONS + ("tail",):
            problems.append(f"line {i}: unknown reason {obj['reason']!r}")
        if not obj["spans"]:
            problems.append(f"line {i}: entry has no spans")
            continue
        span_jsonl = "\n".join(
            json.dumps(sp, sort_keys=True) for sp in obj["spans"]
        )
        for p in validate_trace_jsonl(span_jsonl):
            problems.append(f"line {i}: {p}")
    return problems
