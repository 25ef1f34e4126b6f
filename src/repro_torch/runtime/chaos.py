"""Deterministic fault injection: the chaos harness behind the fault-domain
serving runtime.

The paper's promise — an on-time, degraded-accuracy answer instead of a
late exact one — is only credible if the degradation paths are *driven*,
not just written.  This module makes faults a first-class, reproducible
input: every injector decision is a pure function of ``(seed, step, shard,
kind, attempt)``, so a failing chaos run replays bit-identically from its
seed, regardless of how many times or in what order the consumer asks.

Injectable faults (``ChaosEvent.kind``):

  * ``"kill"``             — the shard dies mid-batch (``ShardDead``); the
                             batch completes from the survivors and a
                             background recovery path restores the shard;
  * ``"slow"``             — the shard runs ``factor`` times slower (a real
                             stall, so measured latencies and the straggler
                             eps-shrink react to it);
  * ``"drop_heartbeat"``   — the shard's liveness beat is suppressed (the
                             supervisor's staleness detection must notice);
  * ``"corrupt_snapshot"`` — the shard's on-disk aggregate snapshot is
                             unusable; recovery must fall back to a cold
                             rebuild instead of crashing.

Consumers (``runtime.shards.ShardedServable``, ``runtime.Supervisor``, the
chaos tests/example/benchmark) ask ``fires(step, shard, kind)`` at each
step.  Scheduled events (exact ``(kind, shard, step)`` triples) compose
with probabilistic ones; hedged re-dispatches pass ``attempt=1`` so a
hedge never re-rolls the original attempt's fault.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random

KILL = "kill"
SLOW = "slow"
DROP_HEARTBEAT = "drop_heartbeat"
CORRUPT_SNAPSHOT = "corrupt_snapshot"
EVENT_KINDS = (KILL, SLOW, DROP_HEARTBEAT, CORRUPT_SNAPSHOT)


class ShardDead(RuntimeError):
    """Raised (or recorded) when a shard's execution dies mid-batch."""

    def __init__(self, shard: int, step: int):
        super().__init__(f"shard {shard} died at step {step}")
        self.shard = shard
        self.step = step


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One injected fault: what, where, when (and how hard, for slowdowns)."""

    kind: str
    shard: int
    step: int
    factor: float = 1.0   # slowdown multiplier (SLOW only)

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}")


def _draw(seed: int, step: int, shard: int, kind: str, attempt: int) -> float:
    """Uniform [0,1) draw keyed purely by identity — call-order independent.

    ``random.Random`` over a mixed integer seed (not Python ``hash``, which
    is salted for strings) keeps the stream stable across processes.
    """
    mixed = (
        seed * 1_000_003
        + step * 10_007
        + shard * 101
        + EVENT_KINDS.index(kind) * 13
        + attempt * 7_919
    )
    return random.Random(mixed).random()


class ChaosInjector:
    """Seed-driven fault schedule: probabilistic rates + exact events.

    Probabilities are evaluated per ``(step, shard)`` independently for
    each fault kind; ``schedule`` entries fire exactly at their
    ``(kind, shard, step)`` regardless of probabilities.  ``fired`` logs
    every event handed out, in hand-out order, for post-hoc assertions.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        p_kill: float = 0.0,
        p_slow: float = 0.0,
        slow_factor: float = 8.0,
        p_drop_heartbeat: float = 0.0,
        p_corrupt_snapshot: float = 0.0,
        schedule: tuple[ChaosEvent, ...] | list[ChaosEvent] = (),
    ):
        self.seed = seed
        self.p = {
            KILL: p_kill,
            SLOW: p_slow,
            DROP_HEARTBEAT: p_drop_heartbeat,
            CORRUPT_SNAPSHOT: p_corrupt_snapshot,
        }
        self.slow_factor = slow_factor
        self.schedule: list[ChaosEvent] = list(schedule)
        self.fired: list[ChaosEvent] = []

    # ------------------------------------------------------------------
    # schedule helpers (used by the example/benchmark to stage one fault
    # at a known step without touching probabilities)
    # ------------------------------------------------------------------
    def kill(self, shard: int, step: int) -> None:
        self.schedule.append(ChaosEvent(KILL, shard, step))

    def slow(self, shard: int, step: int, factor: float | None = None) -> None:
        self.schedule.append(
            ChaosEvent(SLOW, shard, step, factor or self.slow_factor)
        )

    def corrupt_snapshot(self, shard: int, step: int) -> None:
        self.schedule.append(ChaosEvent(CORRUPT_SNAPSHOT, shard, step))

    # ------------------------------------------------------------------
    def fires(
        self, step: int, shard: int, kind: str, *, attempt: int = 0
    ) -> ChaosEvent | None:
        """The fault of ``kind`` hitting (step, shard), or None.

        Deterministic: same injector state + same arguments -> same answer.
        ``attempt`` distinguishes hedged re-dispatches from the original
        attempt (a hedge escapes the original's slowdown, as a re-dispatch
        to a different worker would).
        """
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown chaos kind {kind!r}")
        for ev in self.schedule:
            if (
                ev.kind == kind and ev.shard == shard and ev.step == step
                and attempt == 0
            ):
                self.fired.append(ev)
                return ev
        p = self.p[kind]
        if p > 0.0 and _draw(self.seed, step, shard, kind, attempt) < p:
            ev = ChaosEvent(
                kind, shard, step,
                self.slow_factor if kind == SLOW else 1.0,
            )
            self.fired.append(ev)
            return ev
        return None

    def events(self, step: int, shard: int) -> list[ChaosEvent]:
        """All faults hitting (step, shard) — test/debug convenience."""
        out = []
        for kind in EVENT_KINDS:
            ev = self.fires(step, shard, kind)
            if ev is not None:
                out.append(ev)
        return out

    def summary(self) -> dict:
        by_kind: dict[str, int] = {}
        for ev in self.fired:
            by_kind[ev.kind] = by_kind.get(ev.kind, 0) + 1
        return {"fired": len(self.fired), "by_kind": by_kind}


def corrupt_snapshot_dir(directory) -> int:
    """Garble every snapshot manifest under ``directory`` (recursively).

    Physically exercises the restore-corruption path: a manifest that no
    longer parses as the expected JSON must make ``restore`` adopt nothing
    (and recovery fall back to a rebuild), never crash the server.
    Returns the number of manifests corrupted.
    """
    n = 0
    for root, _dirs, files in os.walk(str(directory)):
        for fname in files:
            if fname.endswith(".json"):
                path = os.path.join(root, fname)
                with open(path, "w") as f:
                    f.write("{corrupt" + json.dumps({"x": 1}))
                n += 1
    return n
