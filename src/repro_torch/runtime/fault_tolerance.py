"""Fault-tolerant training supervisor: heartbeats, checkpoint/restart and
approximation-based straggler mitigation; the port of
``src/repro/runtime/fault_tolerance.py``, with the same metric and span
names.

This is the control plane run around the train step.  Hardware failure is
simulated through `FailureInjector` so the recovery paths are actually
exercised by tests:

  * node failure     -> restore latest checkpoint and resume from the
                        recorded step (sample-exact data pipeline);
                        re-meshing onto the surviving devices waits for
                        the port's ``parallel/``;
  * straggler        -> the AccurateML knob: shrink the
                        straggling shard's refinement budget eps via
                        core.budget.CostModel instead of re-executing —
                        a degraded-accuracy, on-time answer (the paper's
                        trade-off applied to the runtime);
  * slow save        -> async checkpointing already bounds the bubble.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.core.budget import BudgetPolicy, CostModel
from repro_torch.checkpoint import Checkpointer
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import current_tracer


def emit_shard_event(event: str, shard: int, step: int, **attrs: Any) -> None:
    """Publish one shard lifecycle event (started/straggling/finished).

    Dual-channel: a zero-duration span on the context tracer (so shard
    lifecycle shows up inside whatever trace is being recorded) and a
    labeled counter in the process-wide registry (so BENCH snapshots count
    them even when no tracer is installed).
    """
    current_tracer().event(
        f"shard.{event}", shard=shard, step=step, **attrs
    )
    default_registry().counter(
        "runtime_shard_events_total",
        "Shard lifecycle events seen by the supervisor.",
        labels=("event", "shard"),
    ).labels(event=event, shard=shard).inc()


class FailureInjector:
    """Deterministic failure schedule for tests/examples."""

    def __init__(self, fail_steps: dict[int, str] | None = None):
        self.fail_steps = fail_steps if fail_steps is not None else {}

    def check(self, step: int) -> str | None:
        return self.fail_steps.get(step)


@dataclasses.dataclass
class Heartbeat:
    """Per-shard liveness + progress record (control plane state)."""

    shard: int = 0
    step: int = -1
    t_last: float = 0.0
    alive: bool = True

    def beat(self, step: int):
        if self.step < 0:
            emit_shard_event("started", self.shard, step)
        self.step = step
        self.t_last = time.monotonic()
        self.alive = True


class Supervisor:
    """Runs a step function with checkpoint/restart + straggler policy."""

    def __init__(
        self,
        ckpt: Checkpointer,
        *,
        save_every: int = 50,
        injector: FailureInjector | None = None,
        budget_policy: BudgetPolicy | None = None,
        watch=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ckpt = ckpt
        self.save_every = save_every
        # `is None`, not `or`: a FailureInjector with no scheduled failures
        # is indistinguishable from one the caller passed (and a falsy
        # BudgetPolicy subclass would be silently dropped).
        self.injector = injector if injector is not None else FailureInjector()
        self.budget = (
            budget_policy if budget_policy is not None else BudgetPolicy()
        )
        self.heartbeats: dict[int, Heartbeat] = {}
        self.restarts = 0
        self.straggler_events: list[tuple[int, float]] = []
        # Optional repro_torch.obs.slo.StragglerWatch: each step's measured
        # wall time feeds per-shard latency/skew gauges and straggler alerts.
        self.watch = watch
        self.clock = clock

    # ------------------------------------------------------------------
    def dead_shards(self, timeout_s: float, now: float | None = None) -> list[int]:
        """Shards whose last heartbeat is older than ``timeout_s``.

        Staleness-based liveness: a shard whose beats are dropped (chaos
        ``drop_heartbeat``) or that died goes stale here even though it
        never reported failure.  Marks stale heartbeats ``alive=False``.
        """
        now = now if now is not None else time.monotonic()
        dead = []
        for shard, hb in sorted(self.heartbeats.items()):
            if hb.step >= 0 and now - hb.t_last > timeout_s:
                hb.alive = False
                dead.append(shard)
        return dead

    # ------------------------------------------------------------------
    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Any],
        *,
        start_step: int = 0,
        num_steps: int = 100,
        state_template: Any = None,
        shard: int = 0,
    ) -> tuple[Any, dict]:
        """Drive ``step_fn`` with failure recovery.

        ``step_fn(state, step) -> state``.  On an injected "node_failure"
        the supervisor restores the latest checkpoint and resumes from the
        recorded step (possibly re-sharded by the caller via the restored
        extra metadata).

        ``shard`` is this worker's failure-domain identity: heartbeats,
        straggler events, and the ``runtime_straggler_eps`` gauge all carry
        it, so multi-shard telemetry is real (one Supervisor per shard
        sharing the default registry yields per-shard series, not N
        overwrites of shard 0).
        """
        step = start_step
        while step < num_steps:
            event = self.injector.check(step)
            if event == "node_failure":
                # the injector fires once per schedule entry (pop BEFORE
                # restore — the restored step counter rewinds past it)
                self.injector.fail_steps.pop(step, None)
                # lose in-memory state; restore from disk
                self.restarts += 1
                template = state_template if state_template is not None \
                    else state
                state, extra = self.ckpt.restore(template)
                step = int(extra.get("step", 0))
                continue
            if event == "straggler":
                # approximation-based mitigation: cut eps for this shard
                model = CostModel(c_stage1=1e-6, c_stage2=1e-6)
                eps = self.budget.shard_eps(model, 10_000, 0.5)
                self.straggler_events.append((step, eps))
                emit_shard_event("straggling", shard, step, eps=eps)
                # Meter the shrunk grant so the degraded-accuracy knob is a
                # dashboard series, not only a span attribute.
                default_registry().gauge(
                    "runtime_straggler_eps",
                    "Refinement eps granted to a straggling shard "
                    "(approximation-based mitigation).",
                    labels=("shard",),
                ).labels(shard=shard).set(eps)
                self.injector.fail_steps.pop(step, None)

            t0 = self.clock()
            state = step_fn(state, step)
            dt = self.clock() - t0
            hb = self.heartbeats.setdefault(shard, Heartbeat(shard=shard))
            hb.beat(step)
            if self.watch is not None:
                self.watch.beat(shard, step, dt)
            step += 1
            if step % self.save_every == 0 or step == num_steps:
                self.ckpt.save(
                    step, state, extra={"step": step}, blocking=True
                )
        for hb in self.heartbeats.values():
            emit_shard_event("finished", hb.shard, hb.step)
        return state, {
            "restarts": self.restarts,
            "stragglers": self.straggler_events,
            "final_step": step,
        }
