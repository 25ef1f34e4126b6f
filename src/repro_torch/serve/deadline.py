"""Deadline controller: per-batch latency SLO -> (compression_ratio, eps).

This is the serving-side inversion of the paper's knobs.  Offline, eps_max
is a static job parameter; online, every batch gets the *largest* eps whose
predicted execution time still fits the most urgent request's remaining
budget (``CostModel.solve_eps``), clipped by ``BudgetPolicy.eps_max``.
Under load the controller therefore degrades eps — the answer gets coarser,
never wrong — and when eps would fall below ``BudgetPolicy.degrade_floor``
it escalates (``should_reexecute``): the request is answered stage-1-only
within its SLO and re-executed at full eps on the fault path.

Granted eps is snapped *down* onto a small grid so ``refine_budget`` (a
static shape) takes a bounded number of values — the serving analogue
of fixed-shape map tasks.

Cost models are fitted per workload from two probe runs at startup
(``CostModel.fit``) and corrected online with a multiplicative EMA from
observed batch wall times, so a mis-calibrated probe converges instead of
persistently over- or under-granting.
"""
from __future__ import annotations

import bisect
import dataclasses

from repro_torch.core.budget import BudgetPolicy, CostModel
from repro_torch.core.refine import eps_to_budget

# Default eps grid: 0 plus a geometric ladder up to 1.  Snapping down keeps
# grants conservative (never exceed the solved eps).
EPS_GRID = (
    0.0, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64, 1.0,
)


@dataclasses.dataclass(frozen=True)
class Grant:
    """What the controller gives one batch."""

    compression_ratio: float
    eps: float               # granted refinement fraction (grid-snapped)
    refine_budget: int       # ceil(eps * n_points) — static stage-2 shape
    escalate: bool           # eps below the policy floor -> re-execute
    predicted_s: float       # model-predicted batch execution time


class DeadlineController:
    """Maps (workload, remaining budget) to a Grant via CostModel/BudgetPolicy."""

    def __init__(
        self,
        policy: BudgetPolicy | None = None,
        *,
        eps_grid: tuple[float, ...] = EPS_GRID,
        safety: float = 0.9,
        ema: float = 0.3,
        load_signal=None,
    ):
        self.policy = policy if policy is not None else BudgetPolicy()
        # eps_max must be on the grid so full-eps grants (re-execution,
        # uncalibrated startup) are not silently snapped down.
        self.eps_grid = tuple(sorted(set(eps_grid) | {self.policy.eps_max}))
        self.safety = safety          # fraction of the budget we dare plan for
        self.ema = ema                # weight of each new observed/predicted ratio
        # Optional repro_torch.obs.slo.LoadSignal: when set, the correction is a
        # windowed quantile of recent observed/predicted ratios instead of
        # the per-batch EMA (one outlier ages out of the window instead of
        # decaying through every later grant).
        self.load_signal = load_signal
        self.models: dict[str, CostModel] = {}
        self._correction: dict[str, float] = {}

    # ------------------------------------------------------------------
    def set_model(self, kind: str, model: CostModel) -> None:
        self.models[kind] = model
        self._correction.setdefault(kind, 1.0)

    def fit_from_probes(
        self, kind: str, n_points: int, compression_ratio: float,
        t_eps0: float, t_eps1: float, eps1: float, *, t_fixed: float = 0.0,
    ) -> CostModel:
        model = CostModel.fit(n_points, compression_ratio, t_eps0, t_eps1,
                              eps1, t_fixed=t_fixed)
        self.set_model(kind, model)
        return model

    def snap_eps(self, eps: float) -> float:
        """Largest grid value <= eps (0.0 if eps is below the whole grid)."""
        i = bisect.bisect_right(self.eps_grid, eps)
        return self.eps_grid[i - 1] if i > 0 else 0.0

    # ------------------------------------------------------------------
    def grant(
        self, kind: str, n_points: int, remaining_budget_s: float,
        *, stage1_passes: int = 2,
    ) -> Grant:
        """Largest safe (grid) eps for a batch with ``remaining_budget_s`` left.

        ``stage1_passes=2`` charges the anytime path honestly: the server
        runs stage 1 once for the immediate answer and again inside the
        refined two-stage trace, so the solvable budget excludes both.
        """
        model = self.models.get(kind)
        policy = self.policy
        if model is None:
            # Uncalibrated: grant full eps (nothing to solve against).
            eps = self.snap_eps(policy.eps_max)
            return Grant(
                compression_ratio=policy.compression_ratio,
                eps=eps,
                refine_budget=eps_to_budget(n_points, eps),
                escalate=False,
                predicted_s=0.0,
            )

        corr = self._correction.get(kind, 1.0)
        budget = remaining_budget_s * self.safety / max(corr, 1e-9)
        # Reserve the extra stage-1 passes beyond the one solve_eps models.
        t_stage1 = model.predict(n_points, policy.compression_ratio, 0.0)
        budget -= (stage1_passes - 1) * t_stage1
        # Escalation is decided on the *snapped* eps: snapping only moves
        # down, so a solved eps just above the floor can land below it (or
        # at 0) — that outcome must re-execute, not silently skip stage 2.
        eps = self.snap_eps(policy.shard_eps(model, n_points, budget))
        escalate = policy.should_reexecute(eps)
        if escalate:
            eps = 0.0
        predicted = corr * (
            model.predict(n_points, policy.compression_ratio, eps)
            + (stage1_passes - 1) * t_stage1
        )
        return Grant(
            compression_ratio=policy.compression_ratio,
            eps=eps,
            refine_budget=eps_to_budget(n_points, eps),
            escalate=escalate,
            predicted_s=predicted,
        )

    def boost_for_accuracy(
        self, kind: str, n_points: int, remaining_budget_s: float,
        *, base_eps: float,
    ) -> Grant | None:
        """Accuracy-SLO escalation: refine *past* the default grant.

        Called after stage 1 when a request's claimed ``ErrorBound`` missed
        its ``max_error``: solve for the largest grid eps the remaining
        deadline slack still affords, with the ceiling lifted from
        ``policy.eps_max`` to the top of the grid (the latency knob yields
        to the accuracy knob, but only inside the deadline).  Returns None
        when uncalibrated or when nothing strictly above ``base_eps`` fits
        — the caller keeps the original grant.

        No ``stage1_passes`` reservation here: stage 1 already ran, and
        ``solve_eps`` models exactly the one remaining two-stage pass.
        """
        model = self.models.get(kind)
        if model is None:
            return None
        policy = self.policy
        corr = self._correction.get(kind, 1.0)
        budget = remaining_budget_s * self.safety / max(corr, 1e-9)
        eps = self.snap_eps(model.solve_eps(
            n_points, policy.compression_ratio, budget,
            eps_max=self.eps_grid[-1],
        ))
        if eps <= base_eps:
            return None
        predicted = corr * model.predict(
            n_points, policy.compression_ratio, eps
        )
        return Grant(
            compression_ratio=policy.compression_ratio,
            eps=eps,
            refine_budget=eps_to_budget(n_points, eps),
            escalate=False,
            predicted_s=predicted,
        )

    def deadline_for(
        self, kind: str, n_points: int, eps: float, *, stage1_passes: int = 2,
    ) -> float:
        """Inverse of ``grant``: smallest remaining budget that yields ``eps``.

        Handy for demos/tests that want deadlines provably mapping to a
        given grant.  Requires a fitted model.
        """
        model = self.models[kind]
        corr = self._correction.get(kind, 1.0)
        t_stage1 = model.predict(n_points, self.policy.compression_ratio, 0.0)
        needed = (
            model.predict(n_points, self.policy.compression_ratio, eps)
            + (stage1_passes - 1) * t_stage1
        )
        return needed * corr / self.safety

    def observe(self, kind: str, predicted_s: float, observed_s: float) -> None:
        """Correct the model from one batch's actual wall time.

        With a ``load_signal`` attached the batch's observed/predicted pair
        feeds the windowed quantile and the correction is read back from
        it.  Otherwise the original EMA path: each update's ratio is
        clamped so a single outlier batch (GC pause, page fault, a compile
        the server failed to filter) cannot blow up the correction;
        persistent drift still converges.
        """
        if predicted_s <= 0.0 or observed_s <= 0.0:
            return
        if self.load_signal is not None:
            self.load_signal.observe(kind, predicted_s, observed_s)
            self._correction[kind] = self.load_signal.correction(kind)
            return
        ratio = min(max(observed_s / predicted_s, 0.25), 4.0)
        old = self._correction.get(kind, 1.0)
        self._correction[kind] = (1.0 - self.ema) * old + self.ema * old * ratio

    def correction(self, kind: str) -> float:
        return self._correction.get(kind, 1.0)
