"""Accuracy/latency budget controller for the (compression_ratio, eps_max) knobs.

AccurateML's execution time decomposes (paper Fig. 4) into

  T(map) ~= T_lsh + T_agg + T_stage1 + T_stage2
         ~= c_h*N + c_a*N + c_1*N/r + c_2*eps*N          (per map shard)

with T_lsh + T_agg < 5% of a basic task.  This module fits (c_1, c_2) from
two probe runs and then inverts the model: given a wall-clock budget (or a
straggler's *remaining* budget), solve for the largest eps that still meets
it.  This is what turns the paper's static eps_max into the *anytime* knob
used for straggler mitigation: a slow shard degrades eps, not
correctness of the protocol.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CostModel:
    """Linear per-point cost model of one map shard, seconds.

    ``stage2_fitted`` distinguishes a *constructed* zero ``c_stage2``
    (caller asserts stage 2 is free — keep the permissive all-or-nothing
    solve) from a *measured* non-positive stage-2 delta in ``fit`` (probe
    noise gave ``t_eps1 <= t_eps0``: the model learned nothing about
    stage-2 cost and must grant conservatively, never ``eps_max``).
    """

    c_fixed: float = 0.0     # LSH + aggregation + dispatch overhead
    c_stage1: float = 0.0    # per aggregated point
    c_stage2: float = 0.0    # per refined original point
    stage2_fitted: bool = True

    def predict(self, n_points: int, compression_ratio: float, eps: float) -> float:
        k = n_points / max(compression_ratio, 1.0)
        return self.c_fixed + self.c_stage1 * k + self.c_stage2 * eps * n_points

    def solve_eps(
        self, n_points: int, compression_ratio: float, time_budget: float,
        *, eps_max: float = 1.0,
    ) -> float:
        """Largest eps (clipped to [0, eps_max]) whose predicted time fits."""
        k = n_points / max(compression_ratio, 1.0)
        spare = time_budget - self.c_fixed - self.c_stage1 * k
        if self.c_stage2 <= 0 or n_points == 0:
            if not self.stage2_fitted:
                # Degenerate fit: stage-2 cost is unknown, not zero.  An
                # unbounded budget (the re-execution path) may still refine
                # fully; any *finite* budget gets the conservative grant —
                # the old `spare >= 0 -> eps_max` answer handed a straggler
                # a full-eps grant precisely when it had to degrade.
                return eps_max if spare == float("inf") else 0.0
            return eps_max if spare >= 0 else 0.0
        eps = spare / (self.c_stage2 * n_points)
        return float(min(max(eps, 0.0), eps_max))

    @classmethod
    def fit(
        cls,
        n_points: int,
        compression_ratio: float,
        t_eps0: float,
        t_eps1: float,
        eps1: float,
        t_fixed: float = 0.0,
    ) -> "CostModel":
        """Fit from two probes: one run at eps=0 and one at eps=eps1 > 0.

        A non-positive measured stage-2 delta (probe noise) marks the model
        ``stage2_fitted=False`` so ``solve_eps`` cannot grant ``eps_max``
        off a cost term it never observed.
        """
        k = n_points / max(compression_ratio, 1.0)
        delta = t_eps1 - t_eps0
        c_stage1 = max(t_eps0 - t_fixed, 0.0) / max(k, 1.0)
        c_stage2 = max(delta, 0.0) / max(eps1 * n_points, 1.0)
        return cls(
            c_fixed=t_fixed, c_stage1=c_stage1, c_stage2=c_stage2,
            stage2_fitted=delta > 0.0 and eps1 * n_points > 0,
        )


@dataclasses.dataclass
class BudgetPolicy:
    """Cluster-level policy: target job latency -> per-shard (r, eps).

    ``degrade_floor`` bounds how far a straggling shard may cut eps before
    the runtime escalates to re-execution (fault path) instead of
    approximation (slow path).
    """

    compression_ratio: float = 20.0
    eps_max: float = 0.1
    degrade_floor: float = 0.01

    def shard_eps(
        self, model: CostModel, n_points: int, remaining_budget: float
    ) -> float:
        eps = model.solve_eps(
            n_points, self.compression_ratio, remaining_budget,
            eps_max=self.eps_max,
        )
        return max(eps, 0.0)

    def should_reexecute(self, eps: float) -> bool:
        """Below the floor, approximation would be worse than re-running."""
        return eps < self.degrade_floor
