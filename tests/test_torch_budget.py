"""The CostModel/BudgetPolicy pair of the port: the scenarios of
``tests/test_budget.py`` replayed on ``repro_torch.core.budget``, and
parity with the JAX package (equal floats for the same inputs)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import budget as jbudget
from repro.serve import deadline as jdeadline
from repro_torch.core.budget import BudgetPolicy, CostModel
from repro_torch.core.refine import eps_to_budget
from repro_torch.serve import deadline


def test_fit_solve_round_trip():
    """fit() from two probes recovers a model whose solve_eps inverts predict()."""
    true = CostModel(c_fixed=0.0, c_stage1=2e-5, c_stage2=3e-6)
    n, r, eps1 = 10_000, 20.0, 0.25
    t0 = true.predict(n, r, 0.0)
    t1 = true.predict(n, r, eps1)
    fitted = CostModel.fit(n, r, t0, t1, eps1)
    assert math.isclose(fitted.c_stage1, true.c_stage1, rel_tol=1e-9)
    assert math.isclose(fitted.c_stage2, true.c_stage2, rel_tol=1e-9)
    # Round trip: the budget that predict() quotes for an eps solves back
    # to that same eps.
    for eps in (0.0, 0.05, 0.3, 0.9):
        budget = fitted.predict(n, r, eps)
        solved = fitted.solve_eps(n, r, budget, eps_max=1.0)
        assert math.isclose(solved, eps, rel_tol=1e-9, abs_tol=1e-12), (
            eps, solved
        )


def test_fit_with_fixed_cost():
    true = CostModel(c_fixed=1e-3, c_stage1=1e-5, c_stage2=2e-6)
    n, r, eps1 = 5_000, 10.0, 0.5
    fitted = CostModel.fit(
        n, r, true.predict(n, r, 0.0), true.predict(n, r, eps1), eps1,
        t_fixed=true.c_fixed,
    )
    assert math.isclose(fitted.c_stage1, true.c_stage1, rel_tol=1e-9)
    assert math.isclose(fitted.c_stage2, true.c_stage2, rel_tol=1e-9)


def test_solve_eps_clipping():
    m = CostModel(c_fixed=0.0, c_stage1=1e-5, c_stage2=1e-6)
    n, r = 1_000, 10.0
    # Budget dwarfing any refinement cost -> clipped to eps_max.
    assert m.solve_eps(n, r, 1e6, eps_max=0.4) == 0.4
    # Budget below the stage-1 floor -> 0, never negative.
    assert m.solve_eps(n, r, 0.0, eps_max=0.4) == 0.0
    # Degenerate model (no stage-2 cost): all-or-nothing on the spare sign.
    free = CostModel(c_fixed=0.0, c_stage1=1e-5, c_stage2=0.0)
    assert free.solve_eps(n, r, 1.0, eps_max=0.7) == 0.7
    assert free.solve_eps(n, r, -1.0, eps_max=0.7) == 0.0


def test_solve_eps_matches_linear_model():
    m = CostModel(c_fixed=2e-4, c_stage1=5e-6, c_stage2=4e-7)
    n, r = 8_192, 16.0
    budget = m.predict(n, r, 0.12)
    assert math.isclose(
        m.solve_eps(n, r, budget, eps_max=1.0), 0.12, rel_tol=1e-9
    )


def test_should_reexecute_boundary():
    policy = BudgetPolicy(degrade_floor=0.01)
    # Strictly below the floor escalates; at the floor approximation stands.
    assert policy.should_reexecute(0.0099999)
    assert not policy.should_reexecute(0.01)
    assert not policy.should_reexecute(0.5)
    assert policy.should_reexecute(0.0)


def test_shard_eps_respects_eps_max():
    policy = BudgetPolicy(compression_ratio=20.0, eps_max=0.1)
    m = CostModel(c_fixed=0.0, c_stage1=1e-6, c_stage2=1e-7)
    eps = policy.shard_eps(m, 10_000, remaining_budget=100.0)
    assert eps == 0.1
    assert policy.shard_eps(m, 10_000, remaining_budget=0.0) == 0.0


def test_fit_noisy_probe_is_conservative():
    """Headline regression: a non-positive stage-2 probe delta (t_eps1 <=
    t_eps0, pure noise) must not let solve_eps grant eps_max off a cost
    term it never observed — the old `spare >= 0 -> eps_max` answer handed
    a straggler a full-eps grant precisely when it had to degrade."""
    n, r = 10_000, 20.0
    noisy = CostModel.fit(n, r, t_eps0=0.010, t_eps1=0.009, eps1=0.25)
    assert noisy.c_stage2 == 0.0 and not noisy.stage2_fitted
    # Exhausted-but-nonnegative finite budget: conservative zero grant.
    assert noisy.solve_eps(n, r, 100.0, eps_max=0.4) == 0.0
    assert noisy.solve_eps(n, r, 0.0, eps_max=0.4) == 0.0
    assert noisy.solve_eps(n, r, -1.0, eps_max=0.4) == 0.0
    # The re-execution path (unbounded budget) still refines fully.
    assert noisy.solve_eps(n, r, float("inf"), eps_max=0.4) == 0.4
    # Equal probes are just as unobserved as inverted ones.
    assert not CostModel.fit(n, r, 0.01, 0.01, 0.25).stage2_fitted
    # n == 0 gives the fit nothing to divide by: also unfitted.
    assert not CostModel.fit(0, r, 0.01, 0.02, 0.25).stage2_fitted


def test_constructed_zero_stage2_stays_permissive():
    """A *constructed* zero c_stage2 asserts stage 2 is free: the
    all-or-nothing solve on the spare sign is intended behavior there."""
    free = CostModel(c_fixed=0.0, c_stage1=1e-5, c_stage2=0.0)
    assert free.stage2_fitted
    assert free.solve_eps(1_000, 10.0, 1.0, eps_max=0.7) == 0.7
    assert free.solve_eps(1_000, 10.0, -1.0, eps_max=0.7) == 0.0


def test_solve_eps_zero_points():
    """n_points == 0 kills the stage-2 term: all-or-nothing on spare."""
    m = CostModel(c_fixed=1e-4, c_stage1=1e-5, c_stage2=1e-6)
    assert m.solve_eps(0, 10.0, 1.0, eps_max=0.5) == 0.5
    assert m.solve_eps(0, 10.0, 0.0, eps_max=0.5) == 0.0  # spare < 0


def test_eps_to_budget_is_host_side_int():
    """Satellite regression: budget must be a plain Python int (static shape)."""
    b = eps_to_budget(1000, 0.1)
    assert type(b) is int and b == 100
    assert eps_to_budget(1000, 0.0) == 0
    assert eps_to_budget(1000, 0.0001) == 1   # ceil, not floor
    assert eps_to_budget(0, 0.5) == 0


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _probe_cases(seed: int, n: int = 40):
    """Random probe pairs (noisy ones included: t_eps1 <= t_eps0 a fifth
    of the time) and budgets, from a seed."""
    r = np.random.default_rng(seed)
    for _ in range(n):
        n_points = int(r.choice([0, 1, 97, 4096, 2_300_000]))
        ratio = float(r.choice([1.0, 8.0, 20.0, 100.0]))
        t0 = float(r.uniform(1e-4, 0.05))
        t1 = t0 * float(r.uniform(0.8, 6.0))
        eps1 = float(r.choice([0.01, 0.05, 0.25, 0.32]))
        t_fixed = float(r.choice([0.0, 1e-4]))
        budgets = [float(b) for b in r.uniform(-0.01, 0.2, 4)] + [
            float("inf")]
        yield n_points, ratio, t0, t1, eps1, t_fixed, budgets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_and_solve_give_the_reference_floats(seed):
    for n, r, t0, t1, eps1, tf, budgets in _probe_cases(seed):
        got = CostModel.fit(n, r, t0, t1, eps1, t_fixed=tf)
        want = jbudget.CostModel.fit(n, r, t0, t1, eps1, t_fixed=tf)
        assert (got.c_fixed, got.c_stage1, got.c_stage2,
                got.stage2_fitted) == (want.c_fixed, want.c_stage1,
                                       want.c_stage2, want.stage2_fitted)
        for eps in (0.0, 0.01, eps1):
            assert got.predict(n, r, eps) == want.predict(n, r, eps)
        for b in budgets:
            for eps_max in (0.01, 0.25, 1.0):
                assert got.solve_eps(n, r, b, eps_max=eps_max) == \
                    want.solve_eps(n, r, b, eps_max=eps_max)
        pol, jpol = BudgetPolicy(r, 0.25, 0.01), jbudget.BudgetPolicy(
            r, 0.25, 0.01)
        for b in budgets:
            e = pol.shard_eps(got, n, b)
            assert e == jpol.shard_eps(want, n, b)
            assert pol.should_reexecute(e) == jpol.should_reexecute(e)


@pytest.mark.parametrize("seed", [3, 4])
def test_deadline_grants_equal_the_reference(seed):
    """The same fitted model, policy and remaining budgets: equal grants,
    boosts and inverse deadlines."""
    for n, r, t0, t1, eps1, _, budgets in _probe_cases(seed, n=15):
        for eps_max, floor in ((0.32, 0.004), (0.01, 0.005), (0.25, 0.04)):
            ctl = deadline.DeadlineController(
                BudgetPolicy(r, eps_max, floor), ema=0.0)
            jctl = jdeadline.DeadlineController(
                jbudget.BudgetPolicy(r, eps_max, floor), ema=0.0)
            assert ctl.eps_grid == jctl.eps_grid
            ctl.fit_from_probes("k", n, r, t0, t1, eps1)
            jctl.fit_from_probes("k", n, r, t0, t1, eps1)
            for b in budgets:
                assert vars(ctl.grant("k", n, b)) == vars(
                    jctl.grant("k", n, b))
                got = ctl.boost_for_accuracy("k", n, b, base_eps=0.0)
                want = jctl.boost_for_accuracy("k", n, b, base_eps=0.0)
                assert (got is None) == (want is None)
                if got is not None:
                    assert vars(got) == vars(want)
            for eps in ctl.eps_grid:
                assert ctl.deadline_for("k", n, eps) == \
                    jctl.deadline_for("k", n, eps)
