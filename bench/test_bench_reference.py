"""The plain reference jobs against the program's CPU path (its plain
versions of the kernels) on shared data and LSH draws at tiny sizes, and
the control: the reference in TF32 put in the program's place comes out
not correct."""
from __future__ import annotations

import pytest
import torch

from bench import control, harness, judge

CELLS = ["knn-mfeat.eps0.01", "knn-mfeat.eps0", "cf-netflix.eps0.05",
         "cf-netflix.eps0"]
CPU = torch.device("cpu")


def _jobs(cell, seed, n_jobs=3):
    """(state, [(inputs, program output, captured merge)]) of a few jobs."""
    drv = cell.driver
    state = drv.setup(cell.config, cell.traffic, seed, CPU)
    jobs = []
    for j in range(n_jobs):
        probe = harness.Probe(drv.CAPTURE)
        inp, _, out = harness.run_job(cell, state, CPU, "job", j, probe)
        jobs.append((inp, out, probe.captured))
    return state, jobs


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_program_on_the_cpu(tiny, name):
    cell = tiny(name)
    state, jobs = _jobs(cell, seed=2**32 + 11)
    for inp, out, captured in jobs:
        want = cell.driver.reference(state, inp, "float64")
        gap = cell.driver.compare(state, out, captured, want)
        assert torch.isfinite(gap).all()
        assert float(gap.max()) < 2e-5, name


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(tiny, name):
    cell = tiny(name)
    state, jobs = _jobs(cell, seed=2**32 + 12)
    spec = cell.workload["check"]
    gaps = []
    for inp, _, _ in jobs:
        want = cell.driver.reference(state, inp, "float64")
        ctrl = cell.driver.reference(state, inp, "tf32")
        gaps.append(cell.driver.compare(state, *control.control_answer(ctrl),
                                        want))
    ok, checks = judge.verdict(judge.summarize(gaps, spec["row_tol"]),
                               spec["limits"])
    assert not ok, checks


def test_cf_check_takes_an_ambiguous_hash_to_its_other_side(tiny):
    """A job whose answer comes from one neighbour hashed to the other side
    of a boundary matches when that hash is among the ambiguous ones, and
    only then."""
    from bench.reference import cf as ref_cf

    cell = tiny("cf-netflix.eps0.05")
    drv = cell.driver
    state, jobs = _jobs(cell, seed=2**32 + 13, n_jobs=1)
    inp = jobs[0][0]
    want = drv.reference(state, inp, "float64")
    task = want.tasks[1]
    flip = (5, 2, int(task.h[5, 2]) + 1)
    (n1, d1), _ = task.contribution((flip,))
    num = sum(p[0] for p in want.parts) - want.parts[1][0] + n1
    den = sum(p[1] for p in want.parts) - want.parts[1][1] + d1
    out = ref_cf.predict(num, den, want.mean).float()
    assert float(drv.compare(state, out, None, want).max()) > 1e-3
    task.ambiguous.append(flip)
    assert float(drv.compare(state, out, None, want).max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knn-mfeat.eps0.01", "cf-netflix.eps0.05"])
def test_the_tf32_control_on_the_card(tiny, card, name):
    """On the card the control's products run on the tensor cores in TF32;
    the float64 reference there agrees with the CPU's."""
    cell = tiny(name)
    drv = cell.driver
    state = drv.setup(cell.config, cell.traffic, 2**32 + 14, card)
    inp = drv.inputs(state, "job", 0)
    want = drv.reference(state, inp, "float64")
    ctrl = drv.reference(state, inp, "tf32")
    gaps = [drv.compare(state, *control.control_answer(ctrl), want)]
    ok, checks = judge.verdict(
        judge.summarize(gaps, cell.workload["check"]["row_tol"]),
        cell.workload["check"]["limits"])
    assert not ok, checks
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
           for k, v in vars(state).items()}
    cpu_inp = {"rows": inp["rows"],
               "draws": [(a.cpu(), b.cpu()) for a, b in inp["draws"]]}
    on_cpu = drv.reference(type(state)(**{**cpu, "device": CPU}), cpu_inp,
                           "float64")
    got = want.votes if hasattr(want, "votes") else want.pred
    ref = on_cpu.votes if hasattr(on_cpu, "votes") else on_cpu.pred
    assert torch.allclose(got.cpu().double(), ref.double(), atol=1e-9)
