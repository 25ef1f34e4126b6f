"""A whole run of a cell, past the look for a card, on the CPU at a tiny
size: sound, it comes out correct; with the timed path broken underneath,
by each fault a MapReduce job on one card can have, it does not."""
from __future__ import annotations

import time

import pytest
import torch

from bench import harness

CELLS = ["knn-mfeat.eps0.01", "cf-netflix.eps0.05"]


def _stale(original):
    """Every job returns the first job's answer: the state left unchanged."""
    first = []

    def job(*args, **kwargs):
        if not first:
            first.append(original(*args, **kwargs))
        return first[0]
    return job


def _half(original):
    """Each job maps half of its map tasks and reduces over those alone."""
    def job(data, *args, lsh_params, n_shards, **kwargs):
        half = n_shards // 2
        cut = data.shape[0] * half // n_shards
        rest = [a[:cut] if torch.is_tensor(a) and a.shape[0] == data.shape[0]
                else a for a in args]
        return original(data[:cut], *rest, lsh_params=lsh_params[:half],
                        n_shards=half, **kwargs)
    return job


def _altered(original):
    """Each job's answer altered where it is produced: another class for
    every query (kNN), half a star more for every item (CF)."""
    def job(*args, **kwargs):
        out = original(*args, **kwargs)
        if out.dtype == torch.int32:
            return (out + 1) % kwargs["n_classes"]
        return out + 0.5
    return job


def _run(cell):
    return harness.run_cell(cell, seed=2**33 + 7, seconds=0.3, trace=False,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, _stale, _half, _altered],
                         ids=["sound", "stale", "half", "altered"])
def test_a_run_is_correct_only_when_sound(tiny, monkeypatch, name, fault):
    from repro_torch.apps import cf, knn

    app = knn if name.startswith("knn") else cf
    if fault is not None:
        monkeypatch.setattr(app, "run_accurateml",
                            fault(app.run_accurateml))
    result = _run(tiny(name))
    assert result["correct"] is (fault is None), result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
