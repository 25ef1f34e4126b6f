"""Fixtures of the benchmark's CPU tests: cells cut to a tiny size, run
through the program's plain versions on the CPU."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench import cells

TINY = {
    "knn-mfeat": dict(n_points=6000, n_features=16, n_classes=4,
                      modes_per_class=6, compression_ratio=30.0,
                      queries_per_job=32, query_batches=4),
    "cf-netflix": dict(n_users=1200, n_items=300, density=0.08,
                       compression_ratio=20.0, users_per_job=32,
                       user_batches=2),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped where "
        "torch.cuda.is_available() is False")


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny runs on one CPU thread: several test workers share the
    cores, and threaded products that wait on each other crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny():
    """A cell of BENCHMARK.json at a tiny size, for a run on the CPU."""
    def make(name: str) -> cells.Cell:
        cell = cells.load(name)
        check = {**cell.workload["check"], "span": 8}
        return dataclasses.replace(
            cell, config={**cell.config, **TINY[cell.workload["config"]]},
            workload={**cell.workload, "check": check, "trace_jobs": 2})
    return make


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
