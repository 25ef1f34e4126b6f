"""Shared helpers of the examples' tests (``tests/test_torch_examples*.py``):
the port's ``examples/torch_<name>.py`` run in this process on the CPU,
the JAX package's ``examples/<name>.py`` in a subprocess."""
from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def load(name: str):
    """A fresh module of ``examples/<name>.py`` (its module-level constants,
    such as ``TINY``, read the environment anew)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_port(name: str, *argv: str, device: str | None = "cpu",
             tiny: bool = False) -> tuple[int, str]:
    """(exit code, standard output) of the port's example ``name`` run by
    its ``main`` with ``--device device`` (its default for None), on one
    thread (small products on many threads spend more time waking them
    than computing); ``tiny`` sets ``REPRO_BENCH_TINY`` for the run."""
    threads = torch.get_num_threads()
    tiny_was = os.environ.get("REPRO_BENCH_TINY")
    out = io.StringIO()
    torch.set_num_threads(1)
    if tiny:
        os.environ["REPRO_BENCH_TINY"] = "1"
    try:
        with contextlib.redirect_stdout(out):
            rc = load(f"torch_{name}").main(
                [*argv] if device is None else ["--device", device, *argv])
    finally:
        torch.set_num_threads(threads)
        if tiny_was is None:
            os.environ.pop("REPRO_BENCH_TINY", None)
        else:
            os.environ["REPRO_BENCH_TINY"] = tiny_was
    return rc, out.getvalue()


def lower_priority() -> None:
    """A reference subprocess yields the cores to the tests running beside
    it (some of them time their steps)."""
    os.nice(10)


def start_reference(name: str, *argv: str) -> subprocess.Popen:
    """The JAX package's example ``name`` at its CI smoke sizes, started at
    a lower priority."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               REPRO_BENCH_TINY="1")
    return subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}.py"), *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=lower_priority)


def finish(proc: subprocess.Popen, timeout: float = 240) -> str:
    """A started reference example's standard output; it must exit 0."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def lines(text: str, prefix: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]
