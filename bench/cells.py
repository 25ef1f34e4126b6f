"""Everything a cell needs, found by name.

``BENCHMARK.json`` (at the root) lists the cells and the metrics; each
cell's parts are files of their own, so that a later change adds a
configuration, a cell or a per-layer metric as new files and edits none:

    bench/workloads/<cell>.json     config, traffic, chips, the check
    bench/configs/<config>.json     the deployment and its driver's name
    bench/traffic/<traffic>.json    the mix its driver module generates
    bench/drivers/<driver>.py       the entry the window drives
    bench/metrics/<metric>.py       one per-layer metric's reader
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict          # bench/workloads/<cell>.json
    config: dict            # bench/configs/<config>.json
    traffic: dict           # bench/traffic/<traffic>.json
    driver: types.ModuleType
    end_to_end: list        # BENCHMARK.json's metric entries for this cell
    per_layer: list
    readers: dict           # per-layer metric name -> its reader module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> types.ModuleType:
    """Import a file by its path (names may hold '.' and '-')."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module      # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def op_kernels(root: Path = ROOT) -> dict[str, tuple]:
    """Each program op's kernel names, from every roofline reader (those
    that name an ``OP``): what the trace reduction attributes by name."""
    out = {}
    for path in sorted((root / "bench" / "metrics").glob("*.py")):
        module = load_module(path, f"bench_metric_{path.stem}")
        if hasattr(module, "OP"):
            out[module.OP] = tuple(module.KERNELS)
    return out


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load(cell: str, root: Path = ROOT) -> Cell:
    bench = root / "bench"
    manifest = read_json(root / "BENCHMARK.json")
    if cell not in [w["name"] for w in manifest["workloads"]]:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    workload = read_json(bench / "workloads" / f"{cell}.json")
    config = read_json(bench / "configs" / f"{workload['config']}.json")
    traffic = read_json(bench / "traffic" / f"{workload['traffic']}.json")
    driver = load_module(bench / "drivers" / f"{config['driver']}.py",
                         f"bench_driver_{config['driver']}")
    per_layer = _for_cell(manifest["per_layer"], cell)
    readers = {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py",
                                      f"bench_metric_{m['name']}")
               for m in per_layer}
    return Cell(cell, workload, config, traffic, driver,
                _for_cell(manifest["end_to_end"], cell), per_layer, readers)
