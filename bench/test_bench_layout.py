"""BENCHMARK.json, the files each cell is found by, the imports of what
the benchmark runs, and a run where there is no card."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench import cells

MANIFEST = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_by_name(name):
    cell = cells.load(name)
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    for key in ("config", "traffic", "chips", "why"):
        assert cell.workload[key] == entry[key], key
    assert cell.config["name"] == entry["config"]
    assert hasattr(cell.driver, "run") and hasattr(cell.driver, "reference")
    assert {m["name"] for m in cell.per_layer} == set(cell.readers)
    assert cell.per_layer and len(cell.end_to_end) >= 2


def test_roofline_readers_name_the_kernels_of_their_sources():
    csrc = cells.ROOT / "src" / "repro_torch" / "csrc"
    text = re.sub(r"//[^\n]*", "", "".join(
        p.read_text() for p in csrc.glob("*.cu*")))
    declared = set(re.findall(
        r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(", text))
    for op, names in cells.op_kernels().items():
        assert names and set(names) <= declared, op


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    shutil.copytree(cells.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    cell = json.loads((cells.BENCH / "workloads" /
                       "knn-mfeat.eps0.01.json").read_text())
    cell.update(name="knn-mfeat.eps0.02", traffic="eps0.02")
    (tmp_path / "bench" / "workloads" / "knn-mfeat.eps0.02.json").write_text(
        json.dumps(cell))
    (tmp_path / "bench" / "traffic" / "eps0.02.json").write_text(
        json.dumps({"name": "eps0.02", "eps_max": 0.02}))
    (tmp_path / "bench" / "metrics" / "jobs_traced.py").write_text(
        "def read(record):\n    return record.jobs\n")
    manifest["workloads"].append({"name": "knn-mfeat.eps0.02",
                                  "config": "knn-mfeat",
                                  "traffic": "eps0.02", "chips": 1,
                                  "why": "a wider budget"})
    manifest["per_layer"].append({
        "name": "jobs_traced", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "jobs", "moves": "jobs_per_s",
        "workloads": ["knn-mfeat.eps0.02"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    got = cells.load("knn-mfeat.eps0.02", root=tmp_path)
    assert got.traffic["eps_max"] == 0.02
    assert got.readers["jobs_traced"].read(type("R", (), {"jobs": 3})) == 3
    assert "jobs_traced" not in cells.load("knn-mfeat.eps0.01",
                                           root=tmp_path).readers


def test_benchmark_json_keeps_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and m["command"][1] == "bench/run.py"
    names = [c["name"] for c in m["configs"]]
    assert len(set(names)) == len(names)
    for c in m["configs"]:
        assert NAME.match(c["name"]) and 0 < len(c["why"]) <= 200
        assert (cells.ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/") and c["reduced"] == []
        assert c["name"] in {w["config"] for w in m["workloads"]}
    for w in m["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 0 < len(w["why"]) <= 200 and w["config"] in names
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= x["bound"] <= 0.25 for x in e2e.values())
    for x in m["per_layer"]:
        assert x["moves"] in e2e and set(x["workloads"]) <= set(CELLS)
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in cells.BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
    probe = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "from bench import cells, harness, control\n"
        "for c in cells.load.__globals__['read_json']"
        "('BENCHMARK.json')['workloads']:\n"
        "    cells.load(c['name'])\n"
        "import repro_torch.apps.knn, repro_torch.apps.cf\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_with_no_card_fails_and_prints_no_result(no_card):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout and "metrics" not in out.stdout
    assert "CUDA" in out.stderr
