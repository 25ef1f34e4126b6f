"""The traced slice split by the program's stage spans (``bench.stages``)
and the readers of the ``stages`` layer, on hand-built Chrome traces."""
from __future__ import annotations

import json
import os

import pytest

from bench import cells, record, stages, trace

STAGES = ("lsh", "aggregate", "stage1", "select", "refine", "reduce")


def _x(cat, name, ts, dur, where, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": where[0], "tid": where[1], "args": args}


def _events(spans: bool = True, slice_us: int = 100):
    """A slice of 100 µs holding one job: the harness's draw before it,
    four stages launching a kernel or a copy each, the harness's launch
    after it, and the tail.  The harness's ``op:`` annotation and torch's
    ``cpu_op`` ranges lie around the same launches."""
    host, dev = (0, 1), (0, 7)
    ev = [
        _x("user_annotation", "bench.slice", 1000, slice_us, host),
        _x("cuda_runtime", "cudaLaunchKernel", 1002, 1, host, correlation=1),
        _x("kernel", "normal_kernel", 1005, 5, dev, correlation=1),
        _x("user_annotation", "op:lsh_hash", 1013.5, 2, host),
        _x("cpu_op", "aten::sort", 1021.5, 1.5, host),
        _x("cuda_runtime", "cudaLaunchKernel", 1014, 1, host, correlation=2),
        _x("kernel", "lsh_kernel(Params)", 1020, 10, dev, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1022, 1, host, correlation=3),
        _x("kernel", "void at::native::sort_kernel<float>(float*)", 1030,
           15, dev, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 1032, 1, host, correlation=4),
        _x("kernel", "knn_distance_kernel", 1050, 10, dev, correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 1042, 1, host, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoD", 1062, 4, dev, correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", 1085, 1, host, correlation=6),
        _x("kernel", "fill_kernel", 1090, 5, dev, correlation=6),
    ]
    if spans:
        ev += [
            _x("user_annotation", "span:job", 1012, 68, host),
            _x("user_annotation", "span:map.lsh", 1013, 7, host),
            _x("user_annotation", "span:map.aggregate", 1021, 9, host),
            _x("user_annotation", "span:map.stage1", 1031, 9, host),
            _x("user_annotation", "span:reduce", 1041, 38, host),
        ]
    return ev


def _record(tmp_path, monkeypatch, events, name="cell.trace.json"):
    monkeypatch.setattr(stages, "TRACES", tmp_path)
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    tr = trace.reduce_file(path, cells.op_kernels())
    return record.Record(tr, jobs=1, launches=[], job_flops=0.0, job_s=0.1)


def _reader(name):
    path = cells.BENCH / "metrics" / f"{name}.py"
    return cells.load_module(path, f"t_{name}").read


def _readers() -> dict:
    names = [stage + kind for kind in ("_stage_ms", "_stage_idle_ms")
             for stage in STAGES] + ["between_jobs_idle_ms"]
    return {name: _reader(name) for name in names}


def test_the_stages_of_a_hand_built_trace(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, _events())
    got = {name: read(rec) for name, read in _readers().items()}
    assert got == pytest.approx({
        "lsh_stage_ms": 0.010, "aggregate_stage_ms": 0.015,
        "stage1_stage_ms": 0.010, "reduce_stage_ms": 0.004,
        "select_stage_ms": None, "refine_stage_ms": None,
        # gaps: [1010, 1020] ends at lsh_kernel, [1045, 1050] at the
        # stage-1 kernel, [1060, 1062] at the copy
        "lsh_stage_idle_ms": 0.010, "aggregate_stage_idle_ms": 0.0,
        "stage1_stage_idle_ms": 0.005, "reduce_stage_idle_ms": 0.002,
        "select_stage_idle_ms": None, "refine_stage_idle_ms": None,
        # [1000, 1005], [1066, 1090] and the tail [1095, 1100]
        "between_jobs_idle_ms": 0.034,
    })


def test_the_partition_closes_on_the_trace_totals(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, _events())
    split = stages.of(rec)
    assert split.jobs == 1
    assert split.seen == {"job", "map.lsh", "map.aggregate", "map.stage1",
                          "reduce"}
    device = sum(d.end - d.start for d in rec.trace.device) * 1e-6
    assert sum(split.device_s.values()) == pytest.approx(device)
    assert split.device_s[stages.BETWEEN] == pytest.approx(10e-6)
    assert "job" not in split.device_s       # every launch is in a stage
    idle = rec.trace.window_s - rec.trace.busy_s
    assert sum(split.idle_s.values()) == pytest.approx(idle)
    share = _reader("device_idle_share")(rec)
    assert sum(split.idle_s.values()) == pytest.approx(
        share / 100 * rec.trace.window_s)


def test_a_trace_without_spans_reads_none(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, _events(spans=False))
    assert stages.of(rec) is None
    assert all(read(rec) is None for read in _readers().values())
    # the existing readers still read it
    assert _reader("device_idle_share")(rec) == pytest.approx(51.0)


def test_a_slice_of_another_length_reads_none(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, _events(slice_us=120))
    other = _record(tmp_path, monkeypatch, _events(), "other.trace.json")
    os.utime(tmp_path / "other.trace.json", ns=(1, 1))   # the older file
    assert stages.of(rec).window_s == pytest.approx(120e-6)
    assert stages.of(other).window_s == pytest.approx(100e-6)
    (tmp_path / "other.trace.json").unlink()
    assert stages.of(other) is None
    assert all(read(other) is None for read in _readers().values())
