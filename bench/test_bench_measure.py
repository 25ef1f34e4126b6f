"""The window's statistics and the reduction of a profiler trace."""
from __future__ import annotations

import json

import pytest

from bench import cells, record, stats, trace


def test_window_metrics_take_every_job():
    job_s = [0.020] * 99 + [0.030]
    m = stats.window_metrics(job_s, window_s=2.03)
    assert m["jobs_per_s"] == pytest.approx(100 / 2.03)
    assert m["job_p95_ms"] == pytest.approx(20.0)


def test_one_stall_moves_the_p95_and_the_rate():
    base = [0.020] * 9          # one job in ten lies beyond the p95
    calm = stats.window_metrics(base + [0.020], window_s=0.2)
    stalled = stats.window_metrics(base + [0.500], window_s=0.68)
    assert stalled["job_p95_ms"] == pytest.approx(500.0)
    assert calm["job_p95_ms"] == pytest.approx(20.0)
    assert stalled["jobs_per_s"] < calm["jobs_per_s"]


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def _events():
    """A slice of 100 µs: two ops, a kernel of each, a glue kernel that
    overlaps one of them on another stream, a copy, and a CF compaction
    launched outside any annotation."""
    host, dev = (0, 1), (0, 7)

    def x(cat, name, ts, dur, where, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": where[0], "tid": where[1], "args": args}

    return [
        x("user_annotation", "bench.slice", 1000, 100, host),
        x("gpu_user_annotation", "bench.slice", 1000, 100, dev),
        x("user_annotation", "op:lsh_hash", 1001, 4, host),
        x("cuda_runtime", "cudaLaunchKernel", 1002, 1, host, correlation=1),
        x("kernel", "lsh_kernel(Params)", 1010, 20, dev, correlation=1),
        x("cpu_op", "aten::sort", 1006, 3, host),
        x("cuda_runtime", "cudaLaunchKernel", 1007, 1, host, correlation=2),
        x("kernel", "void at::native::sort_kernel<float>(float*)", 1020, 20,
          dev, correlation=2),
        x("user_annotation", "op:cf_weights", 1050, 5, host),
        x("cuda_runtime", "cudaLaunchKernelExC", 1051, 1, host,
          correlation=3),
        x("kernel", "void cf_weights_kernel<4>(float4 const*)", 1060, 10,
          dev, correlation=3),
        x("cuda_runtime", "cudaMemcpyAsync", 1056, 1, host, correlation=4),
        x("gpu_memcpy", "Memcpy DtoD", 1075, 5, dev, correlation=4),
        x("kernel", "cf_compact_kernel", 1090, 5, dev, correlation=99),
        x("kernel", "refine_compute_kernel", 900, 5, dev, correlation=98),
    ]


def test_trace_busy_is_the_union_and_ops_are_attributed():
    tr = trace.reduce_events(_events(), cells.op_kernels())
    assert tr.window_s == pytest.approx(100e-6)
    # [1010, 1040] (two kernels overlap), [1060, 1070], [1075, 1080],
    # [1090, 1095]; the kernel before the slice is left out.
    assert tr.busy_s == pytest.approx(50e-6)
    ops = {trace.base_name(d.name): d.op for d in tr.device}
    assert ops == {"lsh_kernel": "lsh_hash", "sort_kernel": None,
                   "cf_weights_kernel": "cf_weights", "Memcpy DtoD": None,
                   "cf_compact_kernel": None}   # two ops own that name
    gaps = dict((label, s) for s, label in tr.gaps)
    assert gaps["op:lsh_hash"] == pytest.approx(10e-6)
    assert gaps["op:cf_weights"] == pytest.approx(20e-6)
    assert gaps["after the last launch"] == pytest.approx(5e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("lsh_kernel")
    assert len(bd["idle_gaps"]) <= 10


def test_readers_on_the_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    tr = trace.reduce_file(path, cells.op_kernels())
    rec = record.Record(tr, jobs=2, launches=[("lsh_hash", 0.0, 3.35e7),
                                              ("lsh_hash", 0.0, 3.35e7)],
                        job_flops=67e9, job_s=0.1)
    read = {p.stem: cells.load_module(p, f"t_{p.stem}").read
            for p in (cells.BENCH / "metrics").glob("*.py")}
    assert read["device_idle_share"](rec) == pytest.approx(50.0)
    assert read["device_kernels_per_job"](rec) == pytest.approx(2.0)
    # the sort, the copy and the compaction: 30 µs over 2 jobs
    assert read["glue_device_ms"](rec) == pytest.approx(0.015)
    # 2 x 10 µs at 3.35 TB/s over 20 µs of lsh_kernel
    assert read["lsh_hash_roofline"](rec) == pytest.approx(100.0)
    assert read["job_mfu"](rec) == pytest.approx(1.0)
    assert read["cf_refine_roofline"](rec) is None      # did not run


def test_innermost_interval():
    ivs = [(0, 10, "outer"), (2, 5, "inner"), (6, 8, "second")]
    assert trace.innermost(ivs, [1, 3, 5.5, 7, 11, -1]) == [
        "outer", "inner", "outer", "second", None, None]
