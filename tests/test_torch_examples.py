"""The port's examples (``examples/torch_<name>.py``) on the CPU, each run
by its ``main`` with ``--device cpu``: it returns 0 with its own checks
passing.  ``torch_store_pyramid``'s, ``torch_serve_lm_decode``'s,
``torch_serve_aggregated``'s and ``torch_train_lm``'s lines that do not
depend on the random draws or the clock equal those of the JAX package's
example, run in a subprocess at its CI sizes (``REPRO_BENCH_TINY=1``) and
the test's flags.
The two serving examples' tests are ``test_torch_examples_serving.py``."""
import json
import re

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_examples import finish, lines, run_port, start_reference


SERVE_TOY = ("--knn-points", "2048", "--cf-users", "512", "--batch", "2")
TRAIN_SMALL = ("--steps", "12", "--save-every", "5", "--inject-failure-step",
               "7", "--d-model", "64", "--layers", "2", "--heads", "4",
               "--kv-heads", "2", "--d-ff", "128", "--vocab", "512",
               "--batch", "2", "--seq", "32")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs, started together before the port's (train_lm
    with its checkpoints in a directory of its own, ``procs["ckpt"]``)."""
    ckpt = tmp_path_factory.mktemp("reference_train_lm")
    procs = {name: start_reference(name)
             for name in ("store_pyramid", "serve_lm_decode")}
    procs["serve_aggregated"] = start_reference("serve_aggregated",
                                                *SERVE_TOY)
    procs["train_lm"] = start_reference("train_lm", *TRAIN_SMALL,
                                        "--ckpt-dir", str(ckpt))
    yield procs | {"ckpt": ckpt}
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_quickstart(reference):
    rc, out = run_port("quickstart")
    assert rc == 0
    assert len(lines(out, "exact:")) == 2
    assert len(lines(out, "accurateml r=")) == 5
    assert len(lines(out, "sampled 10%:")) == 2
    acc = [float(m) for m in re.findall(r"acc=([0-9.]+)", out)]
    assert len(acc) == 5 and min(acc) > 0.9


def test_cf_recommend():
    rc, out = run_port("cf_recommend")
    assert rc == 0
    users = lines(out, "user ")
    assert len(users) == 3
    for line in users:
        top = re.findall(r"top-5 \[([0-9, ]+)\]", line)
        assert len(top) == 2 and all(len(t.split(",")) == 5 for t in top)


def test_serve_aggregated_at_toy_scale(reference):
    rc, out = run_port("serve_aggregated", *SERVE_TOY)
    assert rc == 0
    assert "every tight/hopeless request still got its stage-1 answer" in out
    assert len(lines(out, "  knn: c_stage1=")) == 1
    ref = finish(reference["serve_aggregated"])

    def fixed(text):
        """The table's header, each request's name and kind, the SLO
        classes, the stage-1 guarantee and the serving metrics' keys and
        request count: what the fitted costs and the clock do not set."""
        rows = sorted(set(re.findall(r"^ *(\S+) +(knn|cf) +[0-9.]+ms", text,
                                     re.M)))
        summary = json.loads(text.split("serving metrics:\n")[1])
        return (lines(text, "     request kind"), rows,
                re.findall(r"(\S+)=[0-9.]+ms", lines(text, "SLOs")[0]),
                lines(text, "  every tight/hopeless"),
                sorted(summary), summary["n_requests"])

    got = fixed(out)
    assert got == fixed(ref)
    assert len(got[1]) == 4 and got[-1] == 10


def test_train_lm_restarts_from_its_checkpoint(reference, tmp_path):
    rc, out = run_port("train_lm", *TRAIN_SMALL, "--ckpt-dir", str(tmp_path))
    assert rc == 0
    ref = finish(reference["train_lm"])

    def fixed(text):
        """The model's size line, the steps logged and the supervisor's
        report (one restart from the step-5 checkpoint)."""
        return (lines(text, "arch="), re.findall(r"^step +(\d+)", text, re.M),
                re.findall(r"report=(.*)$", text, re.M))

    got = fixed(out)
    assert got == fixed(ref)
    assert got[0][0].startswith("arch=qwen3-8b params~")
    assert got[2] == ["{'restarts': 1, 'stragglers': [], 'final_step': 12}"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        p.name for p in reference["ckpt"].iterdir()) == [
        "LATEST", "step_10", "step_12", "step_5"]


def test_store_pyramid_matches_the_reference(reference):
    rc, out = run_port("store_pyramid")
    assert rc == 0
    ref = finish(reference["store_pyramid"])

    def fixed(text):
        """Each ratio's source and K, the store's counts, the ingest lines,
        the warm start's hit and the bit-identity."""
        keep = []
        for line in text.splitlines():
            if line.startswith("ratio "):
                keep.append(re.sub(r" \([0-9.]+ ms\)", "", line))
            elif line.startswith(("pyramid:", "store:", "appended",
                                  "level0 snapshot:", "restored means")):
                keep.append(line)
            elif line.startswith("warm-start:"):
                keep.append(re.sub(r" in .* cold build\)", "", line))
        return keep

    got = fixed(out)
    assert got == fixed(ref)
    assert len(got) == 15
    assert got[-1].endswith("bit-identical to original build: True")
    assert got[-2].endswith("first request hit=True")


def test_serve_lm_decode_matches_the_reference(reference):
    rc, out = run_port("serve_lm_decode")
    assert rc == 0
    ref = finish(reference["serve_lm_decode"])

    def fixed(text):
        """Each rid's rung at admission and whether it was served (rids
        counted from the run's first: they number a process's requests),
        the degraded answer after the kill, the burst and the final rung."""
        rows = re.findall(r"rid=(\d+) rung@admit=(\d+) (REFUSED|eps)", text)
        keep = [(int(rid) - int(rows[0][0]), rung, how)
                for rid, rung, how in rows]
        keep += re.findall(r"after kill_shard\(0\): (partial_shards=\S+)",
                           text)
        keep += lines(text, "burst of ") + re.findall(
            r"(final shed level: \d+)", text)
        return keep

    got = fixed(out)
    assert got == fixed(ref)
    assert len(got) == 9 and "partial_shards=(0,)" in got


def test_chip_smoke_examples_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s examples phase on the CPU through counting plain
    versions of the kernels (train_lm at the small widths above): every
    example returns 0 and calls exactly the kernels of its
    ``chip_smoke.EXAMPLES`` row, each kernel's calls captured under the
    example's name (observe_serving's beneath its own probe), the probe
    taken out after."""
    from _torch_parity import chip_smoke, plain_kernels

    from repro_torch.kernels import ops

    plain_kernels(monkeypatch)
    cs = chip_smoke()
    small = ["--d-model", "64", "--layers", "2", "--heads", "4",
             "--kv-heads", "2", "--d-ff", "128", "--vocab", "512",
             "--batch", "2", "--seq", "32"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        probe = cs.CaptureProbe(torch, clone=True)
        summary, total = cs.examples_phase(
            torch, ops, cs.Path(cs.__file__).parent, probe, dev="cpu",
            argv={"train_lm": small})
    finally:
        torch.set_num_threads(threads)
    assert ops.get_probe() is None
    assert set(summary) == set(cs.EXAMPLES) | {"phase_s"}
    for name, kernels in cs.EXAMPLES.items():
        assert set(summary[name]["launches"]) == set(kernels), name
        captured = {op for op, calls in probe.calls.items()
                    for key in calls if key[0] == f"example {name}"}
        assert captured == set(kernels), name
        assert summary[name]["shapes_captured"] == sum(
            key[0] == f"example {name}"
            for calls in probe.calls.values() for key in calls)
    assert total["aggregated_attention_decode"] == 0
    assert "'final_step': 30" in summary["train_lm"]["last_line"]
