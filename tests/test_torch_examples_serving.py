"""The port's two serving smoke examples (``examples/torch_observe_serving.py``
and ``examples/torch_chaos_serving.py``) on the CPU at their CI sizes
(``REPRO_BENCH_TINY=1``), each run by its ``main`` with ``--device cpu``
and returning 0, against the JAX package's examples run in a subprocess at
the same sizes: the lines and exports that do not depend on the random
draws or on timing are equal."""
import json
import re

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_examples import finish, lines, run_port, start_reference


@pytest.fixture(scope="module")
def ref_out(tmp_path_factory):
    return tmp_path_factory.mktemp("observe_reference")


@pytest.fixture(scope="module")
def reference(ref_out):
    """The reference's runs, started together before the port's."""
    procs = {"observe_serving": start_reference("observe_serving", "--out",
                                                str(ref_out)),
             "chaos_serving": start_reference("chaos_serving")}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _exports(directory):
    """(span names of every trace, the SLO-missed rids of each flight
    entry kept for them, the fired alerts) of an ``--out`` directory; rids
    counted from the run's first (they number a process's requests)."""
    spans = [json.loads(ln) for ln in
             (directory / "trace.jsonl").read_text().splitlines()]
    names = {sp["name"] for sp in spans}
    first = min(sp["attrs"]["rid"] for sp in spans if "rid" in sp["attrs"])
    flight = [json.loads(ln) for ln in
              (directory / "flight.jsonl").read_text().splitlines()]
    missed = sorted([r - first for r in e["missed_rids"]] for e in flight
                    if e["reason"] == "slo_missed")
    counters = json.loads((directory / "metrics.json").read_text())[
        "process"]["counters"]
    fired = sorted({e["labels"]["objective"] for e in counters
                    if e["name"] == "slo_alerts_total"
                    and e["labels"].get("transition") == "fired"})
    return names, missed, fired


def test_observe_serving_matches_the_reference(reference, ref_out,
                                               tmp_path):
    rc, out = run_port("observe_serving", "--out", str(tmp_path), tiny=True)
    assert rc == 0
    ref = finish(reference["observe_serving"])
    got, want = _exports(tmp_path), _exports(ref_out)
    # The port's served map tasks also open their stage spans
    # (repro_torch.obs.trace), which the reference has not.
    assert got[0] == want[0] | {"map.stage1", "map.select", "map.refine"}
    assert got[1:] == want[1:]
    names, missed, fired = got
    assert {"serve.batch", "stage2.refine", "slo.alert"} <= names
    assert missed and "deadline_met" in fired
    assert lines(out, "slo alerts:") == lines(ref, "slo alerts:")
    assert lines(out, "obs smoke:") == lines(ref, "obs smoke:")


def test_chaos_serving_matches_the_reference(reference):
    rc, out = run_port("chaos_serving", tiny=True)
    assert rc == 0
    ref = finish(reference["chaos_serving"])

    def fixed(text):
        """The healthy and burst phases, the front door's counts and shed
        before reject, kills and recoveries, every rid answered, the final
        smoke line (hedges, the partial count and the final rung are
        timing's)."""
        fleet = json.loads(lines(text, "fleet:")[0].split(" ", 1)[1])
        door = json.loads(lines(text, "front door:")[0].split(" ", 2)[2])
        answers = re.sub(r"; \d+ partial.*", "", lines(text, "answers:")[0])
        return (lines(text, "healthy:"), lines(text, "burst:"),
                {k: door[k] for k in ("admitted", "rejected",
                                      "shed_before_reject")}, answers,
                {k: fleet[k] for k in ("n_shards", "state", "kills",
                                       "recoveries")},
                lines(text, "chaos smoke:"))

    got = fixed(out)
    assert got == fixed(ref)
    assert got[3].endswith(" 0 unanswered")
    assert got[2]["shed_before_reject"] is True
