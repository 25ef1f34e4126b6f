"""The port stands alone: it imports neither JAX nor the JAX package, and it
runs on the card unless the caller asks for the CPU."""
import ast
import dataclasses
import os
import pkgutil
import shutil
import subprocess
import sys
import tempfile
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import _torch_examples
import _torch_mesh_ranks
import repro_torch
from repro_torch.apps import cf, knn
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import (
    cf_aggregates_from_numpy, knn_aggregates_from_numpy,
    lm_cache_lsh_from_numpy, lm_params_from_numpy, lsh_params_from_numpy,
    store_level0_from_numpy, train_state_from_tree,
)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import (
    make_host_mesh, make_production_mesh, run_ranks,
)
from repro_torch.optim import AdamState
from repro_torch.runtime import sharded_knn
from repro_torch.core import lsh
from repro_torch.models import model as lm
from repro_torch.serve.demo import build_demo_server
from repro_torch.store import StreamingAggregate
from repro_torch.data.synthetic import (
    holdout_split, make_mfeat_like, make_netflix_like,
)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_the_reference():
    modules = _modules()
    assert "repro_torch.apps.knn" in modules and len(modules) >= 41
    for m in ("apps.cf", "configs.qwen3_8b", "models.aggregated_kv",
              "models.model", "serve.lm.engine", "obs.metrics",
              "kernels.agg_refine", "kernels.aggregated_attention",
              "store", "store.pyramid", "store.store", "store.persist",
              "store.ingest", "serve.request", "serve.servable",
              "core.budget", "obs.flight", "obs.probes", "obs.slo",
              "obs.timeseries", "serve.cache", "serve.deadline",
              "serve.demo", "serve.frontdoor", "serve.metrics",
              "serve.scheduler", "serve.server", "serve.lm.servable",
              "tree", "checkpoint", "checkpoint.checkpoint", "runtime",
              "runtime.chaos", "runtime.fault_tolerance", "runtime.shards",
              "optim", "optim.optimizer", "optim.grad_compression",
              "data.pipeline", "launch", "launch.train", "launch.mesh",
              "launch.dryrun",
              "parallel", "parallel.collectives", "parallel.sharding",
              "parallel.pipeline_parallel"):
        assert f"repro_torch.{m}" in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_serve_and_store_hold_only_ported_modules():
    """Every module of the port's ``serve``, ``store``, ``obs``,
    ``runtime``, ``checkpoint``, ``optim``, ``launch`` and ``data``
    packages has its counterpart at the same path in the reference, and
    ``repro_torch.serve`` and ``repro_torch.obs`` export the reference's
    names (``obs`` with the benchmark gate of ``obs/regression.py``)."""
    ref_root = ROOT / "src" / "repro"
    for pkg in ("serve", "store", "obs", "runtime", "checkpoint", "optim",
                "launch", "data"):
        for path in (PORT / pkg).rglob("*.py"):
            rel = path.relative_to(PORT)
            assert (ref_root / rel).exists(), rel
    assert (PORT / "obs" / "regression.py").exists()
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.obs, repro_torch.serve\n"
        "print(sorted(repro_torch.serve.__all__))\n"
        "print(sorted(repro_torch.obs.__all__))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    serve_names, obs_names = out.stdout.strip().splitlines()
    ref_serve = _all_of(ref_root / "serve" / "__init__.py")
    ref_obs = _all_of(ref_root / "obs" / "__init__.py")
    assert serve_names == str(sorted(ref_serve))
    assert obs_names == str(sorted(ref_obs))


def _all_of(path: Path) -> set[str]:
    """The names in a module's ``__all__``, read without importing it."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {path}")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py",
                                       *(ROOT / "tools").glob("torch_*.py"),
                                       *(ROOT / "examples").glob("torch_*.py")]))
def test_no_source_names_jax_or_the_reference(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    text = (ROOT / path).read_text()
    assert "__import__" not in text and "import_module" not in text


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a card, wherever the test runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    x = np.zeros((20, 3), np.float32)
    y = np.zeros(20, np.int32)
    cfg = lsh.LSHConfig(n_hashes=2, n_buckets=4)
    common = dict(k=3, n_classes=2)
    r = np.tile(np.array([[1, 0, 5], [3, 2, 0]], np.float32), (10, 1))
    m = (r > 0).astype(np.float32)
    k4 = np.zeros((4, 3))
    smoke = get_config("qwen3-8b", smoke=True)
    agg = smoke.with_(agg_kv=True, n_layers=1)
    unit = {"norm1": np.ones(64), "norm2": np.ones(64),
            "attn": {"wq": np.zeros((1, 64, 64)), "wk": np.zeros((1, 64, 32)),
                     "wv": np.zeros((1, 64, 32)), "wo": np.zeros((1, 64, 64)),
                     "q_norm": np.ones((1, 16)), "k_norm": np.ones((1, 16))},
            "mlp": {"w_gate": np.zeros((1, 64, 128)),
                    "w_up": np.zeros((1, 64, 128)),
                    "w_down": np.zeros((1, 128, 64))}}
    unit["norm1"], unit["norm2"] = np.ones((1, 64)), np.ones((1, 64))
    tree = {"embed": np.zeros((256, 64)), "final_norm": np.ones(64),
            "lm_head": np.zeros((64, 256)), "head_blocks": {},
            "units": {"b0": unit}, "tail_blocks": {}}
    draws = {"head": {}, "tail": {}, "units": {"b0": {
        "lsh_a": np.zeros((1, 32, 4)), "lsh_b": np.zeros((1, 4))}}}
    state = {"params": tree, "opt": AdamState(step=np.int32(3), m=tree,
                                              v=tree)}
    return {
        "sharded_knn": lambda **kw: sharded_knn(
            x, y, n_shards=2, n_classes=2, k=3,
            lsh_generators=[torch.Generator(), torch.Generator()],
            **kw).build(5.0),
        "Checkpointer.restore": lambda **kw: _restore(**kw),
        "TokenPipeline": lambda **kw: TokenPipeline(
            smoke, global_batch=2, seq_len=4, **kw).batch_at(0),
        "launch.train.synth_batch": lambda **kw: train.synth_batch(
            torch.Generator(), smoke, batch=1, seq=4, **kw),
        "launch.train.main": lambda **kw: tuple(train.main(
            ["--steps", "1", "--batch", "1", "--seq", "4"]
            + [a for k, v in kw.items() for a in (f"--{k}", v)]).parameters()),
        "train_state_from_tree": lambda **kw: train_state_from_tree(
            state, smoke.with_(n_layers=1), **kw)["opt"],
        "lm.init_params": lambda **kw: tuple(lm.init_params(
            smoke.with_(n_layers=1), torch.Generator(), **kw).parameters()),
        "lm.draw_lsh": lambda **kw: lm.draw_lsh(agg, torch.Generator(),
                                                **kw)[0],
        "lm.init_caches": lambda **kw: lm.init_caches(
            agg, batch=1, s_max=8,
            lsh=lm.draw_lsh(agg, torch.Generator(), device="cpu"), **kw)[0],
        "lm_params_from_numpy": lambda **kw: tuple(lm_params_from_numpy(
            tree, smoke.with_(n_layers=1), **kw).parameters()),
        "lm_cache_lsh_from_numpy": lambda **kw: lm_cache_lsh_from_numpy(
            draws, agg, **kw)[0],
        "cf.run_exact": lambda **kw: cf.run_exact(r, m, r[:2], m[:2], **kw),
        "cf.run_accurateml": lambda **kw: cf.run_accurateml(
            r, m, r[:2], m[:2], compression_ratio=5.0, eps_max=0.1,
            lsh_generator=torch.Generator(), **kw),
        "cf.run_sampled": lambda **kw: cf.run_sampled(
            r, m, r[:2], m[:2], sample_frac=0.5,
            sample_generator=torch.Generator(), **kw),
        "make_netflix_like": lambda **kw: make_netflix_like(
            torch.Generator(), n_users=20, n_items=3, **kw),
        "holdout_split": lambda **kw: holdout_split(torch.Generator(), m,
                                                    **kw),
        "cf_aggregates_from_numpy": lambda **kw: cf_aggregates_from_numpy(
            k4, np.zeros(4), np.arange(20), np.zeros(5), np.zeros(20), k4,
            k4, k4, k4, k4, **kw),
        "run_exact": lambda **kw: knn.run_exact(x, y, x[:2], **common, **kw),
        "run_accurateml": lambda **kw: knn.run_accurateml(
            x, y, x[:2], compression_ratio=5.0, eps_max=0.1,
            lsh_generator=torch.Generator(), **common, **kw),
        "run_sampled": lambda **kw: knn.run_sampled(
            x, y, x[:2], sample_frac=0.5, sample_generator=torch.Generator(),
            **common, **kw),
        "make_mfeat_like": lambda **kw: make_mfeat_like(
            torch.Generator(), n_points=20, n_features=3, **kw),
        "init_lsh": lambda **kw: lsh.init_lsh(torch.Generator(), 3, cfg, **kw),
        "lsh_params_from_numpy": lambda **kw: lsh_params_from_numpy(
            np.zeros((3, 2)), np.zeros(2), n_hashes=2, bucket_width=4.0,
            n_buckets=4, **kw),
        "KNNServable": lambda **kw: knn.KNNServable(
            x, y, n_classes=2, k=3, lsh_generator=torch.Generator(),
            **kw).build(5.0),
        "CFServable": lambda **kw: cf.CFServable(
            r, m, lsh_generator=torch.Generator(), **kw).build(5.0),
        "StreamingAggregate": lambda **kw: tuple(StreamingAggregate(
            lsh.LSHParams(a=torch.zeros(3, 2), b=torch.zeros(2),
                          config=cfg), 3, capacity=4,
            extra_shapes={"h": (2,)}, **kw).live_stats().values()),
        "store_level0_from_numpy": lambda **kw: store_level0_from_numpy(
            {"stats/counts": np.zeros(4), "stats/sums": np.zeros((4, 3)),
             "index/perm": np.arange(20), "index/offsets": np.zeros(5),
             "index/bucket_of": np.zeros(20)}, **kw),
        "build_demo_server": lambda **kw: tuple(
            s.train_x if s.name == "knn" else s.ratings
            for s in build_demo_server(knn_points=64, cf_users=32,
                                       **kw)[0].servables.values()),
        "knn_aggregates_from_numpy": lambda **kw: knn_aggregates_from_numpy(
            np.zeros((4, 3)), np.zeros(4), np.arange(20), np.zeros(5),
            np.zeros(20), np.zeros(4), np.zeros(4), np.zeros(4), **kw),
        "launch.mesh.run_ranks": lambda **kw: run_ranks(
            _torch_mesh_ranks.host_mesh, 1, {"device": "cpu"}, timeout=120,
            **kw),
        "launch.dryrun.allocate_on_card": lambda **kw: (
            dryrun.allocate_on_card("gemma3-1b", "decode_32k", False, **kw)),
        "launch.dryrun.build_cell": lambda **kw: [t for _, _, t in (
            dryrun.build_cell(dryrun.cut_depth(get_config(
                "qwen3-8b", smoke=True)), dryrun.SHAPES["train_4k"], **kw))],
        # each example's exit code, at the tests' sizes
        **{f"examples/torch_{name}.py": partial(_example, name, *argv)
           for name, argv in EXAMPLES.items()},
    }


# what a card-only entry point raises when asked for the CPU
CARD_ONLY = {"launch.dryrun.allocate_on_card": "caching allocator"}
EXAMPLES = {
    "quickstart": (), "cf_recommend": (), "store_pyramid": (),
    "serve_aggregated": ("--knn-points", "2048", "--cf-users", "512",
                         "--batch", "2"),
    "observe_serving": (), "chaos_serving": (), "serve_lm_decode": (),
    "train_lm": ("--steps", "3", "--save-every", "2", "--d-model", "64",
                 "--layers", "2", "--heads", "4", "--kv-heads", "2",
                 "--d-ff", "128", "--vocab", "512", "--batch", "2", "--seq",
                 "32"),
}


def _example(name, *argv, device=None):
    extra = ()
    if name == "train_lm":
        extra = ("--ckpt-dir", tempfile.mkdtemp(prefix="torch_train_lm_"))
    try:
        return _torch_examples.run_port(
            name, *argv, *extra, device=device,
            tiny=name in ("observe_serving", "chaos_serving"))[0]
    finally:
        if extra:
            shutil.rmtree(extra[1], ignore_errors=True)


def _restore(**kw):
    """A checkpoint written from the CPU, restored through a checkpointer
    built with ``kw``."""
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d, device="cpu").save(1, {"w": torch.ones(2)})
        return Checkpointer(d, **kw).restore({"w": torch.zeros(2)})[0]


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_need_the_card_unless_asked_for_the_cpu(no_cuda, name):
    """Each raises without a card, by default and asked for it; asked for
    the CPU, it returns tensors there (an example: its exit code, 0), or,
    measuring the card, refuses."""
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(device="cuda")
    if name in CARD_ONLY:
        with pytest.raises(ValueError, match=CARD_ONLY[name]):
            call(device="cpu")
        return
    out = call(device="cpu")
    if name.startswith("examples/"):
        assert out == 0
        return
    tensors = list(_tensors(out))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(out):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))


def test_meshes_take_the_card_unless_asked_for_the_cpu(no_cuda):
    """``make_host_mesh`` and ``make_production_mesh`` build on the card by
    default and raise where there is none; a rank of ``run_ranks`` does
    likewise, and with ``device="cpu"`` builds a CPU mesh."""
    for make in (make_host_mesh, make_production_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(_torch_mesh_ranks.host_mesh, 1, {}, device="cpu",
                  timeout=120)
    [(shape, kind)] = run_ranks(_torch_mesh_ranks.host_mesh, 1,
                                {"device": "cpu"}, device="cpu",
                                timeout=120)
    assert kind == "cpu" and shape.tolist() == [1]


def test_chip_smoke_refuses_to_run_without_a_card_or_the_repo(tmp_path):
    """No card: exit non-zero and print no result.  A directory that holds
    chip_smoke.py and nothing else of the repository: the same."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, alone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout
