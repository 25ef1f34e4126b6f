"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``src/repro/launch/dryrun.py``): the shape grid, the parameter
counts and the cell configs; the step inputs; one device's bytes of every
argument of all 80 cells against the reference's own spec arithmetic
(``jax.eval_shape`` trees, its ``param_specs``, ``cache_specs``,
``batch_specs`` and ``_guard_spec``, on a stand-in mesh); the arguments a
step never reads against ``jax.jit``'s, and against what the port's own
steps read; and ``argument_size_in_bytes`` against XLA's on two decode
cells, compiled in a subprocess on 256 host devices."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

# The reference's dryrun forces 512 host devices through XLA_FLAGS when it
# is imported; with the backend up first that reaches nothing here, and
# the variable is put back for the processes this worker starts.
jax.devices()
_flags = os.environ.get("XLA_FLAGS")
from repro import optim as joptim  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import active_param_count as jactive  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import param_count as jparam_count  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from _torch_examples import lower_priority  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    SHAPES, active_param_count, get_config, param_count,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
P = jax.sharding.PartitionSpec
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
PAIRS = [(a, s) for a in ARCH_NAMES for s in JSHAPES]


class _Mesh:
    """A stand-in for a ``jax.sharding.Mesh``: its axis names and sizes,
    all that the reference's spec rules and ``_guard_spec`` read."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


# ---------------------------------------------------------------------------
# (a) configs
# ---------------------------------------------------------------------------

def test_shapes_and_parameter_counts_equal_the_reference():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.tokens) == (
            j.name, j.seq_len, j.global_batch, j.kind, j.tokens)
    for arch in ARCH_NAMES:
        for smoke in (False, True):
            cfg, jcfg = get_config(arch, smoke=smoke), jget_config(
                arch, smoke=smoke)
            assert param_count(cfg) == jparam_count(jcfg), arch
            assert active_param_count(cfg) == jactive(jcfg), arch


@pytest.mark.parametrize("variant", [None, "opt"])
def test_cell_configs_equal_the_reference_field_by_field(variant):
    assert dryrun.VARIANTS == jdry.VARIANTS
    for arch, shape in PAIRS:
        got = dataclasses.asdict(dryrun.cell_config(arch, shape, variant))
        want = dataclasses.asdict(jdry.cell_config(arch, shape, variant))
        assert got == want, (arch, shape, variant)


# ---------------------------------------------------------------------------
# (b) input specs
# ---------------------------------------------------------------------------

def test_input_specs_equal_the_references_shape_dtype_structs():
    for arch, shape in PAIRS:
        got = dryrun.input_specs(dryrun.cell_config(arch, shape),
                                 SHAPES[shape])
        want = jdry.input_specs(jdry.cell_config(arch, shape),
                                JSHAPES[shape])
        assert list(got) == list(want), (arch, shape)
        for key, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[key].shape, (arch, shape, key)
            assert str(t.dtype).removeprefix("torch.") == str(
                want[key].dtype), (arch, shape, key)


def test_guard_spec_drops_axes_that_do_not_divide():
    mesh = {"pod": 2, "data": 16, "model": 16}
    jmesh = _Mesh((2, 16, 16), ("pod", "data", "model"))
    Pt = dryrun.P
    for spec, shape in (((("pod", "data"), None), (1, 8)),
                        ((("pod", "data"), "model"), (64, 8)),
                        (("data",), (8,)), (("model", None), (32, 5, 7)),
                        ((None, "data"), (3, 48)), ((), (4, 4))):
        got = dryrun._guard_spec(Pt(*spec), shape, mesh)
        want = jdry._guard_spec(P(*spec), shape, jmesh)
        assert tuple(got) == tuple(want), (spec, shape)
        assert len(got) == len(shape)


# ---------------------------------------------------------------------------
# (c) one device's bytes on all 80 cells
# ---------------------------------------------------------------------------

def _local_bytes(sds, spec, mesh) -> int:
    spec = jdry._guard_spec(spec, sds.shape, mesh)
    n = 1
    for d, ax in zip(sds.shape, spec):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        n *= d // math.prod(mesh.shape[a] for a in axes)
    return n * sds.dtype.itemsize


def _tree_bytes(shapes, specs, mesh) -> int:
    sizes = jax.tree_util.tree_map(
        lambda s, sp: _local_bytes(s, sp, mesh), shapes, specs,
        is_leaf=lambda x: isinstance(x, (jax.ShapeDtypeStruct, P)))
    return sum(jax.tree_util.tree_leaves(sizes))


def reference_bytes(arch: str, shape: str, multi_pod: bool) -> dict:
    """The reference's per-device bytes of the cell's arguments, by
    group, from its own trees and spec rules (no devices, no compile)."""
    cfg, sc = jdry.cell_config(arch, shape), JSHAPES[shape]
    mesh = _Mesh(*MESHES[multi_pod])
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda k: jinit_params(k, cfg), key)
    p_specs = jsharding.param_specs(params, cfg, mesh)
    out = {"params": _tree_bytes(params, p_specs, mesh), "optimizer": 0,
           "batch": 0, "caches": 0}
    if sc.kind == "train":
        opt = jax.eval_shape(joptim.init_state, params)
        out["optimizer"] = _tree_bytes(
            opt, joptim.AdamState(step=P(), m=p_specs, v=p_specs), mesh)
    b_specs = jsharding.batch_specs(cfg, mesh, kind=sc.kind)
    out["batch"] = sum(
        _local_bytes(v, b_specs.get(k, P(*([None] * len(v.shape)))), mesh)
        for k, v in jdry.input_specs(cfg, sc).items())
    if sc.kind == "decode":
        caches = jax.eval_shape(lambda k: jinit_caches(
            k, cfg, batch=sc.global_batch, s_max=sc.seq_len), key)
        out["caches"] = _tree_bytes(
            caches, jsharding.cache_specs(caches, cfg, mesh), mesh)
    return out


@pytest.fixture(scope="module")
def records():
    """The port's 80 records by (arch, shape, mesh)."""
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in dryrun.run_all(save=False)}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_per_device_bytes_equal_the_reference_arithmetic(arch, records):
    """params, optimizer, batch and caches on both meshes and all four
    shapes; the record's other keys as the reference's."""
    for multi in (False, True):
        for shape in JSHAPES:
            rec = records[arch, shape, "2x16x16" if multi else "16x16"]
            want = reference_bytes(arch, shape, multi)
            got = {g: rec["memory"][g] for g in dryrun.GROUPS}
            assert got == want, (arch, shape, multi)
            mem = rec["memory"]
            assert mem["argument_size_in_bytes"] + mem["unused"] == sum(
                want.values())
            cfg = jdry.cell_config(arch, shape)
            assert rec["mesh"] == ("2x16x16" if multi else "16x16")
            assert (rec["kind"], rec["agg_kv"], rec["tokens"],
                    rec["params"], rec["active_params"]) == (
                JSHAPES[shape].kind, cfg.agg_kv, JSHAPES[shape].tokens,
                jparam_count(cfg), jactive(cfg))
            assert "cost" not in rec and "collectives" not in rec
            assert {"cost", "collectives", "compile_seconds"} <= set(
                rec["no_counterpart"])


def test_the_largest_cell_fits_one_card(records):
    """deepseek-7b long_500k on 16 x 16 holds the most on one device:
    its 16-way sequence-sharded KV caches, 15.52 GiB in all."""
    assert len(records) == 80
    sizes = {key: r["memory"]["argument_size_in_bytes"]
             + r["memory"]["unused"] for key, r in records.items()}
    top = max(sizes, key=sizes.get)
    assert top == ("deepseek-7b", "long_500k", "16x16")
    assert round(sizes[top] / 2**30, 2) == 15.52
    assert max(sizes.values()) < 80e9


# ---------------------------------------------------------------------------
# arguments the step never reads
# ---------------------------------------------------------------------------

def _reference_unused(arch: str, shape: str) -> dict:
    """Whole-tensor bytes, by group, of the arguments ``jax.jit`` drops
    from the reference's step (its ``keep_unused=False``: the arguments
    left out of the lowered module), without a mesh."""
    cfg, sc = jdry.cell_config(arch, shape), JSHAPES[shape]
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda k: jinit_params(k, cfg), key)
    batch = jdry.input_specs(cfg, sc)
    if sc.kind == "train":
        args = (params, jax.eval_shape(joptim.init_state, params), batch)
        step = jtrain.make_train_step(cfg, joptim.AdamWConfig())
        groups = ("params", "optimizer", "batch")
    elif sc.kind == "prefill":
        args, step = (params, batch), jtrain.make_prefill_step(cfg)
        groups = ("params", "batch")
    else:
        caches = jax.eval_shape(lambda k: jinit_caches(
            k, cfg, batch=sc.global_batch, s_max=sc.seq_len), key)
        args, step = (params, caches, batch), jtrain.make_serve_step(cfg)
        groups = ("params", "caches", "batch")
    kept = jax.jit(step).lower(*args)._lowering.compile_args["kept_var_idx"]
    out = dict.fromkeys(dryrun.GROUPS, 0)
    i = 0
    for group, tree in zip(groups, args):
        for leaf in jax.tree_util.tree_leaves(tree):
            if i not in kept:
                out[group] += math.prod(leaf.shape) * leaf.dtype.itemsize
            i += 1
    return out


def _port_unused(arch: str, shape: str) -> dict:
    cfg = dryrun.cell_config(arch, shape)
    leaves = dryrun.cell_leaves(cfg, SHAPES[shape], {"data": 1, "model": 1})
    out = dict.fromkeys(dryrun.GROUPS, 0)
    for lf in leaves:
        if not lf.used:
            out[lf.group] += math.prod(lf.shape) * lf.dtype.itemsize
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_unused_arguments_are_those_jit_drops(arch):
    """Every decode and prefill cell, and whisper-tiny's train cell (its
    encoder blocks carry cross-attention weights the encoder never
    applies, which the update reads all the same)."""
    shapes = ["prefill_32k", "decode_32k", "long_500k"]
    if arch == "whisper-tiny":
        shapes.append("train_4k")
    for shape in shapes:
        assert _port_unused(arch, shape) == _reference_unused(arch, shape), (
            arch, shape)


class _Reads(torch.utils._python_dispatch.TorchDispatchMode):
    """The storages of every tensor an operation takes."""

    def __init__(self):
        super().__init__()
        self.storages = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in torch.utils._pytree.tree_leaves((args, kwargs or {})):
            if isinstance(t, torch.Tensor):
                self.storages.add(t.untyped_storage().data_ptr())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,kind,agg", [
    ("whisper-tiny", "decode", False), ("whisper-tiny", "prefill", False),
    ("xlstm-350m", "decode", False), ("qwen2-vl-2b", "decode", True),
    ("qwen2-vl-2b", "decode", False), ("qwen3-8b", "decode", True),
    ("zamba2-7b", "decode", True),
])
def test_unused_arguments_are_those_the_ports_step_never_reads(arch, kind,
                                                                agg):
    """The port's own step, at the smoke widths on the CPU: the parameters
    and batch entries no operation takes are those ``_unused`` names."""
    cfg = get_config(arch, smoke=True).with_(agg_kv=agg, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    model = model_lib.init_params(cfg, gen, device="cpu")
    params = model_lib.param_tree(model)
    b, s = 2, 8
    batch = train.synth_batch(gen, cfg, batch=b, seq=s, device="cpu")
    with torch.no_grad():
        if kind == "prefill":
            batch.pop("labels")
            step = train.make_prefill_step(cfg)
            with _Reads() as reads:
                step(model, batch)
        else:
            caches = model_lib.init_caches(
                cfg, batch=b, s_max=s, device="cpu",
                lsh=model_lib.draw_lsh(cfg, gen, device="cpu"))
            batch = {"tokens": batch["tokens"][:, :1],
                     "pos": torch.zeros(b, dtype=torch.int32)}
            if cfg.mrope:
                batch["mrope_positions"] = torch.zeros((3, b, 1),
                                                       dtype=torch.int32)
            step = train.make_serve_step(cfg)
            with _Reads() as reads:
                step(model, caches, batch)
    unread = {("params", n) for n, t in params.items()
              if t.untyped_storage().data_ptr() not in reads.storages}
    unread |= {("batch", k) for k, t in batch.items()
               if t.untyped_storage().data_ptr() not in reads.storages}
    want = {(g, n) for g, items in (("params", params), ("batch", batch))
            for n in items if dryrun._unused(cfg, kind, g, n)}
    assert unread == want


# ---------------------------------------------------------------------------
# (d), (e) XLA's count, in a subprocess on 256 host devices
# ---------------------------------------------------------------------------

XLA_CELLS = (("gemma3-1b", "decode_32k"), ("whisper-tiny", "decode_32k"))
FAILING_CELLS = (("whisper-tiny", "train_4k"), ("xlstm-350m", "prefill_32k"))


@pytest.fixture(scope="module")
def xla():
    """``tests/_torch_dryrun_reference.py``'s four cells."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256")
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_reference.py")],
        env=env, capture_output=True, text=True, timeout=300,
        preexec_fn=lower_priority)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_argument_bytes_equal_xlas_on_two_decode_cells(xla):
    """gemma3-1b reads every argument; whisper-tiny's decode step never
    reads its encoder nor the cross-attention's K and V projections,
    which XLA leaves out (784,128 bytes a device)."""
    want = {"gemma3-1b decode_32k": 89_794_368,
            "whisper-tiny decode_32k": 202_127_680}
    for arch, shape in XLA_CELLS:
        key = f"{arch} {shape}"
        assert xla[key] == want[key]
        rec = dryrun.run_cell(arch, shape, False, save=False, verbose=False)
        assert rec["memory"]["argument_size_in_bytes"] == xla[key]
    whisper = dryrun.run_cell("whisper-tiny", "decode_32k", False,
                              save=False, verbose=False)
    assert whisper["memory"]["unused"] == 784_128


def test_reference_train_and_prefill_cells_fail_on_this_jax(xla):
    """jax 0.9.0's explicit-axis meshes refuse the reference's
    ``with_sharding_constraint`` in its train and prefill steps; the
    port's bytes there are held against the reference's arithmetic."""
    for arch, shape in FAILING_CELLS:
        assert "can only refer to Auto axes of the mesh" in xla[
            f"{arch} {shape}"], xla
        rec = dryrun.run_cell(arch, shape, False, save=False, verbose=False)
        assert {g: rec["memory"][g] for g in dryrun.GROUPS} == \
            reference_bytes(arch, shape, False)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_writes_every_cell_without_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["--all"]) == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 80
    rec = json.loads((tmp_path / "qwen3-8b__decode_32k__multi.json")
                     .read_text())
    assert rec["mesh"] == "2x16x16"
    # existing records are read back, not recomputed
    (tmp_path / "qwen3-8b__decode_32k__multi.json").write_text(
        json.dumps({"arch": "kept"}))
    recs = dryrun.run_all(archs=["qwen3-8b"], shapes=["decode_32k"],
                          meshes=("multi",))
    assert recs == [{"arch": "kept"}]
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "long_500k",
                        "--variant", "opt"]) == 0
    assert (tmp_path / "gemma3-1b__long_500k__single__opt.json").exists()


def test_cli_refuses_to_calibrate(capsys):
    assert dryrun.main(["--calibrate", "--arch", "qwen3-8b", "--shape",
                        "train_4k"]) != 0
    assert "no counterpart" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the stand-ins against the tensors the port allocates
# ---------------------------------------------------------------------------

def _small_cell(arch, shape_name):
    """The cell at the arch's small widths and a cut depth, 2 sequences
    of 256 tokens."""
    cfg = get_config(arch, smoke=True).with_(
        agg_kv=dryrun.cell_config(arch, shape_name).agg_kv)
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=256,
                                global_batch=min(
                                    SHAPES[shape_name].global_batch, 2))
    return dryrun.cut_depth(cfg), shape


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_built_cells_are_the_stand_ins(arch):
    """Each shape's parameters, AdamW state and caches built on the CPU
    (``build_cell``) have the names, shapes, dtypes and storage bytes of
    ``cell_leaves`` on one device; the parameters are those of
    ``init_params``, and their count is the model's."""
    for shape_name in SHAPES:
        cfg, shape = _small_cell(arch, shape_name)
        built = dryrun.build_cell(cfg, shape, device="cpu")
        got = dryrun.compare_build(cfg, shape, built)
        assert got["mismatches"] == [], (arch, shape_name)
        assert got["bytes"] == got["counted"], (arch, shape_name)
        kind = shape.kind
        assert (got["bytes"]["optimizer"] > 0) == (kind == "train")
        assert (got["bytes"]["caches"] > 0) == (kind == "decode")
        model = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        params = {name: t for g, name, t in built if g == "params"}
        assert params.keys() == dict(model.named_parameters()).keys()
        assert got["bytes"]["params"] == sum(
            p.numel() * p.element_size() for p in model.parameters())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cut_depth_keeps_every_kind_of_block(arch):
    """The cut published config has each block kind of the whole one, and
    at most 8 blocks (each encoder: 2)."""
    for shape_name in ("train_4k", "long_500k"):
        cfg = dryrun.cell_config(arch, shape_name)
        cut = dryrun.cut_depth(cfg)
        assert set(model_lib.block_kinds(cut)) == set(
            model_lib.block_kinds(cfg))
        assert cut.n_layers <= 8 and cut.d_model == cfg.d_model
        assert cut.n_encoder_layers == min(cfg.n_encoder_layers, 2)
        if cfg.first_k_dense:
            assert cut.n_layers > cfg.first_k_dense


def test_compare_build_names_each_wrong_leaf():
    """A leaf left out, one of another dtype and a view of a larger
    storage are each reported."""
    cfg, shape = _small_cell("qwen3-8b", "decode_32k")
    built = dryrun.build_cell(cfg, shape, device="cpu")
    (g0, n0, _), (g1, n1, t1) = built[0], built[1]
    last = built[-1]
    wrong = built[2:-1] + [(g1, n1, t1.half()),
                           (last[0], last[1], torch.cat(
                               [last[2].flatten(), last[2].flatten()])[
                                   : last[2].numel()].view_as(last[2]))]
    got = dryrun.compare_build(cfg, shape, wrong)
    assert len(got["mismatches"]) == 2
    assert n0 in got["mismatches"][0] + got["mismatches"][1]
    assert any(n1 in m and "float16" in m for m in got["mismatches"])
    assert got["bytes"] != got["counted"]


def test_allocate_on_card_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.allocate_on_card("gemma3-1b", "decode_32k", False)
    with pytest.raises(ValueError, match="caching allocator"):
        dryrun.allocate_on_card("gemma3-1b", "decode_32k", False,
                                device="cpu")
