"""The port's checkpointer (``repro_torch.checkpoint``): the checkpoint
scenarios of ``tests/test_substrate.py`` replayed on it, the on-disk format
held byte for byte against the JAX package's, and train states of
qwen3-8b's smoke config restored across the two packages.

Restores are exact: every leaf comes back with its bits (f32, int32 and,
into the port, bf16).  The JAX package cannot restore its own bf16 files
(ROADMAP queue 3); ``test_reference_bf16_checkpoint_restores_into_the_port``
pins that difference.
"""
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import normal, np_of, rng, th
from repro import optim as joptim
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import (
    lm_params_from_numpy, lm_params_to_numpy, lm_tree, train_state_from_tree,
    train_state_tree,
)
from repro_torch.models import model as model_lib

ARCH = "qwen3-8b"


def _ck(d):
    return Checkpointer(d, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_substrate.py's checkpoint scenarios
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_latest():
    r = rng(0)
    tree = {"layer": {"w": th(normal(r, 4, 4)), "b": torch.arange(4.0)},
            "step_count": torch.tensor(3)}
    with tempfile.TemporaryDirectory() as d:
        ck = _ck(d)
        ck.save(10, tree, extra={"step": 10, "rng": 7})
        ck.save(20, tree, extra={"step": 20})
        assert ck.latest_step() == 20
        restored, extra = ck.restore(tree, step=10)
        assert extra == {"step": 10, "rng": 7}
        assert torch.equal(restored["layer"]["w"], tree["layer"]["w"])
        assert restored["step_count"].dtype == torch.int64


def test_checkpoint_async_save():
    tree = {"w": torch.ones(128, 128)}
    with tempfile.TemporaryDirectory() as d:
        ck = _ck(d)
        ck.save(1, tree, blocking=False)
        ck.wait()
        assert ck.latest_step() == 1
        restored, _ = ck.restore(tree)
        assert torch.equal(restored["w"], torch.ones(128, 128))


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        ck = _ck(d)
        ck.save(1, {"w": torch.ones(4)})
        with pytest.raises(ValueError):
            ck.restore({"w": torch.ones(5)})
        with pytest.raises(FileNotFoundError):
            _ck(f"{d}/empty").restore({"w": torch.ones(4)})


def test_async_save_snapshots_before_the_writer_runs():
    """The leaves are copied before ``save`` returns: an in-place update
    right after an async save does not reach the file."""
    w = torch.zeros(256, 256)
    with tempfile.TemporaryDirectory() as d:
        ck = _ck(d)
        ck.save(1, {"w": w}, blocking=False)
        w.add_(1.0)
        ck.wait()
        restored, _ = ck.restore({"w": w})
        assert torch.equal(restored["w"], torch.zeros(256, 256))


# ---------------------------------------------------------------------------
# the on-disk format, byte for byte
# ---------------------------------------------------------------------------

def _mixed_state(r):
    """(reference state, port state): f32, int32 and bf16 leaves, a
    NamedTuple and a scalar, from the same numpy values."""
    emb, w = normal(r, 5, 3), normal(r, 2, 3)
    m, v = normal(r, 2, 3), np.abs(normal(r, 2, 3))
    jstate = {
        "params": {"embed": jnp.asarray(emb, jnp.bfloat16),
                   "w": jnp.asarray(w)},
        "opt": joptim.AdamState(step=jnp.asarray(7, jnp.int32),
                                m={"w": jnp.asarray(m)},
                                v={"w": jnp.asarray(v)}),
        "loss": jnp.asarray(2.5, jnp.float32),
    }
    tstate = {
        "params": {"embed": th(emb).to(torch.bfloat16), "w": th(w)},
        "opt": optim.AdamState(step=torch.tensor(7, dtype=torch.int32),
                               m={"w": th(m)}, v={"w": th(v)}),
        "loss": torch.tensor(2.5),
    }
    return jstate, tstate


def test_files_and_manifest_equal_the_reference_byte_for_byte(tmp_path):
    jstate, tstate = _mixed_state(rng(1))
    JCheckpointer(tmp_path / "ref").save(3, jstate, extra={"step": 3})
    _ck(tmp_path / "port").save(3, tstate, extra={"step": 3})
    ref, port = tmp_path / "ref", tmp_path / "port"
    names = sorted(p.name for p in (ref / "step_3").iterdir())
    assert names == sorted(p.name for p in (port / "step_3").iterdir())
    assert "opt__.m__w.npy" in names and "params__embed.npy" in names
    for name in names:
        assert (ref / "step_3" / name).read_bytes() == \
            (port / "step_3" / name).read_bytes(), name
    manifest = json.loads((port / "step_3" / "manifest.json").read_text())
    assert manifest["keys"]["params/embed"]["dtype"] == "bfloat16"
    assert manifest["keys"]["opt/.step"] == {"shape": [], "dtype": "int32"}
    assert (ref / "LATEST").read_text() == (port / "LATEST").read_text()
    assert np.load(port / "step_3" / "params__embed.npy").dtype.kind == "V"
    restored, extra = _ck(port).restore(tstate)
    assert extra == {"step": 3}
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         jax.tree_util.tree_leaves(tstate)):
        assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# train states across the two packages
# ---------------------------------------------------------------------------

def _reference_train_state(jcfg, seed=0):
    """The JAX package's examples/train_lm.py state after one train step."""
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    opt = joptim.init_state(params)
    r = rng(seed + 50)
    batch = {k: jnp.asarray(r.integers(0, jcfg.vocab_size, (2, 8)),
                            jnp.int32) for k in ("tokens", "labels")}
    step = jtrain.make_train_step(jcfg, joptim.AdamWConfig(lr=1e-3))
    params, opt, metrics = step(params, opt, batch)
    return {"params": params, "opt": opt, "loss": metrics["loss"]}


def _port_template(cfg):
    model = model_lib.init_params(cfg, torch.Generator(), device="cpu")
    return train_state_tree({"params": model,
                             "opt": optim.init_state(
                                 model_lib.param_tree(model)),
                             "loss": torch.zeros(())}, cfg)


def _assert_trees_equal(got_tree, want_tree):
    got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np_of(a), np.asarray(b),
                                      err_msg=str(path))


def test_reference_train_state_restores_into_the_port(tmp_path):
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jstate = _reference_train_state(jcfg)
    JCheckpointer(tmp_path).save(1, jstate, extra={"step": 1})
    restored, extra = _ck(tmp_path).restore(_port_template(cfg))
    assert extra == {"step": 1}
    # the reference's own tree, as numpy, is a template too
    as_numpy, _ = _ck(tmp_path).restore(
        jax.tree_util.tree_map(np.asarray, jstate))
    _assert_trees_equal(as_numpy, jstate)
    state = train_state_from_tree(restored, cfg, device="cpu")
    assert isinstance(state["params"], model_lib.LM)
    assert int(state["opt"].step) == 1
    _assert_trees_equal(train_state_tree(state, cfg), jstate)
    # the restored model computes the reference's loss
    batch = {k: torch.zeros(1, 8, dtype=torch.int32) for k in
             ("tokens", "labels")}
    want = jmodel.loss_fn(jstate["params"], {k: jnp.zeros((1, 8), jnp.int32)
                                             for k in batch}, jcfg)
    got = model_lib.loss_fn(state["params"], batch, cfg)
    assert abs(float(got) - float(want)) <= 1e-5


def test_port_train_state_restores_into_the_reference(tmp_path):
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jstate = _reference_train_state(jcfg, seed=4)
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    port_state = train_state_from_tree(tree, cfg, device="cpu")
    _ck(tmp_path).save(2, train_state_tree(port_state, cfg),
                       extra={"step": 2})
    restored, extra = JCheckpointer(tmp_path).restore(jstate)
    assert extra == {"step": 2}
    _assert_trees_equal(restored, jstate)
    keys = json.loads((tmp_path / "step_2" / "manifest.json").read_text())[
        "keys"]
    assert {"loss", "opt/.step", "opt/.m/embed", "params/units/b0/attn/wq",
            "opt/.v/units/b0/mlp/w_down"} <= set(keys)


def test_reference_bf16_checkpoint_restores_into_the_port(tmp_path):
    """A bf16 model's checkpoint: the JAX package writes its bf16 leaves as
    ``|V2`` and cannot read them back (``ValueError: No cast function
    available``, ROADMAP queue 3); the port restores them to the bit."""
    jcfg = jget_config(ARCH, smoke=True).with_(dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True).with_(dtype="bfloat16")
    params = jmodel.init_params(jax.random.PRNGKey(5), jcfg)
    JCheckpointer(tmp_path).save(1, {"params": params})
    with pytest.raises(ValueError, match="No cast function"):
        JCheckpointer(tmp_path).restore({"params": params})
    model = model_lib.init_params(cfg, torch.Generator(), device="cpu")
    restored, _ = _ck(tmp_path).restore(
        {"params": lm_tree(model_lib.param_tree(model), cfg)})
    got = jax.tree_util.tree_flatten_with_path(restored["params"])[0]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16),
                                      err_msg=str(path))
    model = lm_params_from_numpy(restored["params"], cfg, device="cpu")
    assert torch.equal(model.embed.view(torch.int16),
                       th(np.asarray(params["embed"]).view(np.int16)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_to_numpy_inverts_lm_params_from_numpy(dtype):
    """The reference's parameter tree -> the port's LM -> the tree again,
    units stacked; bf16 weights come back as float32 of the same values."""
    jcfg = jget_config(ARCH, smoke=True).with_(dtype=dtype)
    cfg = get_config(ARCH, smoke=True).with_(dtype=dtype)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jmodel.init_params(jax.random.PRNGKey(6), jcfg))
    back = lm_params_to_numpy(lm_params_from_numpy(tree, cfg, device="cpu"),
                              cfg)
    _assert_trees_equal(back, tree)
    assert all(a.dtype == np.float32 for a in jax.tree_util.tree_leaves(back))
