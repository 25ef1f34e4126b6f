"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's (``src/repro/parallel/sharding.py``), in one process: every
config's full-size parameter tree (``jax.eval_shape``, no devices), its
batch and decode-cache specs, on ``AbstractMesh`` stand-ins of the
production meshes (16, 16) and (2, 16, 16) and a host mesh (2, 4)
(xlstm-350m's ``prefer_pure_dp`` among them); and the DTensor placements
of a spec."""
import jax
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import ARCH_NAMES, get_config as jget_config
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.parallel import sharding as jsharding
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.parallel import sharding

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")))


def _flat(tree):
    """{path: spec as a tuple} of a JAX tree of PartitionSpecs, paths as
    the JAX package's ``_path_str`` joins them."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jsharding._path_str(p): tuple(s) for p, s in leaves}


def _nested_flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_nested_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tuple(tree)}


def _meta_model(cfg):
    return model_lib.LM(layers.Init(None, dtype=torch.float32,
                                    device=torch.device("meta")), cfg)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_reference_on_full_size_trees(arch):
    """Each parameter's spec equals the JAX package's on its own tree
    (stacked units ``P(None, *inner)``), and ``param_specs`` gives each of
    the port's per-layer tensors that ``inner``."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    shapes = jax.eval_shape(
        lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    named = model_lib.param_tree(_meta_model(cfg))
    port_tree = convert.lm_tree(named, cfg)
    for shape, axes in MESHES:
        want = _flat(jsharding.param_specs(shapes, jcfg,
                                           AbstractMesh(shape, axes)))
        got = _nested_flat(sharding.tree_specs(port_tree, cfg,
                                               dict(zip(axes, shape))))
        assert got == want, (arch, shape)
        per_layer = sharding.param_specs(named, cfg, dict(zip(axes, shape)))
        assert set(per_layer) == set(named)
        for name, spec in per_layer.items():
            assert len(spec) == named[name].dim(), name
            assert isinstance(spec, sharding.PartitionSpec)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_equal_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    caches = jax.eval_shape(lambda: jinit_caches(
        jax.random.PRNGKey(0), jcfg, batch=16, s_max=512))
    caches1 = jax.eval_shape(lambda: jinit_caches(
        jax.random.PRNGKey(0), jcfg, batch=1, s_max=512))
    for shape, axes in MESHES:
        jm, pm = AbstractMesh(shape, axes), dict(zip(axes, shape))
        for kind in ("train", "decode"):
            want = {k: tuple(v) for k, v in jsharding.batch_specs(
                jcfg, jm, kind=kind).items()}
            got = {k: tuple(v) for k, v in sharding.batch_specs(
                cfg, pm, kind=kind).items()}
            assert got == want, (arch, shape, kind)
        for tree in (caches, caches1):
            want = _flat(jsharding.cache_specs(tree, jcfg, jm))
            got = {k: tuple(v)
                   for k, v in sharding.cache_specs(tree, cfg, pm).items()}
            assert got == want, (arch, shape)


def test_cache_specs_of_the_ports_per_layer_caches():
    """The port's caches (a list, one a block, no unit axis) get the
    reference's stacked caches' ``inner`` specs."""
    jcfg = jget_config("qwen3-8b", smoke=True)
    cfg = get_config("qwen3-8b", smoke=True)
    ref = jsharding.cache_specs(jax.eval_shape(lambda: jinit_caches(
        jax.random.PRNGKey(0), jcfg, batch=4, s_max=64)), jcfg,
        AbstractMesh((2, 2), ("data", "model")))
    caches = model_lib.init_caches(cfg, batch=4, s_max=64, device="cpu")
    got = sharding.cache_specs(caches, cfg, {"data": 2, "model": 2})
    assert set(got) == {f"{i}/{k}" for i in range(cfg.n_layers)
                        for k in ("k", "v")}
    for path, spec in got.items():
        want = tuple(ref["units"]["b0"][path.split("/")[1]])
        assert (None, *spec) == want, path


class _Mesh:
    """A stand-in with a DeviceMesh's axis names (placements need no
    world)."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    P = sharding.PartitionSpec
    assert sharding.placements(P(("pod", "data"), "model"),
                               _Mesh("pod", "data", "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert sharding.placements(P(None, "model"), _Mesh("data", "model")) == [
        Replicate(), Shard(1)]
    assert sharding.placements(P(), _Mesh("data", "model")) == [
        Replicate(), Replicate()]
    assert repr(P("data", None)) == "P('data', None)"


def test_specs_need_no_world_and_take_a_mapping():
    cfg = get_config("qwen3-8b")
    named = model_lib.param_tree(_meta_model(cfg))
    specs = sharding.param_specs(named, cfg, {"data": 2, "model": 4})
    assert specs["blocks.0.attn.wq"] == ("data", "model")
    assert specs["blocks.0.mlp.w_down"] == ("model", "data")
    assert specs["blocks.0.norm1"] == (None,)
    assert specs["lm_head"] == ("data", "model")
    # 8 KV heads do not divide by 16: the projections stay whole over model
    specs = sharding.param_specs(named, cfg, {"data": 16, "model": 16})
    assert specs["blocks.0.attn.wq"] == ("data", None)
