"""The port's MoE and MLA language models (deepseek-v2-236b, moonshot-v1-16b-a3b)
and the two plain GQA configs copied with them (deepseek-7b, qwen2.5-14b)
against the JAX package, on the CPU, at their smoke configs.

The JAX package draws the weights and the decode caches' LSH projections;
``convert`` carries them across.  Replayed on the port:

- ``tests/test_models.py``'s decode against the full forward (its MLA
  no-drop variant, and the same for moonshot: with the default capacity a
  token-by-token decode routes other tokens than the full forward does, in
  both packages), and its aggregated-KV exactness at refine_frac 1.0 for
  deepseek-v2-236b, in both cache layouts;
- ``tests/test_arch_smoke.py``'s smoke decode and aggregated decode for the
  four configs;

each also held against the JAX package's logits within 2e-5 (the
reference's attention tolerance; logits are O(1)).  ``convert``'s model
trees round-trip with the MoE and MLA leaves; the block kinds that a
later slice ported build, apply and decode, and expert parallelism over
a mesh axis still raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import np_of, rng, th
from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import serve_step as jserve_step
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import (
    lm_cache_lsh_from_numpy, lm_decayed, lm_params_from_numpy,
    lm_params_to_numpy, lm_tree,
)
from repro_torch.models import model as model_lib
from repro_torch.models import transformer

TOL = 2e-5
B, S = 2, 12
NEW = ("deepseek-v2-236b", "moonshot-v1-16b-a3b", "deepseek-7b",
       "qwen2.5-14b")
NO_DROP = {"capacity_factor": 100.0}
jx = jnp.asarray


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch, seed=1, **over):
    """(JAX cfg, JAX params, port cfg, port model) of one smoke config."""
    jcfg = jget_config(arch, smoke=True).with_(**over)
    cfg = get_config(arch, smoke=True).with_(**over)
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, lm_params_from_numpy(_np_tree(jp), cfg,
                                               device="cpu")


def _tokens(cfg, seed=0, s=S):
    return rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _decode_both(jcfg, jp, cfg, model, tokens, *, s_max=16, cache_seed=9):
    """Token-by-token serve_step on both packages, the port's caches
    holding the JAX caches' LSH draws: (port logits, JAX logits), each
    [B, S, V_pad]."""
    jcaches = jinit_caches(jax.random.PRNGKey(cache_seed), jcfg, batch=B,
                           s_max=s_max)
    lsh = (lm_cache_lsh_from_numpy(_np_tree(jcaches), cfg, device="cpu")
           if cfg.agg_kv else None)
    caches = model_lib.init_caches(cfg, batch=B, s_max=s_max, lsh=lsh,
                                   device="cpu")
    step = jax.jit(jserve_step, static_argnames=("cfg",))
    got, want = [], []
    for t in range(tokens.shape[1]):
        pos = np.full((B,), t, np.int32)
        w, jcaches = step(jp, jcaches, jx(tokens[:, t:t + 1]), jx(pos),
                          cfg=jcfg)
        g, _ = model_lib.serve_step(model, caches, th(tokens[:, t:t + 1]),
                                    th(pos), cfg)
        got.append(np_of(g))
        want.append(np.asarray(w))
    return np.stack(got, 1), np.stack(want, 1)


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "moonshot-v1-16b-a3b"])
def test_decode_matches_forward_nodrop(arch):
    """``test_models.py:48`` (``test_decode_matches_forward_mla_nodrop``)
    on the port: the absorbed MLA decode (or GQA's) with no token dropped
    equals the materialised full forward; both sides equal the JAX
    package's."""
    jcfg, jp, cfg, model = _models(arch, **NO_DROP)
    tokens = _tokens(cfg)
    full = np_of(model_lib.forward(model, th(tokens), cfg))
    dec, jdec = _decode_both(jcfg, jp, cfg, model, tokens)
    assert _rel(full, dec) < 1e-4
    np.testing.assert_allclose(full, np.asarray(jforward(jp, jx(tokens),
                                                         jcfg)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dec, jdec, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "moonshot-v1-16b-a3b"])
def test_forward_with_drops_matches_reference(arch):
    """The default capacity drops tokens over B x S = 24: the port drops
    the same ones."""
    jcfg, jp, cfg, model = _models(arch, seed=3)
    tokens = _tokens(cfg, seed=4)
    np.testing.assert_allclose(
        np_of(model_lib.forward(model, th(tokens), cfg)),
        np.asarray(jforward(jp, jx(tokens), jcfg)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", ["flat", "bucket_major"])
def test_aggregated_kv_full_refinement_exact_mla(layout):
    """``test_models.py:64`` for deepseek-v2-236b on the port: refine_frac
    1.0 over the latent aggregated cache equals the exact decode (1e-4,
    the reference test's tolerance), and the JAX package's aggregated
    decode (2e-5)."""
    jcfg, jp, cfg, model = _models("deepseek-v2-236b", **NO_DROP)
    tokens = _tokens(cfg)
    exact, _ = _decode_both(jcfg, jp, cfg, model, tokens)
    agg = dict(agg_kv=True, agg_layout=layout, agg_compression=2,
               agg_refine_frac=1.0)
    got, want = _decode_both(jcfg.with_(**agg), jp, cfg.with_(**agg), model,
                             tokens)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", NEW)
def test_smoke_decode(arch):
    """``test_arch_smoke.py::test_smoke_decode`` on the port, against the
    JAX package's logits."""
    jcfg, jp, cfg, model = _models(arch)
    tokens = np.zeros((B, 4), np.int32)
    got, want = _decode_both(jcfg, jp, cfg, model, tokens, s_max=32,
                             cache_seed=2)
    last = got[:, -1]
    assert last.shape == (B, model_lib.padded_vocab(cfg))
    assert np.isfinite(last).all()
    if model_lib.padded_vocab(cfg) > cfg.vocab_size:
        assert last[:, cfg.vocab_size:].max() < -1e29
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", ["flat", "bucket_major"])
@pytest.mark.parametrize("arch", NEW)
def test_smoke_decode_aggregated_kv(arch, layout):
    """``test_arch_smoke.py::test_smoke_decode_aggregated_kv`` on the port
    (compression 4, refine_frac 0.3), against the JAX package's logits."""
    agg = dict(agg_kv=True, agg_layout=layout, agg_compression=4,
               agg_refine_frac=0.3)
    jcfg, jp, cfg, model = _models(arch, seed=2, **agg)
    tokens = np.zeros((B, 4), np.int32)
    got, want = _decode_both(jcfg, jp, cfg, model, tokens, s_max=32,
                             cache_seed=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "moonshot-v1-16b-a3b"])
def test_model_trees_round_trip_with_moe_and_mla_leaves(arch):
    """``lm_params_from_numpy`` takes the reference tree (head block dense,
    units stacked with their router, experts and shared MLP; MLA's latent
    projections), and ``lm_params_to_numpy`` / ``lm_tree`` give it back,
    leaf for leaf; AdamW decays the leaves the reference's rule names."""
    jcfg, jp, cfg, model = _models(arch)
    want = _np_tree(jp)
    got = lm_params_to_numpy(model, cfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    names = dict(model.named_parameters())
    assert "blocks.0.mlp.w_gate" in names and "blocks.1.moe.router" in names
    assert names["blocks.1.moe.router"].dtype == torch.float32
    if cfg.mla:
        assert "blocks.1.attn.w_uk" in names
    tree = lm_tree(names, cfg)
    assert set(tree["units"]["b0"]["moe"]) == set(want["units"]["b0"]["moe"])
    decayed = lm_decayed(names, cfg)
    assert decayed["blocks.1.norm1"] and not decayed["blocks.0.norm1"]
    assert decayed["blocks.1.moe.w_gate"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "moonshot-v1-16b-a3b"])
def test_cache_lsh_draws_carry_across(arch):
    """The latent caches' draws ([Hkv dk, 4] with Hkv 1, dk = kv_lora_rank
    + rope_head_dim for MLA) come across in stack order."""
    jcfg = jget_config(arch, smoke=True).with_(agg_kv=True)
    cfg = get_config(arch, smoke=True).with_(agg_kv=True)
    jc = jinit_caches(jax.random.PRNGKey(3), jcfg, batch=1, s_max=8)
    lsh = lm_cache_lsh_from_numpy(_np_tree(jc), cfg, device="cpu")
    n_kv, dk, _ = transformer.cache_dims(cfg)
    assert len(lsh) == cfg.n_layers
    assert all(a.shape == (n_kv * dk, 4) and b.shape == (4,)
               for a, b in lsh)
    np.testing.assert_array_equal(np_of(lsh[0][0]),
                                  np.asarray(jc["head"]["0"].lsh_a))
    np.testing.assert_array_equal(np_of(lsh[1][0]),
                                  np.asarray(jc["units"]["b0"].lsh_a)[0])


def test_registry_holds_the_ported_configs():
    assert set(NEW) | {"qwen3-8b"} < set(ARCH_NAMES)
    for arch in NEW:
        for smoke in (False, True):
            want = jget_config(arch, smoke=smoke)
            got = get_config(arch, smoke=smoke)
            assert {f: getattr(got, f) for f in got.__dataclass_fields__} \
                == {f: getattr(want, f) for f in want.__dataclass_fields__}


@pytest.mark.parametrize("over,kind", [
    ({"sliding_window": 8}, "attn_local"),
    ({"is_encoder_decoder": True}, "attn"), ({"mrope": True}, "attn"),
    ({"ssm_state": 16, "ssm_head_dim": 16}, "mamba"), ({}, "mlstm"),
])
def test_formerly_unported_block_kinds_build_apply_and_decode(over, kind):
    """The kinds and config flags this slice ports build, apply over a
    sequence and decode a step on a deepseek-7b smoke block, as the JAX
    package's ``block_init`` / ``block_apply`` / ``block_decode`` do."""
    from repro.models import transformer as jtransformer

    cfg = get_config("deepseek-7b", smoke=True).with_(**over)
    jcfg = jget_config("deepseek-7b", smoke=True).with_(**over)
    jp = jtransformer.block_init(jax.random.PRNGKey(0), jcfg, kind,
                                 dtype=jnp.float32)
    blk = transformer.block_init(
        model_lib.layers.Init(None, dtype=torch.float32,
                              device=torch.device("cpu")), cfg, kind)
    names = dict(blk.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(_np_tree(jp))[0]
    assert len(flat) == len(names)
    for path, leaf in flat:
        names[".".join(k.key for k in path)].data.copy_(th(leaf))
    r = rng(1)
    x = r.standard_normal((B, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (B, 6)).astype(np.int32)
    japply = jax.jit(lambda p, x_, pos_: jtransformer.block_apply(
        p, x_, jcfg, kind, positions=pos_))
    np.testing.assert_allclose(
        np_of(transformer.block_apply(blk, th(x), cfg, kind,
                                      positions=th(pos))),
        np.asarray(japply(jp, jx(x), jx(pos))), rtol=TOL, atol=TOL)
    cache = transformer.init_block_cache(cfg, kind, batch=B, s_max=8,
                                         dtype=torch.float32,
                                         device=torch.device("cpu"))
    jcache = jtransformer.init_block_cache(jax.random.PRNGKey(1), jcfg, kind,
                                           batch=B, s_max=8,
                                           dtype=jnp.float32)
    p0 = np.zeros((B,), np.int32)
    got, _ = transformer.block_decode(blk, th(x[:, :1]), cfg, kind, cache,
                                      th(p0))
    want, _ = jtransformer.block_decode(jp, jx(x[:, :1]), jcfg, kind,
                                        jcache, jx(p0))
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_what_stays_unported_still_raises():
    """What the mesh path leaves out raises before any collective: a
    sharded train step with top-k gradient compression (the JAX package
    selects over whole stacked tensors, which no rank holds), a sharded
    step over parameters that were not placed, and stage 2 of a servable
    on a mesh engine (ROADMAP queue 3).  The mesh stands in for a
    ``DeviceMesh``; the mesh path itself: tests/test_torch_parallel.py."""
    from repro_torch import optim
    from repro_torch.apps import knn
    from repro_torch.core import engine
    from repro_torch.launch import train
    from repro_torch.models.transformer import ParallelContext

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    ctx = ParallelContext(mesh=Mesh(), use_ep=True)
    with pytest.raises(ValueError, match="compression"):
        train.make_train_step(cfg, optim.AdamWConfig(), ctx,
                              grad_compress_frac=0.1)
    model = model_lib.init_params(cfg, torch.Generator(), device="cpu")
    step = train.make_train_step(cfg, optim.AdamWConfig(), ctx)
    batch = train.synth_batch(torch.Generator(), cfg, batch=2, seq=4,
                              device="cpu")
    with pytest.raises(ValueError, match="place_params"):
        step(model, optim.init_state(model_lib.param_tree(model)), batch)
    x = torch.randn(40, 3, generator=torch.Generator().manual_seed(0))
    servable = knn.KNNServable(x, torch.zeros(40, dtype=torch.int32),
                               n_classes=2, k=3,
                               lsh_generator=torch.Generator(),
                               engine=engine.MapReduce(Mesh()),
                               device="cpu")
    prepared = servable.build(5.0)
    with pytest.raises(ValueError, match="stage 2"):
        servable.run(prepared, (x[:2],), refine_budget=4)


def test_chip_smoke_moe_phase_runs_on_the_cpu(monkeypatch):
    """The card's moe phase at the two models' smoke widths, with its
    checks (one attention launch and one selection a layer, a prefill token
    and a decode step; the f32 guard's tokens and logits against the exact
    MLA decode), counting plain versions in place of the kernels."""
    from _torch_parity import chip_smoke, plain_kernels
    from repro_torch.kernels import ops

    cs = chip_smoke()
    wrappers = plain_kernels(monkeypatch)
    rows = [row for row in cs.DECODE_MODELS if row.phase == "moe"]
    models = {row.arch: get_config(row.arch, smoke=True) for row in rows}
    probe, jobs = cs.CaptureProbe(torch, clone=True), {}
    summary, counts = cs.decode_phase(torch, ops, probe, jobs, "moe",
                                      models=models, dev="cpu",
                                      prompt_len=12, s_max=64)
    assert set(summary) == {*models, "phase_s"}
    for row in rows:
        for layout in row.layouts:
            lv = summary[row.arch][layout]["levels"]
            assert set(lv) == {str(rf) for rf in cs.DECODE_SWEEP}
            assert lv["1.0"]["token_agreement"] == 1.0
    guard = summary["deepseek-v2-236b"]["guard"]
    assert set(guard) == {"bucket_major", "flat"}
    assert all(g["tokens_equal"] and g["exact"] == "exact decode"
               for g in guard.values())
    assert "guard" not in summary["moonshot-v1-16b-a3b"]
    for op in ("distance_topk", "agg_refine_attention",
               "aggregated_attention_decode"):
        assert counts[op] > 0 and probe.calls[op]
    # the MLA shapes were captured for the kernel rows: the latent query
    # (kv_lora_rank + rope_head_dim wide) of every head over one KV head
    mla = models["deepseek-v2-236b"]
    width = mla.kv_lora_rank + mla.rope_head_dim
    assert any(args[0].shape[1:] == (1, mla.n_heads, width)
               for args, _ in probe.calls["agg_refine_attention"].values())
    assert wrappers["aggregated_attention_decode"].launches > 0
