"""The port's other five model families (zamba2-7b's Mamba2 and shared
attention, xlstm-350m, whisper-tiny's encoder-decoder, gemma3-1b's sliding
window, qwen2-vl-2b's M-RoPE) against the JAX package, on the CPU, at
their smoke configs.

The JAX package draws the weights and the decode caches' LSH projections;
``convert`` carries them across.  Replayed on the port:

- ``tests/test_models.py::test_decode_matches_forward`` for gemma3-1b (its
  ring buffer wraps: window 8, 12 tokens), zamba2-7b and xlstm-350m (rel
  1e-4, port against port, and each side against the JAX package's);
- ``tests/test_arch_smoke.py``'s smoke train step and smoke decode for the
  five, its aggregated-KV decode for zamba2-7b and gemma3-1b in both cache
  layouts, and its ten-config registry;

each also held against the JAX package within ``TOL`` (2e-5, the
reference's attention tolerance; logits are O(1)), the train step's loss
within 1e-5 and every gradient leaf within 1e-4 of its largest entry.
Added: forward parity with whisper's ``frames`` and with a qwen2-vl M-RoPE
grid whose three rows differ; ``convert``'s trees with the
``shared_attn``, ``encoder``, Mamba2, xLSTM and cross leaves; the shared
block's gradient summed over its slots; ``DecodeEngine.insert`` of each
new cache kind; whisper's cross caches, which stay zero (ROADMAP queue 3);
and ``chip_smoke.py``'s arch phase at the smoke widths.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import np_of, rng, th
from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import forward as jforward
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro.models import serve_step as jserve_step
from repro_torch import optim
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import (
    lm_cache_lsh_from_numpy, lm_decayed, lm_params_from_numpy,
    lm_params_to_numpy, lm_tree, train_state_from_tree, train_state_tree,
)
from repro_torch.launch import train
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.serve.lm.engine import DecodeEngine

TOL = 2e-5
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
B, S = 2, 12
NEW = ("zamba2-7b", "xlstm-350m", "whisper-tiny", "gemma3-1b", "qwen2-vl-2b")
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


def _grid(s, b=B):
    """A t/h/w M-RoPE grid [3, B, S] whose three rows differ."""
    t = np.arange(s)
    return np.broadcast_to(np.stack([t, t // 2, t % 3])[:, None],
                           (3, b, s)).astype(np.int32)


def _frames(cfg, seed=5, s=S):
    return rng(seed).standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _decode_both(jcfg, jp, cfg, model, tokens, *, s_max=16, cache_seed=9,
                 mrope=None):
    """Token-by-token serve_step on both packages, the port's caches
    holding the JAX caches' LSH draws; ``mrope`` [3, B, 1] fed at every
    step, as ``test_arch_smoke.py`` feeds qwen2-vl: (port logits, JAX
    logits), each [B, S, V_pad]."""
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
                          cfg=jcfg, mrope_positions=None if mrope is None
                          else jx(mrope))
        g, _ = model_lib.serve_step(
            model, caches, th(tokens[:, t:t + 1]), th(pos), cfg,
            mrope_positions=None if mrope is None else th(mrope))
        got.append(np_of(g))
        want.append(np.asarray(w))
    return np.stack(got, 1), np.stack(want, 1)


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-7b", "xlstm-350m"])
def test_decode_matches_forward(arch):
    """``test_models.py:29`` on the port: token-by-token decode equals the
    full causal forward (rel 1e-4); both equal the JAX package's.  gemma3's
    local layers decode over a ring buffer of 8 slots that wraps at token
    8; its forward uses the window mask."""
    jcfg, jp, cfg, model = _models(arch)
    tokens = _tokens(cfg)
    full = np_of(model_lib.forward(model, th(tokens), cfg))
    dec, jdec = _decode_both(jcfg, jp, cfg, model, tokens)
    assert _rel(full, dec) < 1e-4
    np.testing.assert_allclose(full, np.asarray(jforward(jp, jx(tokens),
                                                         jcfg)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dec, jdec, rtol=TOL, atol=TOL)
    if arch == "gemma3-1b":
        caches = model_lib.init_caches(cfg, batch=B, s_max=16, device="cpu")
        assert [c["k"].shape[1] for c in caches] == [8, 16, 8, 16]


def _jbatch(cfg, seed):
    """``test_arch_smoke.py``'s batch, drawn by the JAX package."""
    return _np_tree(jtrain.synth_batch(jax.random.PRNGKey(seed), cfg,
                                       batch=B, seq=16))


def _jgrad(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg)))


@pytest.mark.parametrize("arch", NEW)
def test_smoke_train_step(arch):
    """``test_arch_smoke.py::test_smoke_train_step`` on the port: one AdamW
    step on the JAX package's batch (whisper's frames, qwen2-vl's M-RoPE
    grid) from the JAX package's weights; its loss and every gradient leaf
    equal the JAX package's, and the parameters stay finite."""
    jcfg, jp, cfg, model = _models(arch, seed=0)
    jb = _jbatch(jcfg, 0)
    jloss, jgrads = _jgrad(jcfg)(jp, {k: jx(v) for k, v in jb.items()})
    batch = {k: th(v) for k, v in jb.items()}
    loss, grads = train.value_and_grad(model, batch, cfg)
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    want = dict(jax.tree_util.tree_flatten_with_path(_np_tree(jgrads))[0])
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np_of, lm_tree(grads, cfg)))[0]
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_RTOL * scale, \
            jax.tree_util.keystr(path)
    step = train.make_train_step(cfg, optim.AdamWConfig(lr=1e-3))
    opt = optim.init_state(model_lib.param_tree(model))
    before = {n: p.clone() for n, p in model_lib.param_tree(model).items()}
    model, opt, metrics = step(model, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    params = model_lib.param_tree(model)
    assert all(bool(torch.isfinite(p).all()) for p in params.values())
    assert any(not torch.equal(p, before[n]) for n, p in params.items())


@pytest.mark.parametrize("arch", NEW)
def test_smoke_decode(arch):
    """``test_arch_smoke.py::test_smoke_decode`` on the port (qwen2-vl with
    a zero M-RoPE grid at every step, as there), against the JAX package's
    logits."""
    jcfg, jp, cfg, model = _models(arch)
    tokens = np.zeros((B, 4), np.int32)
    mp = np.zeros((3, B, 1), np.int32) if cfg.mrope else None
    got, want = _decode_both(jcfg, jp, cfg, model, tokens, s_max=32,
                             cache_seed=2, mrope=mp)
    last = got[:, -1]
    assert last.shape == (B, model_lib.padded_vocab(cfg))
    assert np.isfinite(last).all()
    if model_lib.padded_vocab(cfg) > cfg.vocab_size:
        assert last[:, cfg.vocab_size:].max() < -1e29
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", ["flat", "bucket_major"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma3-1b"])
def test_smoke_decode_aggregated_kv(arch, layout):
    """``test_arch_smoke.py::test_smoke_decode_aggregated_kv`` on the port
    (compression 4, refine_frac 0.3): zamba2's shared-attention slots each
    decode over an aggregated cache of their own, gemma3's global layers
    over an aggregated cache and its local ones over exact ring buffers;
    against the JAX package's logits."""
    agg = dict(agg_kv=True, agg_layout=layout, agg_compression=4,
               agg_refine_frac=0.3)
    jcfg, jp, cfg, model = _models(arch, seed=2, **agg)
    tokens = _tokens(cfg, seed=3)
    got, want = _decode_both(jcfg, jp, cfg, model, tokens, s_max=32,
                             cache_seed=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    kinds = model_lib.block_kinds(cfg)
    caches = model_lib.init_caches(
        cfg, batch=1, s_max=32, device="cpu",
        lsh=model_lib.draw_lsh(cfg, torch.Generator(), device="cpu"))
    # zamba2: two shared-attention slots; gemma3: two global layers
    assert len(model_lib.aggregated_caches(caches)) == sum(
        transformer.uses_agg(cfg, k) for k in kinds) == 2


def test_registry_holds_all_ten_configs():
    """``test_arch_smoke.py::test_all_archs_have_all_shapes_defined`` on the
    port: ten configs, each named as its key, its smoke config at most 128
    wide, and each equal to the JAX package's field by field, full and
    smoke."""
    assert len(ARCH_NAMES) == 10
    assert ARCH_NAMES == JARCH_NAMES
    for arch in ARCH_NAMES:
        assert get_config(arch).name == arch
        assert get_config(arch, smoke=True).d_model <= 128
        for smoke in (False, True):
            want = jget_config(arch, smoke=smoke)
            got = get_config(arch, smoke=smoke)
            assert {f: getattr(got, f) for f in got.__dataclass_fields__} \
                == {f: getattr(want, f) for f in want.__dataclass_fields__}


def test_whisper_forward_with_frames_matches_reference():
    """The encoder over ``frames`` (sinusoidal positions, non-causal
    blocks) and the decoder's cross-attention to its output, through
    ``forward`` and ``launch.train.make_prefill_step``."""
    jcfg, jp, cfg, model = _models("whisper-tiny", seed=4)
    tokens, frames = _tokens(cfg, seed=6), _frames(cfg, s=10)
    want = np.asarray(jforward(jp, jx(tokens), jcfg, frames=jx(frames)))
    got = np_of(model_lib.forward(model, th(tokens), cfg, frames=th(frames)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    last = train.make_prefill_step(cfg)(
        model, {"tokens": th(tokens), "frames": th(frames)})
    np.testing.assert_allclose(np_of(last), want[:, -1], rtol=TOL, atol=TOL)
    # the encoder's memory reaches the logits
    other = np_of(model_lib.forward(model, th(tokens), cfg,
                                    frames=th(frames * 2.0)))
    assert float(np.abs(other - got).max()) > 1e-3
    with pytest.raises(ValueError, match="frames"):
        model_lib.forward(model, th(tokens), cfg)


def test_qwen2_vl_forward_with_an_mrope_grid_matches_reference():
    """M-RoPE over a t/h/w grid whose three rows differ (sections 2/3/3 of
    the smoke head's 8 frequency slots), through ``forward`` and
    ``make_prefill_step``; without the grid both packages fall back to
    standard RoPE."""
    jcfg, jp, cfg, model = _models("qwen2-vl-2b", seed=7)
    tokens, mp = _tokens(cfg, seed=8), _grid(S)
    want = np.asarray(jforward(jp, jx(tokens), jcfg,
                               mrope_positions=jx(mp)))
    got = np_of(model_lib.forward(model, th(tokens), cfg,
                                  mrope_positions=th(mp)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    last = train.make_prefill_step(cfg)(
        model, {"tokens": th(tokens), "mrope_positions": th(mp)})
    np.testing.assert_allclose(np_of(last), want[:, -1], rtol=TOL, atol=TOL)
    plain = np_of(model_lib.forward(model, th(tokens), cfg))
    np.testing.assert_allclose(
        plain, np.asarray(jforward(jp, jx(tokens), jcfg)), rtol=TOL,
        atol=TOL)
    assert float(np.abs(plain - got).max()) > 1e-3
    # equal rows are standard RoPE
    same = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).astype(
        np.int32)
    np.testing.assert_allclose(
        np_of(model_lib.forward(model, th(tokens), cfg,
                                mrope_positions=th(same))), plain,
        rtol=TOL, atol=TOL)


def test_apply_mrope_matches_reference_at_qwen2_vl_head():
    """``apply_mrope`` at qwen2-vl-2b's head of 128: 64 frequency slots in
    sections of 16 / 24 / 24 (t, h, w), against the JAX package's."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    assert layers.mrope_sections(128) == (16, 24, 24)
    x = rng(20).standard_normal((2, 9, 3, 128)).astype(np.float32)
    mp = _grid(9) * 7
    got = layers.apply_mrope(th(x), th(mp), 1.0e6)
    want = jlayers.apply_mrope(jx(x), jx(mp), 1.0e6)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_qwen2_vl_exact_decode_with_an_mrope_grid_matches_reference():
    """``serve_step`` with a grid whose rows differ: the exact path rotates
    by M-RoPE; ``make_serve_step`` passes the grid through."""
    jcfg, jp, cfg, model = _models("qwen2-vl-2b", seed=9)
    tokens = _tokens(cfg, seed=10, s=4)
    mp = _grid(7)[:, :, 6:7]
    got, want = _decode_both(jcfg, jp, cfg, model, tokens, mrope=mp)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    caches = model_lib.init_caches(cfg, batch=B, s_max=16, device="cpu")
    logits, _ = train.make_serve_step(cfg)(
        model, caches, {"tokens": th(tokens[:, :1]),
                        "pos": torch.zeros(B, dtype=torch.int32),
                        "mrope_positions": th(mp)})
    np.testing.assert_allclose(np_of(logits), got[:, 0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", NEW)
def test_model_trees_round_trip(arch):
    """``lm_params_from_numpy`` takes the reference tree (zamba2's
    top-level ``shared_attn`` and its units without a shared slot; the
    Mamba2, mLSTM and sLSTM mixers; whisper's ``encoder`` with its stacked
    blocks and the cross / cross_norm leaves), and ``lm_params_to_numpy``
    gives it back leaf for leaf; a train state maps both ways; AdamW
    decays the leaves the reference's ``ndim >= 2`` rule names in its own
    tree."""
    jcfg, jp, cfg, model = _models(arch)
    want = _np_tree(jp)
    got = lm_params_to_numpy(model, cfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    names = model_lib.param_tree(model)
    decayed = lm_decayed(names, cfg)
    want_decay = {jax.tree_util.keystr(p): np.ndim(l) >= 2
                  for p, l in flat_w}
    tree_decay = jax.tree_util.tree_flatten_with_path(lm_tree(
        {n: torch.tensor(d) for n, d in decayed.items()}, cfg))[0]
    assert {jax.tree_util.keystr(p): bool(d.all())
            for p, d in tree_decay} == want_decay
    state = {"params": model,
             "opt": optim.init_state(names)}
    back = train_state_from_tree(train_state_tree(state, cfg), cfg,
                                 device="cpu")
    for name, t in model_lib.param_tree(back["params"]).items():
        assert torch.equal(t, names[name]), name
    if arch == "zamba2-7b":
        assert "shared_attn.attn.wq" in names
        assert not any(n.startswith("blocks.2.") for n in names)
        assert model.blocks[2] is model.blocks[5] is model.shared_attn
    if arch == "whisper-tiny":
        assert "encoder.blocks.1.cross.wq" in names
        assert "blocks.0.cross_norm" in names


def test_shared_block_gradient_sums_over_its_slots():
    """zamba2's shared attention block is one set of weights at both of its
    slots: ``param_tree`` holds it once, its gradient is the sum of the
    gradients that two separate copies at the two slots get, and it equals
    the JAX package's; one train step updates it once, for both slots."""
    jcfg, jp, cfg, model = _models("zamba2-7b", seed=3)
    jb = _jbatch(jcfg, 4)
    batch = {k: th(v) for k, v in jb.items()}
    _, grads = train.value_and_grad(model, batch, cfg)
    shared = {n: g for n, g in grads.items() if n.startswith("shared_attn.")}
    assert shared and len(grads) == len(model_lib.param_tree(model))

    split = copy.deepcopy(model)
    split.blocks[5] = copy.deepcopy(split.shared_attn)
    split_names = model_lib.param_tree(split)
    assert "blocks.5.attn.wq" in split_names
    params = list(split_names.values())
    for p in params:
        p.requires_grad_(True)
    loss = model_lib.loss_fn(split, batch, cfg)
    per = dict(zip(split_names, torch.autograd.grad(loss, params)))
    for name, g in shared.items():
        tail = name[len("shared_attn."):]
        total = per[name] + per[f"blocks.5.{tail}"]
        np.testing.assert_allclose(np_of(g), np_of(total), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    _, jgrads = _jgrad(jcfg)(jp, {k: jx(v) for k, v in jb.items()})
    jwq = np.asarray(jgrads["shared_attn"]["attn"]["wq"])
    np.testing.assert_allclose(np_of(shared["shared_attn.attn.wq"]), jwq,
                               rtol=0, atol=GRAD_RTOL * np.abs(jwq).max())

    step = train.make_train_step(cfg, optim.AdamWConfig(lr=1e-3))
    opt = optim.init_state(model_lib.param_tree(model))
    before = model.shared_attn.attn.wq.clone()
    model, opt, _ = step(model, opt, batch)
    assert not torch.equal(model.shared_attn.attn.wq, before)
    assert model.blocks[2].attn.wq is model.blocks[5].attn.wq
    assert int(opt.step) == 1 and "shared_attn.attn.wq" in opt.m


ENGINE_CASES = [
    # (arch, what the new cache kind is)
    ("zamba2-7b", "Mamba2 conv windows and state; shared-attention slots"),
    ("gemma3-1b", "ring buffers beside aggregated global layers"),
    ("xlstm-350m", "mLSTM and sLSTM states (no aggregated layer)"),
    ("whisper-tiny", "self and cross caches"),
]


@pytest.mark.parametrize("arch", [a for a, _ in ENGINE_CASES])
def test_engine_insert_places_each_cache_kind(arch):
    """``DecodeEngine.insert`` copies every leaf of a batch-1 prefix into
    its slot, as the JAX package's ``_insert_jit`` places them by shape:
    two prompts of other lengths (one past gemma3's 8-slot ring) inserted
    into slots 2 and 0 of three decode as each decodes alone (rf 1.0:
    tokens equal, logits within TOL)."""
    cfg = get_config(arch, smoke=True).with_(agg_kv=True, agg_compression=4)
    model = model_lib.init_params(cfg, torch.Generator().manual_seed(11),
                                  device="cpu")
    lsh = model_lib.draw_lsh(cfg, torch.Generator().manual_seed(12),
                             device="cpu")
    prompts = [rng(13).integers(0, cfg.vocab_size, n) for n in (5, 11)]
    engine = DecodeEngine(model, cfg, max_slots=3, s_max=32, lsh=lsh)
    for slot, p in zip((2, 0), prompts):
        engine.insert(engine.prefill(p), slot)
    outs = [engine.generate_step(1.0) for _ in range(4)]
    for slot, p in zip((2, 0), prompts):
        alone = DecodeEngine(model, cfg, max_slots=1, s_max=32, lsh=lsh)
        alone.insert(alone.prefill(p), 0)
        for toks, logits in outs:
            a_tok, a_logits = alone.generate_step(1.0)
            assert int(toks[slot]) == int(a_tok[0])
            np.testing.assert_allclose(np_of(logits[slot]),
                                       np_of(a_logits[0]), rtol=TOL,
                                       atol=TOL)


def test_whisper_cross_caches_stay_zero_and_add_nothing():
    """A recorded difference of the reference (ROADMAP queue 3): the JAX
    package's ``init_caches`` zero-initialises the cross-attention caches
    and nothing fills them from the encoder, so decode's cross-attention
    reads zeros (uniform weights over zero values) and adds nothing.  The
    port does the same: the caches stay zero, and zeroing the cross
    weights changes no decode logit, while it does change the forward's."""
    jcfg, jp, cfg, model = _models("whisper-tiny", seed=14)
    tokens = _tokens(cfg, seed=15, s=5)
    jcaches = jinit_caches(jax.random.PRNGKey(0), jcfg, batch=B, s_max=16)
    assert all(float(np.abs(np.asarray(t)).max()) == 0.0
               for t in jax.tree_util.tree_leaves(jcaches["cross"]))
    got, want = _decode_both(jcfg, jp, cfg, model, tokens)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    caches = model_lib.init_caches(cfg, batch=B, s_max=16, device="cpu")
    for t in range(tokens.shape[1]):
        model_lib.serve_step(model, caches, th(tokens[:, t:t + 1]),
                             torch.full((B,), t, dtype=torch.int32), cfg)
    assert all(float(kv.abs().max()) == 0.0
               for c in caches for kv in c["cross"])
    blind = copy.deepcopy(model)
    for blk in blind.blocks:
        for p in blk.cross.parameters():
            p.data.zero_()
    got_blind, _ = _decode_both(jcfg, jp, cfg, blind, tokens)
    np.testing.assert_array_equal(got_blind, got)
    frames = th(_frames(cfg, s=6))
    assert float((model_lib.forward(model, th(tokens), cfg, frames=frames)
                  - model_lib.forward(blind, th(tokens), cfg,
                                      frames=frames)).abs().max()) > 1e-3


def test_chip_smoke_arch_phase_runs_on_the_cpu(monkeypatch):
    """The card's arch phase at the five models' smoke widths, with its
    checks (one attention launch and one selection an aggregated layer, a
    prefill token and a decode step: 2 for zamba2, 2 for gemma3, 2 for
    qwen2-vl and whisper, none for xLSTM; each guard's tokens and logits
    against ``forward``, gemma3's past its 8-token window, or whisper's
    exact decode), counting plain versions in place of the kernels; then
    its small check with the CPU on both sides."""
    from _torch_parity import chip_smoke, plain_kernels
    from repro_torch.kernels import ops

    cs = chip_smoke()
    plain_kernels(monkeypatch)
    rows = [row for row in cs.DECODE_MODELS if row.phase == "arch"]
    models = {row.arch: get_config(row.arch, smoke=True) for row in rows}
    probe, jobs = cs.CaptureProbe(torch, clone=True), {}
    summary, counts = cs.decode_phase(
        torch, ops, probe, jobs, "arch", models=models, dev="cpu",
        prompt_len=10, s_max=64,
        guard_prompt={"gemma3-1b": 12, "zamba2-7b": 9, "xlstm-350m": 9,
                      "qwen2-vl-2b": 9, "whisper-tiny": 9})
    assert set(summary) == {*models, "phase_s"}
    for row in rows:
        xlstm = row.arch == "xlstm-350m"
        assert summary[row.arch]["aggregated_layers"] == (0 if xlstm else 2)
        for layout in row.layouts:
            lv = summary[row.arch][layout]["levels"]
            # without an aggregated layer every level would run the same work
            assert set(lv) == ({"1.0"} if xlstm else
                               {str(rf) for rf in cs.DECODE_SWEEP})
            assert lv["1.0"]["token_agreement"] == 1.0
            assert summary[row.arch]["guard"][layout]["tokens_equal"]
    assert summary["whisper-tiny"]["guard"]["flat"]["exact"] == \
        "exact decode"
    assert summary["gemma3-1b"]["guard"]["flat"]["exact"] == "forward"
    assert jobs["arch xlstm-350m flat rf=1.0"]["launches"] == {
        "distance_topk": 0, "aggregated_attention_decode": 0}
    assert jobs["arch zamba2-7b flat rf=1.0"]["launches"][
        "aggregated_attention_decode"] == 2 * cs.DECODE_STEPS
    for op in ("distance_topk", "agg_refine_attention",
               "aggregated_attention_decode"):
        assert counts[op] > 0 and probe.calls[op]
    # gemma3's one KV head of four query heads reached the kernels' rows
    g3 = models["gemma3-1b"]
    assert any(args[0].shape[1:] == (g3.n_heads, g3.head_dim)
               for args, _ in probe.calls["aggregated_attention_decode"]
               .values())
    cs.lm_small_check(torch, archs=list(models), devs=("cpu", "cpu"))
