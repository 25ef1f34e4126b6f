"""The port's training path (``repro_torch.models`` full-sequence attention,
``forward`` / ``loss_fn`` / ``prefill``, ``repro_torch.optim``,
``repro_torch.data.pipeline`` and ``repro_torch.launch.train``), held
against the JAX package on the same numpy inputs, on the CPU, and the
optimizer and pipeline scenarios of ``tests/test_substrate.py`` replayed
on the port.

Tolerances: blockwise attention's forward and gradients 2e-5 (the JAX
package's attention tolerance, ``tests/test_kernels.py``); full-sequence
attention and prefill 2e-5; the loss 1e-5 and every gradient leaf 1e-4
relative to its largest entry; AdamW and the schedule 1e-6; top-k
compression and the token pipeline to the bit.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import normal, np_of, rng, th
from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.convert import (
    lm_decayed, lm_named, lm_params_from_numpy, lm_tree,
)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models import model as model_lib

ROOT = Path(__file__).resolve().parent.parent
ATTN_TOL = 2e-5
LOSS_TOL = 1e-5
# A gradient entry under this fraction of its leaf's largest is rounding
# noise of the two packages' sums (the three-step train-step test).
ROUNDING_GRAD = 1e-5
GRAD_RTOL = 1e-4
OPT_TOL = 1e-6
ARCH = "qwen3-8b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_model(seed=0, cfg_name=ARCH, **over):
    """(reference params as numpy, the port's LM from them, port cfg,
    reference cfg), on the CPU."""
    jcfg = jget_config(cfg_name, smoke=True).with_(**over)
    cfg = get_config(cfg_name, smoke=True).with_(**over)
    tree = _np_tree(jmodel.init_params(jax.random.PRNGKey(seed), jcfg))
    return tree, lm_params_from_numpy(tree, cfg, device="cpu"), cfg, jcfg


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                 1e-30))


def _tokens(seed, b, s, vocab):
    r = rng(seed)
    return (r.integers(0, vocab, (b, s)).astype(np.int32),
            r.integers(0, vocab, (b, s)).astype(np.int32))


# ---------------------------------------------------------------------------
# blockwise attention and its backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,dv,s", [
    (True, None, 16, 64),      # causal
    (True, 24, 16, 64),        # a sliding window
    (False, None, 16, 64),     # full
    (True, None, 24, 64),      # dv != hd
    (True, 20, 24, 48),        # a chunk that is halved to divide S
])
def test_blockwise_sdpa_forward_and_vjp_parity(causal, window, dv, s):
    b, hkv, g, hd = 2, 2, 2, 16
    r = rng(11)
    q, k, v = normal(r, b, s, hkv, g, hd), normal(r, b, s, hkv, hd), \
        normal(r, b, s, hkv, dv)
    ct = normal(r, b, s, hkv * g, dv)
    opts = dict(scale=1.0 / math.sqrt(hd), causal=causal, window=window,
                q_chunk=16, kv_chunk=32)

    want, vjp = jax.vjp(
        lambda q_, k_, v_: jlayers.blockwise_sdpa(q_, k_, v_, **opts),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(ct))

    tq, tk, tv = (th(a).requires_grad_(True) for a in (q, k, v))
    got = layers.blockwise_sdpa(tq, tk, tv, **opts)
    got.backward(th(ct))
    np.testing.assert_allclose(np_of(got), np.asarray(want),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(np_of(t.grad), np.asarray(w),
                                   rtol=ATTN_TOL, atol=ATTN_TOL, err_msg=name)


def test_blockwise_skips_masked_block_pairs():
    qc, kc, pairs = layers._bw_chunks(64, 64, 16, 32, True, None)
    assert (qc, kc) == (16, 32)
    # causal: q chunk 0 sees kv chunk 0 only, q chunk 2 both
    assert pairs == [(0, 0), (1, 0), (2, 0), (2, 1), (3, 0), (3, 1)]
    _, _, windowed = layers._bw_chunks(64, 64, 16, 32, True, 8)
    assert (3, 0) not in windowed and (3, 1) in windowed
    assert layers._bw_chunks(48, 48, 16, 32, False, None)[:2] == (16, 16)


@pytest.mark.parametrize("s", [64, layers._BLOCKWISE_THRESHOLD])
def test_attention_below_and_at_the_blockwise_threshold(s):
    assert layers._BLOCKWISE_THRESHOLD == jlayers._BLOCKWISE_THRESHOLD
    tree, model, cfg, jcfg = _ref_model()
    x = normal(rng(12), 1, s, cfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (1, s))
    jattn = jax.tree_util.tree_map(lambda a: a[0], tree["units"]["b0"]["attn"])
    want = jlayers.attention(jattn, jnp.asarray(x), jcfg,
                             positions=jnp.asarray(pos))
    got = layers.attention(model.blocks[0].attn, th(x), cfg,
                           positions=th(pos))
    np.testing.assert_allclose(np_of(got), np.asarray(want),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


def test_dense_sdpa_masks_parity():
    s = 12
    np.testing.assert_array_equal(np_of(layers.causal_mask(s)),
                                  np.asarray(jlayers.causal_mask(s)))
    np.testing.assert_array_equal(
        np_of(layers.sliding_window_mask(s, 4)),
        np.asarray(jlayers.sliding_window_mask(s, 4)))
    r = rng(13)
    q, k, v = normal(r, 2, s, 4, 8), normal(r, 2, s, 2, 8), \
        normal(r, 2, s, 2, 8)
    mask = np.asarray(jlayers.sliding_window_mask(s, 4))[None]
    want = jlayers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask), scale=0.3)
    got = layers._sdpa(th(q), th(k), th(v), th(mask), scale=0.3)
    np.testing.assert_allclose(np_of(got), np.asarray(want),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# forward, loss and its gradients, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradients_parity(masked):
    tree, model, cfg, jcfg = _ref_model(seed=1)
    tokens, labels = _tokens(14, 2, 16, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": labels}
    if masked:
        batch["loss_mask"] = (rng(15).random((2, 16)) < 0.7).astype(
            np.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = train.value_and_grad(
        model, {k: th(v) for k, v in batch.items()}, cfg)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    got = dict(jax.tree_util.tree_flatten_with_path(lm_tree(grads, cfg))[0])
    want = jax.tree_util.tree_flatten_with_path(_np_tree(jgrads))[0]
    assert len(got) == len(want)
    for path, w in want:
        assert _rel_err(np_of(got[path]), w) <= GRAD_RTOL, path
    # no parameter is left asking for gradients
    assert not any(p.requires_grad for p in model.parameters())


def test_loss_with_and_without_remat_and_prefill_parity():
    tree, model, cfg, jcfg = _ref_model(seed=2)
    tokens, labels = _tokens(16, 2, 12, cfg.vocab_size)
    batch = {"tokens": th(tokens), "labels": th(labels)}
    a = model_lib.loss_fn(model, batch, cfg, remat=True)
    b = model_lib.loss_fn(model, batch, cfg, remat=False)
    assert float(a) == float(b)
    want = jmodel.prefill(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(tokens), jcfg)
    got = model_lib.prefill(model, th(tokens), cfg)
    assert got.shape == (2, model_lib.padded_vocab(cfg))
    np.testing.assert_allclose(np_of(got), np.asarray(want),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    full = jmodel.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(tokens), jcfg)
    np.testing.assert_allclose(
        np_of(model_lib.forward(model, th(tokens), cfg)), np.asarray(full),
        rtol=ATTN_TOL, atol=ATTN_TOL)


def test_decode_matches_forward():
    """``tests/test_models.py::test_decode_matches_forward`` for qwen3-8b on
    the port: token-by-token ``serve_step`` equals the causal forward."""
    _, model, cfg, _ = _ref_model(seed=1)
    tokens, _ = _tokens(17, 2, 16, cfg.vocab_size)
    full = model_lib.forward(model, th(tokens), cfg)
    caches = model_lib.init_caches(cfg, batch=2, s_max=32, device="cpu")
    pos = torch.zeros(2, dtype=torch.int32)
    outs = []
    for t in range(tokens.shape[1]):
        logits, caches = model_lib.serve_step(model, caches,
                                              th(tokens[:, t:t + 1]), pos, cfg)
        outs.append(logits)
        pos = pos + 1
    dec = torch.stack(outs, dim=1)
    rel = float((full - dec).abs().max()) / float(full.abs().max())
    assert rel < 1e-4, rel


@pytest.mark.parametrize("cfg_name", ["gemma3-1b", "whisper-tiny",
                                      "qwen2-vl-2b", "zamba2-7b",
                                      "xlstm-350m"])
def test_loss_and_grads_of_every_block_kind_match_reference(cfg_name):
    """The loss and every gradient leaf of the sliding-window, encoder-
    decoder (with frames), M-RoPE (with a grid whose rows differ), Mamba2
    with shared attention and xLSTM stacks, remat on, as the JAX
    package's."""
    tree, model, cfg, jcfg = _ref_model(2, cfg_name)
    tokens, labels = _tokens(3, 2, 8, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.is_encoder_decoder:
        batch["frames"] = normal(rng(4), 2, 8, cfg.d_model)
    if cfg.mrope:
        t = np.arange(8)
        batch["mrope_positions"] = np.broadcast_to(
            np.stack([t, t // 2, t % 3])[:, None], (3, 2, 8)).astype(
            np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = train.value_and_grad(
        model, {k: th(v) for k, v in batch.items()}, cfg)
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    want = dict(jax.tree_util.tree_flatten_with_path(_np_tree(jgrads))[0])
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np_of, lm_tree(grads, cfg)))[0]
    assert len(got) == len(want)
    for path, g in got:
        assert _rel_err(g, want[path]) <= GRAD_RTOL, \
            jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# AdamW and gradient compression
# ---------------------------------------------------------------------------

def _opt_inputs(seed):
    r = rng(seed)
    params = {"w": normal(r, 6, 5), "b": normal(r, 5),
              "blk": [normal(r, 3, 4, 2), normal(r, 7)]}
    grads = [jax.tree_util.tree_map(lambda p: normal(r, *p.shape) * 3.0,
                                    params) for _ in range(3)]
    return params, grads


def test_adamw_three_steps_and_schedule_parity():
    jcfg = joptim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                              grad_clip=1.0)
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            grad_clip=1.0)
    params, grads = _opt_inputs(20)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(th, params)
    js, ts = joptim.init_state(jp), optim.init_state(tp)
    for g in grads:
        assert abs(float(optim.global_norm(jax.tree_util.tree_map(th, g)))
                   - float(joptim.global_norm(g))) <= OPT_TOL * 10
        jp, js = joptim.apply_updates(jp, jax.tree_util.tree_map(
            jnp.asarray, g), js, jcfg)
        tp, ts = optim.apply_updates(tp, jax.tree_util.tree_map(th, g), ts,
                                     cfg)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        flat_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np_of, got))
        flat_w = jax.tree_util.tree_leaves(want)
        for a, w in zip(flat_g, flat_w):
            np.testing.assert_allclose(a, np.asarray(w), rtol=OPT_TOL,
                                       atol=OPT_TOL)
    for step in (0, 1, 2, 3, 6, 10, 12):
        assert abs(float(optim.schedule(cfg, torch.tensor(step, dtype=torch
                                                          .int32)))
                   - float(joptim.schedule(jcfg, jnp.asarray(step)))) \
            <= OPT_TOL


def test_adamw_updates_parameters_and_moments_in_place():
    """The parameters and moments given are the ones returned, holding the
    step's values (a bf16 parameter stays bf16, its moments f32); the step
    counter is a new tensor."""
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1)
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16), "b": torch.ones(4)}
    st = optim.init_state(p)
    before = {k: v.clone() for k, v in p.items()}
    g = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    new, st2 = optim.apply_updates(p, g, st, cfg)
    assert new is p and st2.m is st.m and st2.v is st.v
    assert st.step.item() == 0 and st2.step.item() == 1
    assert new["w"].dtype == torch.bfloat16 and st2.m["w"].dtype == \
        torch.float32
    assert not torch.equal(p["w"], before["w"])
    # (1 - b1) x the clipped gradient: a norm of sqrt(20) clipped to 1
    assert torch.allclose(st.m["b"], torch.full((4,), 0.1 / 20 ** 0.5))


def test_adamw_reduces_quadratic():
    cfg = optim.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                            weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = optim.init_state(params)
    for _ in range(60):
        g = {"w": 2.0 * params["w"]}
        params, state = optim.apply_updates(params, g, state, cfg)
    assert float((params["w"] ** 2).sum()) < 0.05


def test_schedule_warmup_and_decay():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    assert float(optim.schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(optim.schedule(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert abs(float(optim.schedule(cfg, torch.tensor(100))) - 0.1) < 1e-6


def test_grad_clip():
    cfg = optim.AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = optim.init_state(params)
    g = {"w": torch.tensor([100.0, 0.0, 0.0])}
    _, state = optim.apply_updates(params, g, state, cfg)
    assert float(state.m["w"][0].abs()) <= (1 - cfg.b1) * 1.0 + 1e-6


@pytest.mark.parametrize("ties", [False, True])
def test_compress_topk_and_residual_parity(ties):
    r = rng(21)
    if ties:   # small integers: many magnitudes equal the threshold
        g = {"a": r.integers(-3, 4, 64).astype(np.float32),
             "b": r.integers(-3, 4, (8, 8)).astype(np.float32)}
    else:
        g = {"a": normal(r, 64), "b": normal(r, 8, 8)}
    jef = joptim.init_error_feedback(g)
    tef = optim.init_error_feedback(jax.tree_util.tree_map(th, g))
    for _ in range(2):
        jsent, jef, jstats = joptim.compress_topk(g, jef, frac=0.25)
        tsent, tef, tstats = optim.compress_topk(
            jax.tree_util.tree_map(th, g), tef, frac=0.25)
        assert tstats == jstats
        for key in g:
            np.testing.assert_array_equal(np_of(tsent[key]),
                                          np.asarray(jsent[key]))
            np.testing.assert_array_equal(np_of(tef.residual[key]),
                                          np.asarray(jef.residual[key]))


def test_error_feedback_conserves_information():
    r = rng(22)
    g = {"a": th(normal(r, 64)), "b": th(normal(r, 8, 8))}
    ef = optim.init_error_feedback(g)
    sent, ef2, stats = optim.compress_topk(g, ef, frac=0.25)
    for k in g:
        np.testing.assert_allclose(np_of(sent[k] + ef2.residual[k]),
                                   np_of(g[k]), rtol=1e-6)
        assert int((sent[k] != 0).sum()) <= max(1, int(0.25 * g[k].numel())) \
            + 1
    assert 0 < stats["kept_frac"] <= 0.3


def test_error_feedback_catches_up():
    g = {"w": torch.tensor([1.0, 0.9])}
    ef = optim.init_error_feedback(g)
    sent1, ef, _ = optim.compress_topk(g, ef, frac=0.5)
    assert float(sent1["w"][1]) == 0.0
    sent2, ef, _ = optim.compress_topk(g, ef, frac=0.5)
    assert float(sent2["w"][1]) == pytest.approx(1.8)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

def test_pipeline_batches_equal_the_reference_for_two_shards():
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    for shard in (0, 1):
        kw = dict(global_batch=8, seq_len=16, seed=1, shard_index=shard,
                  shard_count=2)
        jp, tp = JPipeline(jcfg, **kw), TokenPipeline(cfg, device="cpu",
                                                      **kw)
        for step in (0, 5):
            want, got = jp.batch_at(step), tp.batch_at(step)
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == torch.int32
                np.testing.assert_array_equal(np_of(got[key]),
                                              np.asarray(want[key]))
    b0 = TokenPipeline(cfg, global_batch=8, seq_len=16, seed=1,
                       shard_count=2, device="cpu").batch_at(5)
    assert b0["tokens"].shape == (4, 16)
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])


def test_pipeline_iterate_equals_the_reference():
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jit_, tit = (JPipeline(jcfg, global_batch=4, seq_len=8, seed=3)
                 .iterate(start_step=2),
                 TokenPipeline(cfg, global_batch=4, seq_len=8, seed=3,
                               device="cpu").iterate(start_step=2))
    for _ in range(3):
        want, got = next(jit_), next(tit)
        for key in want:
            np.testing.assert_array_equal(np_of(got[key]),
                                          np.asarray(want[key]))
    tit.close()
    jit_.close()


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.0, 0.25])
def test_train_step_three_steps_parity(frac):
    """Three steps of both packages' train steps on the same batches: every
    loss within 1e-5, and every parameter entry within 1e-5 but those
    whose first gradient (the JAX package's) is at rounding level, under
    ROUNDING_GRAD of its leaf's largest.  AdamW's first update of an entry
    is lr * g / (|g| + eps), about lr * sign(g), so where g is rounding
    noise the two packages' last bits can move that entry by up to 2 lr
    (one entry of ~115 k here); no other entry is exempt, in any leaf."""
    tree, model, cfg, jcfg = _ref_model(seed=3)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, joptim.AdamWConfig(**kw), grad_compress_frac=frac))
    tstep = train.make_train_step(cfg, optim.AdamWConfig(**kw),
                                  grad_compress_frac=frac)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = joptim.init_state(jp)
    ts = optim.init_state(model_lib.param_tree(model))
    jef = joptim.init_error_feedback(jp) if frac else None
    tef = train.init_error_feedback(model, cfg) if frac else None
    for step in range(3):
        tokens, labels = _tokens(30 + step, 2, 16, cfg.vocab_size)
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        tb = {"tokens": th(tokens), "labels": th(labels)}
        if step == 0:
            g1 = dict(jax.tree_util.tree_flatten_with_path(_np_tree(
                jax.grad(jmodel.loss_fn)(jp, jb, jcfg)))[0])
        if frac:
            jp, js, jef, jm = jstep(jp, js, jef, jb)
            model, ts, tef, tm = tstep(model, ts, tef, tb)
        else:
            jp, js, jm = jstep(jp, js, jb)
            model, ts, tm = tstep(model, ts, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL, step
    got = dict(jax.tree_util.tree_flatten_with_path(
        lm_tree(model_lib.param_tree(model), cfg))[0])
    n_exempt = 0
    for path, w in jax.tree_util.tree_flatten_with_path(_np_tree(jp))[0]:
        diff = np.abs(np_of(got[path]) - w)
        g = np.abs(g1[path])
        noise = g <= ROUNDING_GRAD * g.max()
        off = (diff > 1e-5) & ~noise
        assert not off.any(), (path, diff[off].max(), g[off].min())
        n_exempt += int(((diff > 1e-5) & noise).sum())
    assert n_exempt <= 4, n_exempt
    if frac:   # the residual is kept in the JAX package's layout
        paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
            jef.residual)[0]]
        assert paths == [p for p, _ in jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(np_of, tef.residual))[0]]


def test_weight_decay_follows_the_reference_tree():
    """AdamW decays a leaf of the JAX package's tree with ndim >= 2, and
    there a unit's leaves are stacked: ``convert.lm_decayed`` marks each of
    the port's parameters as its leaf in that tree is marked, so the units'
    norm weights are decayed and ``final_norm`` is not."""
    tree, model, cfg, _ = _ref_model()
    flags = jax.tree_util.tree_map(
        lambda w: np.full(np.shape(w), np.ndim(w) >= 2), tree)
    want = {name: bool(np.asarray(f).flat[0])
            for name, f in lm_named(flags, cfg).items()}
    got = lm_decayed(model_lib.param_tree(model), cfg)
    assert got == want
    assert got["blocks.0.norm1"] and not got["final_norm"]


def test_loss_decreases_on_repeated_batch():
    """``tests/test_arch_smoke.py::test_loss_decreases_on_repeated_batch``
    on the port, for qwen3-8b."""
    cfg = get_config(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(3)
    model = model_lib.init_params(cfg, gen, device="cpu")
    opt_state = optim.init_state(model_lib.param_tree(model))
    step = train.make_train_step(cfg, optim.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=40, weight_decay=0.0))
    batch = train.synth_batch(gen, cfg, batch=2, seq=16, device="cpu")
    losses = []
    for _ in range(25):
        model, opt_state, metrics = step(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_prefill_and_serve_step_factories():
    _, model, cfg, _ = _ref_model()
    tokens, _ = _tokens(40, 2, 8, cfg.vocab_size)
    logits = train.make_prefill_step(cfg)(model, {"tokens": th(tokens)})
    assert torch.equal(logits, model_lib.prefill(model, th(tokens), cfg))
    caches = model_lib.init_caches(cfg, batch=2, s_max=8, device="cpu")
    out, _ = train.make_serve_step(cfg)(
        model, caches, {"tokens": th(tokens[:, :1]),
                        "pos": torch.zeros(2, dtype=torch.int32)})
    assert out.shape == (2, model_lib.padded_vocab(cfg))


def test_train_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 3
    assert all(np.isfinite(float(l.split()[3])) for l in lines)


# ---------------------------------------------------------------------------
# chip_smoke.py's train and supervisor phases, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_train_phase_runs_on_the_cpu(monkeypatch):
    """The card's train phase at the smoke width, at its 2,048 tokens (the
    blockwise path), with its checks; the blockwise check at a small
    shape."""
    from _torch_parity import chip_smoke, plain_kernels

    cs = chip_smoke()
    plain_kernels(monkeypatch)
    summary = cs.train_phase(torch, get_config(ARCH, smoke=True),
                             dev="cpu", check_shape=(1, 256, 2, 2, 16))
    cs.print_train(summary, "cpu")
    # each step: the forward and the recomputation of each of 2 layers
    assert summary["blockwise_calls"] == 4 * (cs.TRAIN_STEPS
                                              + cs.TRAIN_REPEAT)
    assert summary["params"] == sum(
        p.numel() for p in model_lib.init_params(
            get_config(ARCH, smoke=True), torch.Generator(),
            device="cpu").parameters())


def test_chip_smoke_supervisor_phase_runs_on_the_cpu(monkeypatch):
    """The card's supervisor phase at the smoke width: restart, re-executed
    steps and final state to the bit, the async save, the manifest.  On one
    thread: MKL's products on several give bits that vary between two runs
    of the same steps."""
    from _torch_parity import chip_smoke, plain_kernels

    cs = chip_smoke()
    plain_kernels(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        summary = cs.supervisor_phase(torch, get_config(ARCH, smoke=True),
                                      dev="cpu")
    finally:
        torch.set_num_threads(threads)
    cs.print_supervisor(summary, "cpu")
    for name in ("plain", f"compress {cs.SUP_COMPRESS}"):
        assert summary[name]["report"]["restarts"] == 1
        assert len(summary[name]["losses"]) == cs.SUP_STEPS + 5
