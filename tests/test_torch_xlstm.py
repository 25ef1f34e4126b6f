"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and the scan they
train with (``layers.checkpointed_scan``) against the JAX package's, on
the CPU, on the same numpy inputs.

Replayed: ``tests/test_models.py::test_checkpointed_scan_matches_scan``
(carry and outputs 1e-6, gradients 1e-5, the reference test's
tolerances; against the JAX package's ``checkpointed_scan`` ``TOL``).
Added: the mLSTM and sLSTM steps, blocks and decodes against the JAX
package's within ``TOL`` (2e-5) in float32, the sLSTM's bf16
recurrence (``h`` cast to the recurrent weight's dtype on every step, so a
bf16 model rounds there as the reference does), and the states' start
(the stabiliser at -1e30, whose ``exp(-m)`` enters the mLSTM's
denominator).  ``F.logsigmoid`` stands for ``jax.nn.log_sigmoid``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import normal, np_of, rng, th
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers, xlstm

TOL = 2e-5
jx = jnp.asarray


def test_checkpointed_scan_matches_scan():
    """``test_models.py:228`` on the port: the chunked, checkpointed scan
    equals a plain loop (the reference's ``lax.scan``) in carry, outputs
    and gradient, and the JAX package's ``checkpointed_scan``."""
    xs = normal(rng(0), 64, 3)

    def step(c, x):
        c = torch.tanh(c + x)
        return c, c

    def loop(xs_):
        c, ys = torch.zeros(3, dtype=xs_.dtype), []
        for t in range(xs_.shape[0]):
            c, y = step(c, xs_[t])
            ys.append(y)
        return c, torch.stack(ys)

    want_c, want_ys = loop(th(xs))
    got_c, got_ys = layers.checkpointed_scan(step, torch.zeros(3), th(xs),
                                             chunk=16)
    np.testing.assert_allclose(np_of(got_c), np_of(want_c), rtol=1e-6)
    np.testing.assert_allclose(np_of(got_ys), np_of(want_ys), rtol=1e-6)
    jstep = lambda c, x: (jnp.tanh(c + x),) * 2
    ref_c, ref_ys = jlayers.checkpointed_scan(jstep, jnp.zeros(3), jx(xs),
                                              chunk=16)
    # across the packages: torch's and XLA's tanh differ in the last bits
    np.testing.assert_allclose(np_of(got_ys), np.asarray(ref_ys), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(np_of(got_c), np.asarray(ref_c), rtol=TOL,
                               atol=TOL)
    # gradient parity, through the recomputed chunks
    t1, t2 = th(xs).requires_grad_(True), th(xs).requires_grad_(True)
    loop(t1)[1].sum().backward()
    layers.checkpointed_scan(step, torch.zeros(3), t2, chunk=16)[1] \
        .sum().backward()
    np.testing.assert_allclose(np_of(t2.grad), np_of(t1.grad), rtol=1e-5)


def test_checkpointed_scan_takes_nests_and_halves_its_chunk():
    """A tuple carry and dict inputs over S = 12 with chunk 8 (halved to
    4), against a loop."""
    r = rng(1)
    xs = {"a": th(normal(r, 12, 2)), "b": th(normal(r, 12, 2))}

    def step(carry, x):
        s, n = carry
        s = s * 0.5 + x["a"] * x["b"]
        return (s, n + 1.0), {"s": s, "n": n}

    init = (torch.zeros(2), torch.zeros(()))
    (s, n), ys = layers.checkpointed_scan(step, init, xs, chunk=8)
    carry, outs = init, []
    for t in range(12):
        carry, y = step(carry, {k: v[t] for k, v in xs.items()})
        outs.append(y)
    assert torch.equal(s, carry[0]) and float(n) == 12.0
    assert torch.equal(ys["s"], torch.stack([o["s"] for o in outs]))
    assert ys["n"].shape == (12,)


def _mixers(seed, dtype="float32"):
    """(JAX cfg, JAX mLSTM params, JAX sLSTM params, port cfg, port mLSTM,
    port sLSTM) of xlstm-350m's smoke blocks, the JAX weights carried
    across; the gate biases given values."""
    jcfg = jget_config("xlstm-350m", smoke=True).with_(dtype=dtype)
    cfg = get_config("xlstm-350m", smoke=True).with_(dtype=dtype)
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    r = rng(seed + 50)
    units = jp["units"]
    b_if = normal(r, 2 * cfg.n_heads)
    bias = normal(r, 4 * cfg.d_model) * 0.5
    units["b0"]["mixer"]["b_if"] = jnp.stack([jx(b_if)] * 2)
    units["b1"]["mixer"]["bias"] = jnp.stack([jx(bias)] * 2)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 cfg, device="cpu")
    first = jax.tree_util.tree_map(lambda t: t[0], units)
    return (jcfg, first["b0"]["mixer"], first["b1"]["mixer"], cfg,
            model.blocks[0].mixer, model.blocks[1].mixer)


def test_empty_states_start_the_stabiliser_at_minus_1e30():
    cfg = get_config("xlstm-350m", smoke=True)
    c, n, m = xlstm.mlstm_empty_state(2, cfg)
    assert c.shape == (2, 4, 16, 16) and n.shape == (2, 4, 16)
    assert m.dtype == torch.float32 and bool((m == -1e30).all())
    *zeros, ms = xlstm.slstm_empty_state(2, cfg)
    assert all(float(z.abs().sum()) == 0.0 for z in zeros)
    assert bool((ms == -1e30).all())
    for got, want in zip((c, n, m), jxlstm.mlstm_empty_state(2, cfg)):
        np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_mlstm_step_matches_reference_from_the_empty_state():
    """The first step from m = -1e30: ``exp(-m_new)`` in the denominator,
    the input gate's full weight; then a second step."""
    cfg = get_config("xlstm-350m", smoke=True)
    r = rng(2)
    b, h, dk = 2, cfg.n_heads, cfg.d_model // cfg.n_heads
    state = xlstm.mlstm_empty_state(b, cfg)
    jstate = jxlstm.mlstm_empty_state(b, cfg)
    for _ in range(2):
        ins = (normal(r, b, h, dk), normal(r, b, h, dk), normal(r, b, h, dk),
               normal(r, b, h) * 3, normal(r, b, h) * 3)
        state, h_t = xlstm.mlstm_step(state, tuple(th(a) for a in ins))
        jstate, jh = jxlstm.mlstm_step(jstate, tuple(jx(a) for a in ins))
        np.testing.assert_allclose(np_of(h_t), np.asarray(jh), rtol=TOL,
                                   atol=TOL)
        for got, want in zip(state, jstate):
            np.testing.assert_allclose(np_of(got), np.asarray(want),
                                       rtol=TOL, atol=TOL)


def test_xlstm_blocks_match_reference():
    jcfg, jm, js, cfg, m, s = _mixers(3)
    x = normal(rng(4), 2, 10, cfg.d_model)
    np.testing.assert_allclose(
        np_of(xlstm.mlstm_block(m, th(x), cfg)),
        np.asarray(jxlstm.mlstm_block(jm, jx(x), jcfg)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        np_of(xlstm.slstm_block(s, th(x), cfg)),
        np.asarray(jxlstm.slstm_block(js, jx(x), jcfg)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_xlstm_decodes_match_reference(dtype, tol):
    """Both decodes step by step, their states updated in place, against
    the JAX package's: in bf16 the sLSTM casts ``h`` to bf16 on every
    step, as there."""
    jcfg, jm, js, cfg, m, s = _mixers(5, dtype)
    tdt = layers.torch_dtype(dtype)
    b, steps = 2, 5
    xs = normal(rng(6), b, steps, cfg.d_model)
    ms, ss = xlstm.mlstm_empty_state(b, cfg), xlstm.slstm_empty_state(b, cfg)
    jms, jss = jxlstm.mlstm_empty_state(b, cfg), \
        jxlstm.slstm_empty_state(b, cfg)
    held = ss[2]
    for t in range(steps):
        xt = xs[:, t:t + 1]
        got_m = xlstm.mlstm_decode(m, th(xt).to(tdt), cfg, ms)
        got_s = xlstm.slstm_decode(s, th(xt).to(tdt), cfg, ss)
        want_m, jms = jxlstm.mlstm_decode(jm, jx(xt).astype(jcfg.dtype),
                                          jcfg, state=jms)
        want_s, jss = jxlstm.slstm_decode(js, jx(xt).astype(jcfg.dtype),
                                          jcfg, state=jss)
        for got, want in ((got_m, want_m), (got_s, want_s)):
            assert got.dtype == tdt
            np.testing.assert_allclose(np_of(got.float()),
                                       np.asarray(want.astype(jnp.float32)),
                                       rtol=tol, atol=tol)
    assert ss[2] is held        # in place
    for got, want in zip((*ms, *ss), (*jms, *jss)):
        np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=tol,
                                   atol=tol)
