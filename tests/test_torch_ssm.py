"""The port's Mamba2 blocks (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU, on the same numpy inputs.

Replayed: ``tests/test_models.py::test_ssd_chunked_matches_recurrence``
(groups 1 and 2, 2e-4, the reference test's tolerance), on the port and
against the JAX package's ``ssd_chunked``.  Added: ``_causal_conv``,
``_segsum``, ``mamba_block`` (a chunk halved to divide S) and
``mamba_decode`` step by step against the JAX package's, in float32 within
``TOL`` (2e-5) and in bfloat16 (the convolution and projections in the
model dtype, ``dt``, the SSD and the state in float32), and the decode
cache's dtypes.

``jax.nn.softplus`` is ``log1p(exp(-|x|)) + max(x, 0)``; ``F.softplus``
takes its linear branch past 20, where the two differ by under exp(-20),
below float32's resolution at 20: the comparisons run ``dt`` through both
sides of that threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import normal, np_of, rng, th
from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers
from repro_torch.models import ssm
from repro.models import init_params as jinit_params

TOL = 2e-5
SSD_TOL = 2e-4
jx = jnp.asarray


def _ssd_inputs(seed, g, bsz=2, s=64, h=4, p=8, n=16):
    r = rng(seed)
    xh = normal(r, bsz, s, h, p)
    dt = np.log1p(np.exp(normal(r, bsz, s, h)))
    a = -np.exp(normal(r, h))
    return xh, dt.astype(np.float32), a.astype(np.float32), \
        normal(r, bsz, s, g, n), normal(r, bsz, s, g, n)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_recurrence(g):
    """``test_models.py:113`` on the port: the chunked SSD equals the
    token-by-token state recurrence (2e-4), and the JAX package's
    ``ssd_chunked`` on the same inputs (2e-5)."""
    xh, dt, a, b_, c_ = _ssd_inputs(0, g)
    bsz, s, h, p = xh.shape
    n = b_.shape[-1]
    rep = h // g
    bf = np.repeat(b_, rep, axis=2)
    cf = np.repeat(c_, rep, axis=2)
    state = np.zeros((bsz, h, n, p), np.float64)
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None, :])
        state = state * decay[..., None, None] + np.einsum(
            "bhn,bhp->bhnp", bf[:, t], xh[:, t] * dt[:, t][..., None])
        ys.append(np.einsum("bhnp,bhn->bhp", state, cf[:, t]))
    want = np.stack(ys, 1)
    got = np_of(ssm.ssd_chunked(th(xh), th(dt), th(a), th(b_), th(c_),
                                chunk=16))
    np.testing.assert_allclose(got, want, rtol=SSD_TOL, atol=SSD_TOL)
    ref = np.asarray(jssm.ssd_chunked(jx(xh), jx(dt), jx(a), jx(b_), jx(c_),
                                      chunk=16))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_segsum_and_causal_conv_match_reference():
    r = rng(1)
    x = normal(r, 3, 2, 9)
    np.testing.assert_allclose(np_of(ssm._segsum(th(x))),
                               np.asarray(jssm._segsum(jx(x))), rtol=1e-6,
                               atol=1e-6)
    seq, w, b = normal(r, 2, 11, 6), normal(r, 4, 6), normal(r, 6)
    np.testing.assert_allclose(
        np_of(ssm._causal_conv(th(seq), th(w), th(b))),
        np.asarray(jssm._causal_conv(jx(seq), jx(w), jx(b))),
        rtol=TOL, atol=TOL)


def _mamba(seed, dtype="float32", dt_bias=(8.0, 3.0)):
    """(JAX cfg, JAX block params, port cfg, port block) of zamba2's smoke
    Mamba2 block, the JAX weights carried across; ``dt_bias`` the mean and
    spread of dt's offsets."""
    jcfg = jget_config("zamba2-7b", smoke=True).with_(dtype=dtype)
    cfg = get_config("zamba2-7b", smoke=True).with_(dtype=dtype)
    jp = jinit_params(jax.random.PRNGKey(seed), jcfg)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 cfg, device="cpu")
    jmix = jax.tree_util.tree_map(lambda t: t[0], jp["units"]["b0"])["mixer"]
    # give the biases and dt's offset values, so the comparisons see them
    r = rng(seed + 100)
    over = {"conv_bias_x": normal(r, *jmix["conv_bias_x"].shape) * 0.1,
            "conv_bias_bc": normal(r, *jmix["conv_bias_bc"].shape) * 0.1,
            "dt_bias": normal(r, *jmix["dt_bias"].shape) * dt_bias[1]
            + dt_bias[0]}
    jmix = {**jmix, **{k: jx(v).astype(jmix[k].dtype)
                       for k, v in over.items()}}
    mix = model.blocks[0].mixer
    for k, v in over.items():
        getattr(mix, k).data.copy_(th(v).to(getattr(mix, k).dtype))
    return jcfg, jmix, cfg, mix


@pytest.mark.parametrize("s", [16, 12])
def test_mamba_block_matches_reference(s):
    """The full-sequence block, with a chunk that divides S (16) and one
    halved from 128 to 4 (12); the dt offsets put softplus's inputs both
    sides of 20."""
    jcfg, jmix, cfg, mix = _mamba(2, dt_bias=(14.0, 6.0))
    x = normal(rng(3), 2, s, cfg.d_model)
    dt = np.asarray(jx(x) @ jmix["in_dt"]) + np.asarray(jmix["dt_bias"])
    assert (dt > 20).any() and (dt < 20).any()
    got = ssm.mamba_block(mix, th(x), cfg)
    want = jssm.mamba_block(jmix, jx(x), jcfg)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_mamba_block_chunk_halves_to_divide_the_sequence():
    """``ssm.py:177``: the chunk is halved until it divides S; a chunk of
    1 (S prime) is the plain recurrence, and still the JAX package's
    answer."""
    jcfg, jmix, cfg, mix = _mamba(4)
    x = normal(rng(5), 1, 7, cfg.d_model)
    np.testing.assert_allclose(
        np_of(ssm.mamba_block(mix, th(x), cfg, chunk=128)),
        np.asarray(jssm.mamba_block(jmix, jx(x), jcfg, chunk=128)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_mamba_decode_steps_match_reference(dtype, tol):
    """``mamba_decode`` step by step: the conv windows move in place, the
    state runs in float32 whatever the model dtype, and every output
    agrees with the JAX package's (bf16: the model dtype's resolution)."""
    jcfg, jmix, cfg, mix = _mamba(6, dtype)
    b, steps = 2, 6
    xs = normal(rng(7), b, steps, cfg.d_model)
    jcache = (jnp.zeros((b, cfg.ssm_conv - 1, 2 * cfg.d_model),
                        jcfg.dtype),
              jnp.zeros((b, cfg.ssm_conv - 1, 2 * cfg.ssm_state),
                        jcfg.dtype))
    jstate = jnp.zeros((b, 2 * cfg.d_model // cfg.ssm_head_dim,
                        cfg.ssm_state, cfg.ssm_head_dim), jnp.float32)
    tdt = layers.torch_dtype(dtype)
    cache = ssm.empty_state(cfg, b, dtype=tdt, device=torch.device("cpu"))
    assert cache["conv"][0].dtype == tdt and cache["state"].dtype == \
        torch.float32
    for t in range(steps):
        xt = xs[:, t:t + 1]
        want, jcache, jstate = jssm.mamba_decode(
            jmix, jx(xt).astype(jcfg.dtype), jcfg, conv_cache=jcache,
            ssm_state=jstate)
        got = ssm.mamba_decode(mix, th(xt).to(tdt), cfg, cache)
        assert got.dtype == tdt
        np.testing.assert_allclose(np_of(got.float()),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(np_of(cache["state"]), np.asarray(jstate),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np_of(cache["conv"][1].float()),
                               np.asarray(jcache[1].astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_mamba_decode_equals_the_block_over_the_sequence():
    """Token-by-token decode from an empty cache equals the chunked block
    over the same tokens (the SSD is the recurrence, 2e-4)."""
    _, _, cfg, mix = _mamba(8)
    x = normal(rng(9), 2, 16, cfg.d_model)
    full = np_of(ssm.mamba_block(mix, th(x), cfg, chunk=4))
    cache = ssm.empty_state(cfg, 2, dtype=torch.float32,
                            device=torch.device("cpu"))
    dec = np.concatenate([np_of(ssm.mamba_decode(mix, th(x[:, t:t + 1]), cfg,
                                                 cache))
                          for t in range(16)], axis=1)
    np.testing.assert_allclose(dec, full, rtol=SSD_TOL, atol=SSD_TOL)
