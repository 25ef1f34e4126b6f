"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) and the
latent aggregated-KV decode (``transformer._attn_decode_aggkv``'s MLA arm)
against the JAX package's, on the CPU, at deepseek-v2-236b's smoke widths.

The JAX package draws the weights, the LSH projections and (through numpy
from a seed) the inputs; the port gets them by copy.  ``mla_attention``
below and at the blockwise threshold, ``mla_decode`` token by token with
its caches, and the latent aggregated decode in both cache layouts at
refine_frac 0, 0.25 and 1.0, with the caches it fills: within 2e-5 (the
reference's attention tolerance, ``tests/test_kernels.py``); bucket ids
and counts equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import normal, np_of, rng, th
from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.models import aggregated_kv, layers, mla, transformer

TOL = 2e-5
ARCH = "deepseek-v2-236b"
RFS = (0.0, 0.25, 1.0)
LAYOUTS = ("flat", "bucket_major")


def _configs(**over):
    return (jget_config(ARCH, smoke=True).with_(**over),
            get_config(ARCH, smoke=True).with_(**over))


def _copy_into(module: torch.nn.Module, tree) -> None:
    for name, prm in module.named_parameters():
        node = tree
        for part in name.split("."):
            node = node[part]
        prm.data.copy_(torch.tensor(np.asarray(node, np.float32)))


def _mla_pair(seed=0):
    jcfg, cfg = _configs()
    jp = jmla.mla_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    p = mla.MLA(layers.Init(None, dtype=torch.float32,
                            device=torch.device("cpu")), cfg)
    _copy_into(p, jp)
    return jcfg, cfg, jp, p


def _close(got, want, msg=""):
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=msg)


@pytest.mark.parametrize("b,s", [(2, 12), (1, jlayers._BLOCKWISE_THRESHOLD)])
def test_mla_attention_matches_reference(b, s):
    jcfg, cfg, jp, p = _mla_pair(1)
    assert layers._BLOCKWISE_THRESHOLD == jlayers._BLOCKWISE_THRESHOLD
    x = normal(rng(s), b, s, cfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    got = mla.mla_attention(p, th(x), cfg, positions=th(pos))
    want = jmla.mla_attention(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos))
    _close(got, want)


def test_mla_decode_matches_reference():
    jcfg, cfg, jp, p = _mla_pair(2)
    b, s_max, steps = 2, 16, 10
    xs = normal(rng(3), steps, b, 1, cfg.d_model)
    jc = jnp.zeros((b, s_max, cfg.kv_lora_rank))
    jkr = jnp.zeros((b, s_max, cfg.rope_head_dim))
    tc = torch.zeros(b, s_max, cfg.kv_lora_rank)
    tkr = torch.zeros(b, s_max, cfg.rope_head_dim)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        want, jc, jkr = jmla.mla_decode(jp, jnp.asarray(xs[t]), jcfg,
                                        cache_c=jc, cache_kr=jkr,
                                        pos=jnp.asarray(pos))
        got, tc2, tkr2 = mla.mla_decode(p, th(xs[t]), cfg, cache_c=tc,
                                        cache_kr=tkr, pos=th(pos))
        assert tc2 is tc and tkr2 is tkr          # updated in place
        _close(got, want, f"step {t}")
        _close(tc, jc, f"c at step {t}")
        _close(tkr, jkr, f"kr at step {t}")


def test_mla_decode_equals_full_sequence_attention():
    """The absorbed decode over a prefix equals the materialised attention
    at its last position (the identity the absorbed form rests on)."""
    _, cfg, _, p = _mla_pair(4)
    b, s = 2, 9
    x = th(normal(rng(5), b, s, cfg.d_model))
    full = mla.mla_attention(p, x, cfg, positions=torch.arange(s).expand(b,
                                                                          s))
    c = torch.zeros(b, 16, cfg.kv_lora_rank)
    kr = torch.zeros(b, 16, cfg.rope_head_dim)
    for t in range(s):
        out, _, _ = mla.mla_decode(p, x[:, t:t + 1], cfg, cache_c=c,
                                   cache_kr=kr,
                                   pos=torch.full((b,), t, dtype=torch.int32))
        _close(out[:, 0], np_of(full[:, t]), f"position {t}")


def _block_pair(jcfg, cfg, seed):
    jp = jtransformer.block_init(jax.random.PRNGKey(seed), jcfg, "attn",
                                 dtype=jnp.float32)
    p = transformer.block_init(
        layers.Init(None, dtype=torch.float32, device=torch.device("cpu")),
        cfg, "attn")
    _copy_into(p, jp)
    return jp, p


def _same_cache(got, want, msg):
    for name in ("k", "v", "bucket_of", "mean_k", "mean_v", "over_k",
                 "over_v", "counts"):
        if not hasattr(want, name):
            continue
        g, w = np_of(getattr(got, name)), np.asarray(getattr(want, name))
        if name in ("counts", "bucket_of"):
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{msg}: {name}")


@pytest.mark.parametrize("rf", RFS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_latent_aggregated_decode_matches_reference(layout, rf):
    jcfg, cfg = _configs(agg_kv=True, agg_layout=layout, agg_compression=2,
                         agg_refine_frac=rf)
    jp, p = _block_pair(jcfg, cfg, 6)
    b, s_max, steps = 2, 16, 14
    jcache = jtransformer.init_block_cache(
        jax.random.PRNGKey(7), jcfg, "attn", batch=b, s_max=s_max,
        dtype=jnp.float32)
    assert jcache.mean_k.shape[2:] == (1, cfg.kv_lora_rank
                                       + cfg.rope_head_dim)
    tcache = transformer.init_block_cache(
        cfg, "attn", batch=b, s_max=s_max, dtype=torch.float32,
        device=torch.device("cpu"),
        lsh=(th(np.asarray(jcache.lsh_a)), th(np.asarray(jcache.lsh_b))))
    hs = normal(rng(8), steps, b, 1, cfg.d_model)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        want, jcache = jtransformer._attn_decode_aggkv(
            jp, jnp.asarray(hs[t]), jcfg, jcache, jnp.asarray(pos))
        got, _ = transformer._attn_decode_aggkv(p, th(hs[t]), cfg, tcache,
                                                th(pos))
        _close(got, want, f"step {t}")
        _same_cache(tcache, jcache, f"step {t}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_latent_aggregated_decode_at_full_refine_is_the_exact_decode(layout):
    """rf 1.0 over the latent cache equals ``mla_decode`` (the
    reference's Algorithm 1 invariant, ``tests/test_models.py:64``)."""
    _, cfg = _configs(agg_kv=True, agg_layout=layout, agg_compression=2,
                      agg_refine_frac=1.0)
    _, p = _block_pair(*_configs(), 9)
    b, s_max = 2, 16
    n_kv, dk, _ = transformer.cache_dims(cfg)
    lsh = aggregated_kv.draw_lsh(torch.Generator().manual_seed(0), n_kv=n_kv,
                                 dk=dk)
    cache = transformer.init_block_cache(
        cfg, "attn", batch=b, s_max=s_max, dtype=torch.float32,
        device=torch.device("cpu"), lsh=lsh)
    c = torch.zeros(b, s_max, cfg.kv_lora_rank)
    kr = torch.zeros(b, s_max, cfg.rope_head_dim)
    hs = th(normal(rng(10), 12, b, 1, cfg.d_model))
    for t in range(12):
        pos = torch.full((b,), t, dtype=torch.int32)
        got, _ = transformer._attn_decode_aggkv(p, hs[t], cfg, cache, pos)
        want, _, _ = mla.mla_decode(p.attn, hs[t], cfg, cache_c=c,
                                    cache_kr=kr, pos=pos)
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")
    assert math.isfinite(float(got.abs().max()))
