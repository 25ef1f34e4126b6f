"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``), on the CPU.

Inputs are made with numpy from a seed; the JAX package draws the expert
weights and ``convert``-style copies carry them across.  Routing (the
probabilities, the renormalised top-k gates and the chosen experts) and
each expert's capacity-truncated selection are compared with ties built
in on purpose: ties go to the lowest index in both (``jax.lax.top_k``; the
port's stable sorts), so indices must be equal.  ``moe_dense`` at the two
MoE configs' smoke sizes, where some tokens overflow every chosen
expert's capacity and are dropped, within 1e-5 (float32 sums of the same
terms in the same expert order, the products in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from _torch_parity import normal, np_of, rng, th
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import layers, moe

TOL = 1e-5
ARCHS = ("deepseek-v2-236b", "moonshot-v1-16b-a3b")


def _configs(arch, **over):
    return (jget_config(arch, smoke=True).with_(**over),
            get_config(arch, smoke=True).with_(**over))


def _port_moe(jp, cfg) -> moe.MoE:
    """The port's ``MoE`` holding the JAX package's ``moe_init`` draws."""
    m = moe.MoE(layers.Init(None, dtype=layers.torch_dtype(cfg.dtype),
                            device=torch.device("cpu")), cfg)
    for name, prm in m.named_parameters():
        node = jp
        for part in name.split("."):
            node = node[part]
        prm.data.copy_(torch.tensor(np.asarray(node, np.float32)).to(
            prm.dtype))
    return m


def _tie_tokens(seed, t, d, *, repeat=3):
    """[T, d] tokens whose first ``repeat`` rows are the same, so their
    router scores tie exactly across tokens."""
    x = normal(rng(seed), t, d)
    x[1:repeat] = x[0]
    return x


def _tie_router(seed, d, e):
    """A router whose experts 1 and 2 copy expert 0's column and expert 5
    expert 4's: their probabilities tie exactly."""
    w = normal(rng(seed), d, e) / np.float32(np.sqrt(d))
    w[:, 1] = w[:, 2] = w[:, 0]
    w[:, 5 % e] = w[:, 4 % e]
    return w


@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_route_matches_reference_with_ties(top_k):
    xf, w = _tie_tokens(0, 12, 16), _tie_router(1, 16, 8)
    probs, gates, eidx = moe._route(th(w), th(xf), top_k)
    jprobs, jgates, jeidx = jmoe._route(jnp.asarray(w), jnp.asarray(xf),
                                        top_k)
    np.testing.assert_allclose(np_of(probs), np.asarray(jprobs), rtol=TOL,
                               atol=1e-7)
    np.testing.assert_allclose(np_of(gates), np.asarray(jgates), rtol=TOL,
                               atol=1e-7)
    np.testing.assert_array_equal(np_of(eidx), np.asarray(jeidx))
    # the tied experts really are among the chosen ones, lowest first
    if top_k > 1:
        first = np_of(eidx)[:, :2]
        assert ((first == [0, 1]) | (first == [4, 5])).all(axis=1).any()


@pytest.mark.parametrize("capacity", [1, 2, 5, 12])
def test_select_for_expert_matches_reference_with_ties(capacity):
    xf, w = _tie_tokens(2, 12, 16, repeat=5), _tie_router(3, 16, 8)
    probs, gates, eidx = moe._route(th(w), th(xf), 2)
    jr = jmoe._route(jnp.asarray(w), jnp.asarray(xf), 2)
    for e in range(8):
        got = moe._select_for_expert(probs, gates, eidx, e, capacity)
        want = jmoe._select_for_expert(*jr, e, capacity)
        np.testing.assert_array_equal(np_of(got[0]), np.asarray(want[0]),
                                      err_msg=f"token_idx of expert {e}")
        np.testing.assert_allclose(np_of(got[1]), np.asarray(want[1]),
                                   rtol=TOL, atol=1e-7)
        np.testing.assert_array_equal(np_of(got[2]), np.asarray(want[2]))


def test_select_for_experts_equals_one_expert_at_a_time():
    xf, w = _tie_tokens(4, 10, 16), _tie_router(5, 16, 8)
    r = moe._route(th(w), th(xf), 2)
    many = moe._select_for_experts(*r, torch.arange(8), 3)
    for e in range(8):
        one = moe._select_for_expert(*r, e, 3)
        for a, b in zip(many, one):
            assert torch.equal(a[e], b)


def _moe_case(arch, seed, t, **over):
    jcfg, cfg = _configs(arch, **over)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    x = normal(rng(seed), 2, t // 2, cfg.d_model)
    return jcfg, cfg, jp, _port_moe(jp, cfg), x


def _dropped(cfg, x, m) -> int:
    """Tokens with at least one chosen expert whose capacity left them
    out."""
    xf = th(x).reshape(-1, cfg.d_model)
    probs, gates, eidx = moe._route(m.router, xf, cfg.moe_top_k)
    cap = moe.capacity(xf.shape[0], cfg)
    idx, _, valid = moe._select_for_experts(
        probs, gates, eidx, torch.arange(cfg.n_experts), cap)
    kept = {(e, int(t)) for e in range(cfg.n_experts)
            for t, v in zip(idx[e], valid[e]) if v}
    return sum(any((int(e), t) not in kept for e in eidx[t])
               for t in range(xf.shape[0]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", [2, 24])
def test_moe_dense_matches_reference_and_drops_as_it_does(arch, t):
    jcfg, cfg, jp, m, x = _moe_case(arch, 6, t)
    got = moe.moe_dense(m, th(x), cfg)
    want = jmoe.moe_dense(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if t == 24:
        assert _dropped(cfg, x, m) > 0       # the capacity bites


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_without_drops_matches_reference(arch):
    jcfg, cfg, jp, m, x = _moe_case(arch, 7, 24, capacity_factor=100.0)
    assert _dropped(cfg, x, m) == 0
    np.testing.assert_allclose(
        np_of(moe.moe_dense(m, th(x), cfg)),
        np.asarray(jmoe.moe_dense(jp, jnp.asarray(x), jcfg)), rtol=TOL,
        atol=TOL)


def test_moe_apply_local_expert_slice_matches_reference():
    jcfg, cfg, jp, m, x = _moe_case("deepseek-v2-236b", 8, 16)
    start, count = 2, 3
    sl = {k: (v if k == "router" else v[start:start + count])
          for k, v in jp.items() if k != "shared"}
    part = moe.MoE.__new__(moe.MoE)
    torch.nn.Module.__init__(part)
    part.router = m.router
    for k in ("w_gate", "w_up", "w_down"):
        setattr(part, k, torch.nn.Parameter(getattr(m, k)[start:start + count],
                                            requires_grad=False))
    xf = x.reshape(-1, cfg.d_model)
    got = moe.moe_apply_local(part, th(xf), cfg,
                              experts_slice=(start, count))
    want = jmoe.moe_apply_local(sl, jnp.asarray(xf), jcfg,
                                experts_slice=(start, count))
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_moe_apply_local_refuses_a_mesh_axis(tmp_path):
    """Given an expert-parallel axis, ``moe_apply_local`` computes what it
    does without one (the caller reduces over the axis, as in the JAX
    package), and ``local_experts`` refuses expert weights that are
    neither all the experts nor this rank's share.  A one-rank gloo world
    stands in for the axis (the mesh path: tests/test_torch_parallel.py)."""
    import torch.distributed as dist

    _, cfg, _, m, x = _moe_case("moonshot-v1-16b-a3b", 9, 4)
    xf = th(x).reshape(-1, cfg.d_model)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        assert moe.axis_size(group) == 1
        local = moe.local_experts(m, cfg, group)
        assert torch.equal(moe.moe_apply_local(local, xf, cfg,
                                               axis_name=group),
                           moe.moe_apply_local(m, xf, cfg))
        local.w_gate = local.w_gate[:-1]
        with pytest.raises(ValueError, match="experts"):
            moe.local_experts(local, cfg, group)
    finally:
        dist.destroy_process_group()


def test_bf16_experts_accumulate_in_float32():
    _, cfg, jp, m, x = _moe_case("moonshot-v1-16b-a3b", 10, 8)
    mb = _port_moe(jp, cfg.with_(dtype="bfloat16"))
    assert mb.router.dtype == torch.float32
    assert mb.w_gate.dtype == torch.bfloat16
    out = moe.moe_dense(mb, th(x).to(torch.bfloat16), cfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(out.float()),
                               np_of(moe.moe_dense(m, th(x), cfg)),
                               rtol=0.05, atol=0.05)
