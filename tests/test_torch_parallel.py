"""The port's mesh path on worlds of 4 CPU ranks (gloo), against the JAX
package's mesh path on 4 host devices where that runs here, else against
its single-device functions.

One module fixture starts everything once: the JAX package's mesh checks
in a subprocess (``tests/_torch_mesh_reference.py``, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: nothing reaches
this process's jax), and meanwhile two worlds of the port
(``tests/_torch_mesh_ranks.py`` through ``launch.mesh.run_ranks``): a
(4,) data mesh for the engine, the servables, the pipeline and the
elastic restore, and a (2, 2) data x model mesh for expert parallelism and
the sharded train step.  The tests read their results.

The JAX package's own pipeline gradient and sharded train step fail on
jax 0.9.0 (``jax.grad`` through ``pipeline_apply``: "Length of device
assignment 1 is not equal to the size of the mesh 4"; the sharded step's
embedding gather: ``ShardingTypeError``), so the port's are held against
``jax.grad`` of ``sequential_reference`` and against the single-device
``make_train_step``, which compute the same thing.
"""
import os
import subprocess
import sys
import tempfile
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import _torch_mesh_ranks as ranks
from _torch_parity import normal, np_of, rng, th
from repro import optim as joptim
from repro.apps import cf as jcf, knn as jknn
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.parallel.pipeline_parallel import (
    sequential_reference as jsequential,
)
from repro_torch import convert
from repro_torch.apps import cf, knn
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.launch import train
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.parallel import pipeline_parallel

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "tests" / "_torch_mesh_reference.py"
N_RANKS = 4
WORLD_TIMEOUT = 240.0
REF_TIMEOUT = 300.0
TOL = 1e-4            # distances, the pipeline (tests/test_kernels.py)
CF_TOL = 2e-4         # CF sums and weights
EP_TOL = 2e-4         # moe_ep against moe_dense, f32 (the reference check)
A2A_TOL = 2e-2        # bf16 dispatch buffers (the reference check)
LOSS_TOL = 1e-5
ROUNDING_GRAD = 1e-5  # tests/test_torch_train.py's exemption
N, D, Q, K, C = 512, 16, 32, 4, 5
USERS, ITEMS, ACTIVE = 256, 24, 16


def _lsh_draws(r, n_shards, n_features, width):
    a = r.standard_normal((n_shards, n_features, 4)).astype(np.float32)
    b = (r.random((n_shards, 4)) * width).astype(np.float32)
    return a, b


def _level(js, ratio, prefix):
    """The reference servable's level-0 arrays and its level of
    ``ratio``, as the port's ranks assemble them."""
    js.store.get(js, ratio)
    pyr = js.store.pyramid(js)
    idx = pyr.index_at(0)
    lvl = js.pyramid_spec.level_for_ratio(ratio)
    out = {f"{prefix}stats/{k}": np.asarray(v)
           for k, v in pyr.stats_at(0).items()}
    out.update({f"{prefix}index/perm": np.asarray(idx.perm),
                f"{prefix}index/offsets": np.asarray(idx.offsets),
                f"{prefix}index/bucket_of": np.asarray(idx.bucket_of),
                f"{prefix}level": np.asarray(lvl),
                f"{prefix}factor": np.asarray(js.pyramid_spec.factor(lvl))})
    return out


def _moe_cfgs():
    return (jget_config("moonshot-v1-16b-a3b", smoke=True).with_(
                **ranks.MOE_OVER),
            get_config("moonshot-v1-16b-a3b", smoke=True).with_(
                **ranks.MOE_OVER))


def _inputs() -> dict:
    r = rng(0)
    inp = {"knn_x": normal(r, N, D),
           "knn_y": r.integers(0, C, N).astype(np.int32),
           "knn_q": normal(r, Q, D), "knn_k": np.asarray(K),
           "knn_c": np.asarray(C)}
    m = (r.random((USERS, ITEMS)) < 0.3).astype(np.float32)
    inp["cf_x"] = (r.random((USERS, ITEMS)) * 4 + 1).astype(np.float32) * m
    inp["cf_m"] = m
    qm = (r.random((ACTIVE, ITEMS)) < 0.3).astype(np.float32)
    inp["cf_qa"] = (r.random((ACTIVE, ITEMS)) * 4 + 1).astype(
        np.float32) * qm
    inp["cf_qm"] = qm
    inp["knn_lsh_a"], inp["knn_lsh_b"] = _lsh_draws(r, N_RANKS, D, 4.0)
    inp["cf_lsh_a"], inp["cf_lsh_b"] = _lsh_draws(r, N_RANKS, ITEMS, 8.0)
    inp["moe_x"] = normal(r, 4, 16, 64)
    inp["moe_x1"] = normal(r, 1, 1, 64)
    inp["pipe_w"] = normal(r, 4, 16, 16) * np.float32(0.3)
    inp["pipe_micro"] = normal(r, 6, 8, 16)
    inp["ckpt_w"] = normal(r, 64, 8)
    jcfg, _ = _moe_cfgs()
    p = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        inp["moe_p/" + "/".join(k.key for k in path)] = np.asarray(v)
    lcfg = jget_config("qwen3-8b", smoke=True)
    params = jmodel.init_params(jax.random.PRNGKey(3), lcfg)
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        inp["lm/" + "/".join(str(k.key) for k in path)] = np.asarray(v)
    js = jknn.KNNServable(jnp.asarray(inp["knn_x"]),
                          jnp.asarray(inp["knn_y"]), n_classes=C, k=3,
                          lsh_key=jax.random.PRNGKey(7))
    inp.update(_level(js, 16.0, "knn_level/"))
    jc = jcf.CFServable(jnp.asarray(inp["cf_x"]), jnp.asarray(inp["cf_m"]),
                        lsh_key=jax.random.PRNGKey(5))
    inp.update(_level(jc, 8.0, "cf_level/"))
    return inp


def _batches(vocab):
    out = []
    for step in range(3):
        r = rng(30 + step)
        out.append((r.integers(0, vocab, (4, 16)).astype(np.int32),
                    r.integers(0, vocab, (4, 16)).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def world():
    inp = _inputs()
    batches = _batches(get_config("qwen3-8b", smoke=True).vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp, "in.npz"), Path(tmp, "out.npz")
        np.savez(src, **{k: v for k, v in inp.items()
                         if not k.startswith(("lm/", "knn_level/",
                                              "cf_level/"))})
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        proc = subprocess.Popen([sys.executable, str(REFERENCE), str(src),
                                 str(dst)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            eng = run_ranks(ranks.engine_world, N_RANKS, inp,
                            str(Path(tmp, "ckpt")), device="cpu",
                            timeout=WORLD_TIMEOUT)
            mod = run_ranks(ranks.model_world, N_RANKS, inp, batches,
                            device="cpu", timeout=WORLD_TIMEOUT)
            _, err = proc.communicate(timeout=REF_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, err[-4000:]
        ref = dict(np.load(dst))
    return {"inp": inp, "ref": ref, "eng": eng, "mod": mod,
            "batches": batches}


def _ok(result):
    assert not (isinstance(result, str) and result.startswith("FAILED")), \
        result
    return result


def _each(world, part, check):
    return [_ok(r[check]) for r in world[part]]


def _close(got, want, tol):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_all_gather_merge_equals_reference_mesh_and_single_device(world):
    inp, ref = world["inp"], world["ref"]
    d0, l0 = knn.exact_map(th(inp["knn_x"]), th(inp["knn_y"]),
                           th(inp["knn_q"]), k=K)
    for got in _each(world, "eng", "merge"):
        _close(got["d"], ref["merge/d"], TOL)
        np.testing.assert_array_equal(np_of(got["l"]), ref["merge/l"])
        assert got["shuffle"] == int(ref["merge/shuffle"])
        assert torch.equal(got["whole_d"], got["d"])
        assert torch.equal(got["whole_l"], got["l"])
        _close(got["d"], d0, TOL)
        np.testing.assert_array_equal(np_of(got["l"]), np_of(l0))
        # the reference's spans: mapreduce, the fused map and shuffle,
        # one map.shard event a shard with its bytes
        per = got["shuffle"] // N_RANKS
        assert got["spans"] == [
            ("mapreduce", {"mode": "all_gather", "shards": N_RANKS,
                           "shuffle_bytes": got["shuffle"]}),
            ("map+reduce.fused", {}),
            *[("map.shard", {"shard": i, "shuffle_bytes": per})
              for i in range(N_RANKS)]]


def test_knn_servable_run_on_a_mesh_equals_reference(world):
    ref = world["ref"]
    for got in _each(world, "eng", "knn_run"):
        d, lab, vote, bound = got["out"]
        _close(d, ref["knn_run/0"], TOL)
        np.testing.assert_array_equal(np_of(lab), ref["knn_run/1"])
        np.testing.assert_array_equal(np_of(vote), ref["knn_run/2"])
        _close(bound, ref["knn_run/3"], TOL)
        assert got["shuffle"] == int(ref["knn_run/shuffle"])
        assert "stage 2" in got["stage2"] and "mesh engine" in got["stage2"]


def test_cf_servable_run_on_a_mesh_equals_reference(world):
    ref = world["ref"]
    for got in _each(world, "eng", "cf_run"):
        pred, bound = got["out"]
        _close(pred, ref["cf_run/0"], CF_TOL)
        _close(bound, ref["cf_run/1"], CF_TOL)
        assert got["shuffle"] == int(ref["cf_run/shuffle"])


def test_sharded_jobs_equal_the_single_device_engine_shard_by_shard(world):
    """Jobs whose map builds each shard's aggregates: the mesh's merged
    top-k and vote are ``MapReduce(mesh=None)``'s over the 4 stacked
    shards to the bit, the psum within the CF tolerance, and the shuffle
    bytes the four single-device runs' sum."""
    inp = world["inp"]
    got = _each(world, "eng", "sharded_jobs")
    tx, ty, q = th(inp["knn_x"]), th(inp["knn_y"]), th(inp["knn_q"])
    m = N // N_RANKS
    budget = got[0]["budget"]
    outs, nbytes = [], 0
    for s in range(N_RANKS):
        eng = engine.MapReduce()
        outs.append(eng.run(
            partial(ranks.knn_shard_map, draws=(th(inp["knn_lsh_a"][s]),
                                                th(inp["knn_lsh_b"][s])),
                    q=q, k=K, n_classes=C, budget=budget),
            engine.CombineSpec("all_gather"),
            tx[s * m:(s + 1) * m], ty[s * m:(s + 1) * m]))
        nbytes += eng.last_shuffle_bytes
    g = [torch.cat([o[i] for o in outs]) for i in range(3)]
    d, lab = knn.merge_topk(g[0], g[1], K)
    want = (d, lab, knn.majority_vote(d, lab, C), g[2].max(0).values)
    cx, cm = th(inp["cf_x"]), th(inp["cf_m"])
    mu = USERS // N_RANKS
    cf_sum, cf_bytes = None, 0
    for s in range(N_RANKS):
        eng = engine.MapReduce()
        out = eng.run(
            partial(ranks.cf_shard_map, draws=(th(inp["cf_lsh_a"][s]),
                                               th(inp["cf_lsh_b"][s])),
                    qa=th(inp["cf_qa"]), qm=th(inp["cf_qm"]),
                    budget=got[0]["cf_budget"]),
            engine.CombineSpec("psum"), cx[s * mu:(s + 1) * mu],
            cm[s * mu:(s + 1) * mu])
        cf_sum = out if cf_sum is None else [a + b for a, b in
                                              zip(cf_sum, out)]
        cf_bytes += eng.last_shuffle_bytes
    assert budget > 0 and got[0]["cf_budget"] > 0
    for r in got:
        for a, b in zip(r["knn"], want):
            assert torch.equal(a, b)
        assert r["knn_shuffle"] == nbytes
        for a, b in zip(r["cf"], cf_sum):
            _close(a, b, CF_TOL)
        assert r["cf_shuffle"] == cf_bytes


def test_indivisible_leading_dimension_raises(world):
    for msg in _each(world, "eng", "indivisible"):
        assert "510" in msg and "does not divide" in msg


def test_identity_keeps_each_ranks_output_and_shard_leading(world):
    x = th(world["inp"]["knn_x"])
    m = N // N_RANKS
    for rank, got in enumerate(_each(world, "eng", "identity")):
        assert torch.equal(got["out"], 2 * x[rank * m:(rank + 1) * m])
        assert got["shuffle"] == 0
        assert torch.equal(got["slice"], x[rank * m:(rank + 1) * m])


def test_mesh_constructors_need_their_world(world):
    for got in _each(world, "eng", "meshes"):
        assert got["production"].startswith(
            "need 256 devices for mesh (16, 16), have 4")
        assert got["multi_pod"].startswith(
            "need 512 devices for mesh (2, 16, 16), have 4")
        assert got["host"].startswith("need 8 devices for mesh (2, 4)")
        assert got["host_2x2"] == (("data", "model"), (2, 2), "cpu")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _stage(w, x):
    return jnp.tanh(x @ w)


def test_pipeline_forward_equals_reference(world):
    ref, inp = world["ref"], world["inp"]
    seq = pipeline_parallel.sequential_reference(
        lambda w, x: torch.tanh(x @ w), th(inp["pipe_w"]),
        th(inp["pipe_micro"]))
    for got in _each(world, "eng", "pipeline"):
        _close(got["out"], ref["pipe/out"], 1e-5)
        _close(got["sharded"], ref["pipe/out"], 1e-5)
        _close(got["out"], seq, 1e-5)


def test_pipeline_gradient_equals_jax_grad_of_sequential_reference(world):
    inp = world["inp"]
    micro = jnp.asarray(inp["pipe_micro"])
    want = jax.grad(lambda w: jnp.sum(jsequential(_stage, w, micro) ** 2))(
        jnp.asarray(inp["pipe_w"]))
    for got in _each(world, "eng", "pipeline"):
        _close(got["grad"], want, 1e-4)


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------

def test_elastic_restore_from_4_ranks_onto_2(world):
    from torch.distributed.tensor import Shard

    w = th(world["inp"]["ckpt_w"])
    got = _each(world, "eng", "elastic")
    assert got[2] is None and got[3] is None
    for rank in (0, 1):
        r = got[rank]
        assert r["extra"] == {"step": 7}
        assert r["placements"] == [Shard(0)]
        assert torch.equal(r["local"], w[32 * rank:32 * (rank + 1)])
        assert torch.equal(r["whole"], w)
        assert torch.equal(r["b"], torch.arange(8.0))


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm,tol", [("all_gather", EP_TOL),
                                     ("all_to_all", A2A_TOL),
                                     ("decode", EP_TOL)])
def test_moe_ep_equals_reference_and_moe_dense(world, arm, tol):
    inp, ref = world["inp"], world["ref"]
    jcfg, cfg = _moe_cfgs()
    x = inp["moe_x1" if arm == "decode" else "moe_x"]
    p = jax.tree_util.tree_map(jnp.asarray, {
        k: v for k, v in ranks._nest(
            {k[len("moe_p/"):]: v for k, v in inp.items()
             if k.startswith("moe_p/")}).items()})
    dense = np.asarray(jmoe.moe_dense(p, jnp.asarray(x), jcfg))
    port_dense = moe.moe_dense(ranks.moe_weights(inp, cfg), th(x), cfg)
    for got in _each(world, "mod", "ep"):
        _close(got[arm], ref[f"moe/{arm}"], tol)
        _close(got[arm], dense, tol)
        _close(got[arm], port_dense, tol)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def test_sharded_train_step_equals_reference_single_device_step(world):
    """Three steps on a (2, 2) mesh against the JAX package's
    single-device step on the same batches: every loss within 1e-5 and
    every parameter entry within 1e-5 but those whose first gradient is
    rounding noise (tests/test_torch_train.py's rule); and the sharded
    prefill and serve steps' logits against the single-device ones."""
    inp, batches = world["inp"], world["batches"]
    jcfg = jget_config("qwen3-8b", smoke=True)
    cfg = get_config("qwen3-8b", smoke=True)
    tree = ranks._nest({k[len("lm/"):]: v for k, v in inp.items()
                        if k.startswith("lm/")})
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jtrain.make_train_step(jcfg, joptim.AdamWConfig(**kw)))
    js = joptim.init_state(jp)
    losses = []
    for step, (tokens, labels) in enumerate(batches):
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        if step == 0:
            g1 = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.
                      tree_map(np.asarray,
                               jax.grad(jmodel.loss_fn)(jp, jb, jcfg)))[0])
        jp, js, jm = jstep(jp, js, jb)
        losses.append(float(jm["loss"]))
    single = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    prefill = model_lib.prefill(single, th(batches[0][0]), cfg)
    decode, _ = model_lib.serve_step(
        single, model_lib.init_caches(cfg, batch=4, s_max=8, device="cpu"),
        th(batches[0][0][:, :1]), torch.zeros(4, dtype=torch.int32), cfg)
    for got in _each(world, "mod", "train"):
        np.testing.assert_allclose(got["losses"], losses, rtol=0,
                                   atol=LOSS_TOL)
        mine = dict(jax.tree_util.tree_flatten_with_path(
            convert.lm_tree(got["params"], cfg))[0])
        for path, w in jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(np.asarray, jp))[0]:
            g = np.abs(g1[path])
            noise = g <= ROUNDING_GRAD * g.max()
            off = (np.abs(np_of(mine[path]) - w) > 1e-5) & ~noise
            assert not off.any(), jax.tree_util.keystr(path)
        _close(got["prefill"], prefill, 1e-5)
        _close(got["decode"], decode, 1e-5)
    # the (2, 2) placement: heads and the MLP's width over model, FSDP
    # over data, the norms whole
    r0 = _ok(world["mod"][0]["train"])
    assert r0["specs"]["blocks.0.attn.wq"] == ("data", "model")
    assert r0["local_shapes"]["blocks.0.attn.wq"] == (32, 32)
    assert r0["specs"]["blocks.0.attn.q_norm"] == (None,)
    assert r0["local_shapes"]["blocks.0.attn.q_norm"] == (16,)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_run_ranks_raises_a_failed_ranks_error():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fails_on_rank_1, 2, device="cpu", timeout=120)


def test_run_ranks_times_out():
    with pytest.raises(TimeoutError):
        run_ranks(ranks.sleeps, 2, device="cpu", timeout=3)
