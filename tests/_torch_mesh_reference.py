"""The JAX package's mesh path on 4 host devices, for the port's mesh tests
(``tests/test_torch_parallel.py``).

Run in a subprocess (the test process's jax keeps its one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_mesh_reference.py IN.npz OUT.npz

IN holds the numpy inputs the test made from its seeds; OUT gets each
check's outputs under its own prefix: the engine's all-gather kNN merge,
``KNNServable.run`` and ``CFServable.run`` through ``MapReduce(mesh)``
(stage 1), ``_moe_ep_sharded`` on a (2, 2) mesh in both dispatches and
the decode arm (on IN's MoE weights), and ``pipeline_apply``'s forward on
a 4-stage ``pipe`` mesh.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.apps import cf as jcf, knn as jknn  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.engine import CombineSpec, MapReduce, shard_leading  # noqa
from repro.models import moe  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    ParallelContext, _moe_ep_sharded,
)
from repro.parallel.pipeline_parallel import pipeline_apply  # noqa: E402

assert len(jax.devices()) == 4, jax.devices()


def engine_checks(inp, out):
    mesh = jax.make_mesh((4,), ("data",))
    eng = MapReduce(mesh, axis="data")
    tx, ty, q = (jnp.asarray(inp[k]) for k in ("knn_x", "knn_y", "knn_q"))
    k = int(inp["knn_k"])
    d, lab = eng.run(
        lambda a, b: jknn.exact_map(a, b, q, k=k),
        CombineSpec("all_gather",
                    lambda g: jknn.merge_topk(g[0], g[1], k)),
        shard_leading(mesh, "data", tx), shard_leading(mesh, "data", ty))
    out["merge/d"], out["merge/l"] = np.asarray(d), np.asarray(lab)
    out["merge/shuffle"] = np.asarray(eng.last_shuffle_bytes)

    # KNNServable.run through the mesh engine (stage 1 with its bound)
    js = jknn.KNNServable(tx, ty, n_classes=int(inp["knn_c"]), k=3,
                          lsh_key=jax.random.PRNGKey(7),
                          engine=MapReduce(mesh, axis="data"))
    jprep = js.build(16.0)
    res = js.run(jprep, (q,), refine_budget=0)
    for i, v in enumerate(res):
        out[f"knn_run/{i}"] = np.asarray(v)
    out["knn_run/shuffle"] = np.asarray(js.last_shuffle_bytes)

    # CFServable.run through the mesh engine (the psum combine)
    cx, cm = jnp.asarray(inp["cf_x"]), jnp.asarray(inp["cf_m"])
    qa, qm = jnp.asarray(inp["cf_qa"]), jnp.asarray(inp["cf_qm"])
    jc = jcf.CFServable(cx, cm, lsh_key=jax.random.PRNGKey(5),
                        engine=MapReduce(mesh, axis="data"))
    res = jc.run(jc.build(8.0), (qa, qm), refine_budget=0)
    for i, v in enumerate(res):
        out[f"cf_run/{i}"] = np.asarray(v)
    out["cf_run/shuffle"] = np.asarray(jc.last_shuffle_bytes)


def moe_checks(inp, out):
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    ctx = ParallelContext(mesh=mesh, data_axes=("data",), use_ep=True)
    base = get_config("moonshot-v1-16b-a3b", smoke=True).with_(
        n_experts=8, moe_top_k=2, capacity_factor=100.0)
    p = {}
    for key, v in inp.items():
        if key.startswith("moe_p/"):
            node = p
            *path, leaf = key.split("/")[1:]
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(v)
    x = jnp.asarray(inp["moe_x"])
    x1 = jnp.asarray(inp["moe_x1"])
    for dispatch in ("all_gather", "all_to_all"):
        cfg = base.with_(moe_dispatch=dispatch)
        got = jax.jit(lambda pp, xx: _moe_ep_sharded(pp, xx, cfg, ctx))(p, x)
        out[f"moe/{dispatch}"] = np.asarray(got)
    got = jax.jit(lambda pp, xx: _moe_ep_sharded(pp, xx, base, ctx))(p, x1)
    out["moe/decode"] = np.asarray(got)


def pipeline_checks(inp, out):
    mesh = jax.make_mesh((4,), ("pipe",))
    w, micro = jnp.asarray(inp["pipe_w"]), jnp.asarray(inp["pipe_micro"])
    out["pipe/out"] = np.asarray(pipeline_apply(
        lambda ww, xx: jnp.tanh(xx @ ww), w, micro, mesh))


def main(src, dst):
    inp = dict(np.load(src))
    out = {}
    engine_checks(inp, out)
    moe_checks(inp, out)
    pipeline_checks(inp, out)
    np.savez(dst, **out)
    print("OK", len(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
