"""The port's side of the mesh tests (``tests/test_torch_parallel.py``):
functions that run on each rank of a world started by
``repro_torch.launch.mesh.run_ranks``, on the CPU.

They import no JAX: the ranks are spawned processes that import this
module by name.  Each check returns its outputs (tensors, ints, strings)
under its own key; a check that raises returns its traceback there, so
that the other checks of the world still report.
"""
from __future__ import annotations

import traceback

import numpy as np
import torch

from repro_torch import convert, optim
from repro_torch.apps import cf, knn
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import aggregate as agg_lib
from repro_torch.core import engine, lsh, refine
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import layers, moe
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import ParallelContext, _moe_ep_sharded
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.parallel import collectives, pipeline_parallel, sharding

P = sharding.PartitionSpec
CPU = "cpu"


def th(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _checks(out: dict, checks: dict) -> dict:
    for name, fn in checks.items():
        try:
            out[name] = fn()
        except Exception:  # reported by the test that reads this check
            out[name] = "FAILED\n" + traceback.format_exc()
    return out


def _level(arrays: dict, prefix: str, servable):
    """A reference level-0 npz's arrays -> the port's prepared level."""
    npz = {k[len(prefix):]: v for k, v in arrays.items()
           if k.startswith(prefix) and "/" in k[len(prefix):]}
    stats, index = convert.store_level0_from_numpy(npz, device=CPU)
    f = int(arrays[prefix + "factor"])
    if int(arrays[prefix + "level"]):
        stats = {k: agg_lib.merge_levels(v, f) for k, v in stats.items()}
        index = agg_lib.coarsen_index(index, f)
    return servable.assemble(stats, index)


# ---------------------------------------------------------------------------
# world 1: 4 ranks, a (4,) data mesh (and a pipe mesh, a 2-rank mesh)
# ---------------------------------------------------------------------------

def knn_shard_map(x, y, draws, q, *, k, n_classes, budget):
    """One map task of the sharded kNN job: the shard's aggregates from its
    draw, then ``accurateml_map`` with its bound."""
    cfg = lsh.config_for_compression(x.shape[0], 8.0)
    params = lsh.LSHParams(a=draws[0], b=draws[1], config=cfg)
    agg = knn.build_knn_aggregates(x, y, params, n_classes)
    return knn.accurateml_map(x, y, agg, q, k=k, refine_budget=budget,
                              with_bound=True)


def cf_shard_map(r, m, draws, qa, qm, *, budget):
    cfg = lsh.config_for_compression(r.shape[0], 4.0, n_hashes=4,
                                     bucket_width=8.0)
    params = lsh.LSHParams(a=draws[0], b=draws[1], config=cfg)
    agg = cf.build_cf_aggregates(r, m, params)
    return cf.accurateml_map(r, m, agg, qa, qm, refine_budget=budget,
                             with_bound=True)


def engine_world(rank: int, inp: dict, ckpt_dir: str) -> dict:
    mesh = mesh_lib.make_host_mesh((4,), ("data",), device=CPU)
    r_ = mesh.get_local_rank(0)
    tx, ty, q = th(inp["knn_x"]), th(inp["knn_y"]), th(inp["knn_q"])
    k, c = int(inp["knn_k"]), int(inp["knn_c"])

    def merge():
        eng = engine.MapReduce(mesh, axis="data")
        spec = engine.CombineSpec("all_gather",
                                  lambda g: knn.merge_topk(g[0], g[1], k))
        d, lab = eng.run(lambda a, b: knn.exact_map(a, b, q, k=k), spec,
                         engine.shard_leading(mesh, "data", tx),
                         engine.shard_leading(mesh, "data", ty))
        tracer = Tracer()
        with use_tracer(tracer):
            whole = eng.run(lambda a, b: knn.exact_map(a, b, q, k=k), spec,
                            tx, ty)
        (root,) = tracer.traces()
        spans = [(sp.name, dict(sp.attrs)) for sp in root.walk()]
        return {"d": d, "l": lab, "shuffle": eng.last_shuffle_bytes,
                "whole_d": whole[0], "whole_l": whole[1], "spans": spans}

    def knn_run():
        ts = knn.KNNServable(tx, ty, n_classes=c, k=3,
                             lsh_generator=torch.Generator().manual_seed(0),
                             engine=engine.MapReduce(mesh), device=CPU)
        prep = _level(inp, "knn_level/", ts)
        out = ts.run(prep, (q,), refine_budget=0)
        try:
            ts.run(prep, (q,), refine_budget=8)
            stage2 = "ran"
        except ValueError as e:
            stage2 = str(e)
        return {"out": out, "shuffle": ts.last_shuffle_bytes,
                "stage2": stage2}

    def cf_run():
        cx, cm = th(inp["cf_x"]), th(inp["cf_m"])
        ts = cf.CFServable(cx, cm,
                           lsh_generator=torch.Generator().manual_seed(0),
                           engine=engine.MapReduce(mesh), device=CPU)
        prep = _level(inp, "cf_level/", ts)
        out = ts.run(prep, (th(inp["cf_qa"]), th(inp["cf_qm"])),
                     refine_budget=0)
        return {"out": out, "shuffle": ts.last_shuffle_bytes}

    def sharded_jobs():
        """kNN (all_gather, merge, vote) and CF (psum) jobs whose map
        builds each shard's aggregates, as chip_smoke.py's mesh phase."""
        draws = [(th(a), th(b)) for a, b in zip(inp["knn_lsh_a"],
                                                inp["knn_lsh_b"])]
        eng = engine.MapReduce(mesh)
        budget = refine.eps_to_budget(tx.shape[0] // 4, 0.05)

        def knn_map(x, y):
            return knn_shard_map(x, y, draws[r_], q, k=k, n_classes=c,
                                 budget=budget)

        def reduce_fn(g):
            d, lab = knn.merge_topk(g[0], g[1], k)
            return d, lab, knn.majority_vote(d, lab, c), g[2].max(0).values

        kout = eng.run(knn_map, engine.CombineSpec("all_gather", reduce_fn),
                       engine.shard_leading(mesh, "data", tx),
                       engine.shard_leading(mesh, "data", ty))
        kbytes = eng.last_shuffle_bytes
        cdraws = [(th(a), th(b)) for a, b in zip(inp["cf_lsh_a"],
                                                 inp["cf_lsh_b"])]
        cx, cm = th(inp["cf_x"]), th(inp["cf_m"])
        qa, qm = th(inp["cf_qa"]), th(inp["cf_qm"])
        cbudget = refine.eps_to_budget(cx.shape[0] // 4, 0.1)
        cout = eng.run(
            lambda r, m: cf_shard_map(r, m, cdraws[r_], qa, qm,
                                      budget=cbudget),
            engine.CombineSpec("psum"), cx, cm)
        return {"knn": kout, "knn_shuffle": kbytes, "cf": cout,
                "cf_shuffle": eng.last_shuffle_bytes, "budget": budget,
                "cf_budget": cbudget}

    def indivisible():
        eng = engine.MapReduce(mesh)
        try:
            eng.run(lambda a: a, engine.CombineSpec("psum"), tx[:510])
        except ValueError as e:
            return str(e)
        return "no error"

    def identity():
        eng = engine.MapReduce(mesh)
        got = eng.run(lambda a: a * 2, engine.CombineSpec("identity"), tx)
        return {"out": got, "shuffle": eng.last_shuffle_bytes,
                "slice": engine.shard_leading(mesh, "data", tx).to_local()}

    def meshes():
        errs = {}
        for name, make in (
                ("production", lambda: mesh_lib.make_production_mesh(
                    device=CPU)),
                ("multi_pod", lambda: mesh_lib.make_production_mesh(
                    multi_pod=True, device=CPU)),
                ("host", lambda: mesh_lib.make_host_mesh((2, 4),
                                                         device=CPU))):
            try:
                make()
                errs[name] = "built"
            except RuntimeError as e:
                errs[name] = str(e)
        m22 = mesh_lib.make_host_mesh(device=CPU)
        errs["host_2x2"] = (tuple(m22.mesh_dim_names), tuple(m22.shape),
                            m22.device_type)
        return errs

    def pipeline():
        pmesh = mesh_lib.make_host_mesh((4,), ("pipe",), device=CPU)
        w = th(inp["pipe_w"]).requires_grad_(True)
        micro = th(inp["pipe_micro"])
        out = pipeline_parallel.pipeline_apply(
            lambda ww, xx: torch.tanh(xx @ ww), w, micro, pmesh)
        (out ** 2).sum().backward()
        grad = collectives.all_reduce_sum(w.grad, pmesh.get_group("pipe"))
        sharded = pipeline_parallel.pipeline_apply(
            lambda ww, xx: torch.tanh(xx @ ww),
            engine.shard_leading(pmesh, "pipe", th(inp["pipe_w"])), micro,
            pmesh)
        return {"out": out.detach(), "grad": grad, "sharded": sharded}

    def elastic():
        w = th(inp["ckpt_w"])
        tree = {"w": sharding.place(w, sharding.NamedSharding(
                    mesh, P("data", None))),
                "b": torch.arange(8.0)}
        ck = Checkpointer(ckpt_dir, device=CPU)
        ck.save(7, tree, extra={"step": 7})
        mesh2 = mesh_lib.make_host_mesh((2,), ("elastic",), device=CPU)
        if not mesh_lib.in_mesh(mesh2):
            return None
        template = {"w": np.zeros((64, 8), np.float32),
                    "b": np.zeros(8, np.float32)}
        restored, extra = ck.restore(template, shardings={
            "w": sharding.NamedSharding(mesh2, P("elastic")),
            "b": sharding.NamedSharding(mesh2, P())})
        return {"extra": extra, "local": restored["w"].to_local(),
                "placements": list(restored["w"].placements),
                "whole": sharding.gather(restored["w"]),
                "b": restored["b"].to_local()}

    return _checks({"rank": rank}, {
        "merge": merge, "knn_run": knn_run, "cf_run": cf_run,
        "sharded_jobs": sharded_jobs, "indivisible": indivisible,
        "identity": identity, "meshes": meshes, "pipeline": pipeline,
        "elastic": elastic})


# ---------------------------------------------------------------------------
# world 2: 4 ranks, a (2, 2) data x model mesh
# ---------------------------------------------------------------------------

MOE_OVER = dict(n_experts=8, moe_top_k=2, capacity_factor=100.0)


def moe_weights(inp: dict, cfg) -> moe.MoE:
    p = moe.moe_init(layers.Init(None, dtype=torch.float32,
                                 device=torch.device(CPU)), cfg)
    for name, param in p.named_parameters():
        param.data.copy_(th(inp["moe_p/" + name.replace(".", "/")]))
    return p


def model_world(rank: int, inp: dict, batches: list) -> dict:
    mesh = mesh_lib.make_host_mesh((2, 2), ("data", "model"), device=CPU)

    def ep():
        base = get_config("moonshot-v1-16b-a3b", smoke=True).with_(
            **MOE_OVER)
        ctx = ParallelContext(mesh=mesh, data_axes=("data",), use_ep=True)
        p = moe_weights(inp, base)
        out = {}
        with torch.no_grad():
            for dispatch in ("all_gather", "all_to_all"):
                cfg = base.with_(moe_dispatch=dispatch)
                out[dispatch] = _moe_ep_sharded(p, th(inp["moe_x"]), cfg,
                                                ctx)
            out["decode"] = _moe_ep_sharded(p, th(inp["moe_x1"]), base,
                                            ctx)
        return out

    def train_steps():
        cfg = get_config("qwen3-8b", smoke=True)
        tree = {k[len("lm/"):]: v for k, v in inp.items()
                if k.startswith("lm/")}
        model = convert.lm_params_from_numpy(_nest(tree), cfg, device=CPU)
        ctx = ParallelContext(mesh=mesh, data_axes=("data",))
        named = model_lib.param_tree(model)
        specs = sharding.param_specs(named, cfg, mesh)
        sharding.place_params(model, sharding.param_shardings(named, cfg,
                                                              mesh))
        opt = optim.init_state(sharding.local_tree(
            model_lib.param_tree(model)))
        prefill = train.make_prefill_step(cfg, ctx)(
            model, {"tokens": th(batches[0][0])})
        # one decode step: this rank's 2 rows' caches, the 4 rows' logits
        caches = model_lib.init_caches(cfg, batch=2, s_max=8, device=CPU)
        decode, _ = train.make_serve_step(cfg, ctx)(
            model, caches, {"tokens": th(batches[0][0][:, :1]),
                            "pos": torch.zeros(4, dtype=torch.int32)})
        step = train.make_train_step(
            cfg, optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                   total_steps=10), ctx)
        losses = []
        for tokens, labels in batches:
            model, opt, m = step(model, opt, {"tokens": th(tokens),
                                              "labels": th(labels)})
            losses.append(float(m["loss"]))
        params = model_lib.param_tree(model)
        whole = {n: sharding.gather(p) for n, p in params.items()}
        return {"losses": losses, "params": whole, "prefill": prefill,
                "decode": decode,
                "specs": {n: tuple(s) for n, s in specs.items()},
                "local_shapes": {n: tuple(p.to_local().shape)
                                 for n, p in params.items()}}

    return _checks({"rank": rank}, {"ep": ep, "train": train_steps})


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


# ---------------------------------------------------------------------------
# the launcher's own behaviour
# ---------------------------------------------------------------------------

def host_mesh(rank: int, kw: dict):
    """A (1,) mesh built with ``kw``: its shape and device type."""
    m = mesh_lib.make_host_mesh((1,), ("data",), **kw)
    return torch.tensor(m.shape), m.device_type


def fails_on_rank_1(rank: int) -> int:
    if rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    return rank


def sleeps(rank: int) -> int:
    import time

    time.sleep(60)
    return rank


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py): 2 ranks sharing it
# ---------------------------------------------------------------------------

def card_world(rank: int, x, y, q, k: int, moe_x) -> dict:
    """The mesh engine's all-gather kNN merge on the kernels
    (``distance_topk``, then ``merge_topk``'s ``candidate_topk``) and one
    ``moe_ep`` over a (2,) model axis, on CUDA tensors."""
    from repro_torch.kernels import ops

    mesh = mesh_lib.make_host_mesh((2,), ("data",))
    dev = torch.device("cuda", torch.cuda.current_device())
    ops.reset_launch_counts()
    eng = engine.MapReduce(mesh)
    d, lab = eng.run(
        lambda a, b: knn.exact_map(a, b, q.to(dev), k=k),
        engine.CombineSpec("all_gather",
                           lambda g: knn.merge_topk(g[0], g[1], k)),
        engine.shard_leading(mesh, "data", x),
        engine.shard_leading(mesh, "data", y))
    counts = ops.launch_counts()
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True).with_(**MOE_OVER)
    p = moe.moe_init(layers.Init(torch.Generator(device=dev).manual_seed(3),
                                 dtype=torch.float32, device=dev), cfg)
    g = mesh.get_group("data")
    m = moe_x.shape[0] // 2
    with torch.no_grad():
        mine = moe_x[rank * m:(rank + 1) * m].to(dev)
        ep = moe.moe_ep(moe.local_experts(p, cfg, g), mine, cfg,
                        axis_name=g)
        dense = moe.moe_dense(p, moe_x.to(dev)[None], cfg)[0]
    torch.cuda.synchronize()
    return {"d": d.cpu(), "l": lab.cpu(), "shuffle": eng.last_shuffle_bytes,
            "counts": counts, "ep": ep.cpu(),
            "dense": dense[rank * m:(rank + 1) * m].cpu()}
