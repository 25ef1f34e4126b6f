"""The kNN job of AccurateML as its users run it: one call of
``repro_torch.apps.knn.run_accurateml`` a job, over the whole training
set in contiguous map-task shards, with a fresh batch of queries and a
fresh LSH draw for every map task.

The job returns only the votes; the check also reads the reduce's merged
k nearest (the job's last ``candidate_topk``, the shard merge) through the
program's ``ops`` probe, since votes on well-separated data do not move
under a lower precision.
"""
from __future__ import annotations

import dataclasses

import torch

from bench import data, work
from bench.reference import knn as ref

CAPTURE = "candidate_topk"


@dataclasses.dataclass
class State:
    cfg: dict
    eps_max: float
    seed: int
    device: torch.device
    train_x: torch.Tensor
    train_y: torch.Tensor
    queries: torch.Tensor      # [batches * Q, D] pool
    truth: torch.Tensor        # [batches * Q] their classes


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device):
    """The training set and the query pool, drawn on ``device`` from the
    seed in one mixture (the queries first)."""
    pool = cfg["queries_per_job"] * cfg["query_batches"]
    x, y = data.mfeat_like(
        data.generator(device, seed, "data"), cfg["n_points"] + pool,
        cfg["n_features"], cfg["n_classes"], cfg["modes_per_class"],
        cfg["class_sep"], cfg["mode_scale"])
    return State(cfg, traffic["eps_max"], seed, device, x[pool:], y[pool:],
                 x[:pool], y[:pool])


def inputs(state: State, stream: str, job: int) -> dict:
    """A job's queries (cycled through the pool) and its LSH draws, one
    family a map task, from the job's own seed."""
    from repro_torch.core import lsh   # the program's parameter types

    cfg = state.cfg
    q = cfg["queries_per_job"]
    b = job % cfg["query_batches"]
    draws = data.lsh_draws(
        data.generator(state.device, state.seed, f"lsh-{stream}", job),
        cfg["n_features"], cfg["n_hashes"], cfg["bucket_width"],
        cfg["n_shards"])
    params = [
        lsh.LSHParams(a=a, b=bb, config=lsh.LSHConfig(
            n_hashes=cfg["n_hashes"], bucket_width=cfg["bucket_width"],
            n_buckets=data.n_buckets(hi - lo, cfg["compression_ratio"])))
        for (lo, hi), (a, bb) in zip(
            data.shard_bounds(state.train_x.shape[0], cfg["n_shards"]),
            draws)]
    return {"rows": slice(b * q, (b + 1) * q), "draws": draws,
            "params": params}


def run(state: State, inp: dict):
    from repro_torch.apps import knn

    cfg = state.cfg
    return knn.run_accurateml(
        state.train_x, state.train_y, state.queries[inp["rows"]],
        k=cfg["k"], n_classes=cfg["n_classes"],
        compression_ratio=cfg["compression_ratio"], eps_max=state.eps_max,
        lsh_params=inp["params"], n_shards=cfg["n_shards"],
        n_hashes=cfg["n_hashes"], bucket_width=cfg["bucket_width"],
        device=state.device)


def reference(state: State, inp: dict, precision: str) -> ref.Answer:
    cfg = state.cfg
    return ref.accurateml_job(
        state.train_x, state.train_y, state.queries[inp["rows"]],
        inp["draws"], k=cfg["k"], n_classes=cfg["n_classes"],
        ratio=cfg["compression_ratio"], eps_max=state.eps_max,
        width=cfg["bucket_width"], precision=precision)


def compare(state: State, out, captured, want: ref.Answer) -> torch.Tensor:
    """Each query's gap: the largest relative gap of its k nearest
    distances, infinite where its vote or the padding differs, or where
    the merge was not captured."""
    rows = want.votes.shape[0]
    if captured is None or out is None:
        return torch.full((rows,), torch.inf, dtype=torch.float64)
    got = captured[0].double()
    got = torch.where(got >= 1.5e38, torch.inf, got)   # the program's pad
    want_d = want.dist.to(got.device, torch.float64)
    both = torch.isfinite(got) & torch.isfinite(want_d)
    rel = torch.where(both, (got - want_d).abs() / want_d.clamp_min(1.0),
                      0.0)
    gap = rel.max(1).values
    off = ((torch.isfinite(got) != torch.isfinite(want_d)).any(1)
           | (out.long() != want.votes.to(out.device)))
    return torch.where(off, torch.inf, gap).cpu()


def launches(state: State, want: ref.Answer) -> list:
    cfg = state.cfg
    return work.knn_launches(want.shards, q=cfg["queries_per_job"],
                             d=cfg["n_features"], h=cfg["n_hashes"],
                             k=cfg["k"])


def job_flops(state: State, want: ref.Answer) -> float:
    cfg = state.cfg
    return work.knn_job_flops(want.shards, q=cfg["queries_per_job"],
                              d=cfg["n_features"], h=cfg["n_hashes"])


def quality(state: State, inp: dict, out) -> str:
    """The job's accuracy against the true classes and its loss against
    the exact job (the paper's metric), for PERF.md."""
    cfg = state.cfg
    truth = state.truth[inp["rows"]].long()
    exact = ref.exact_job(state.train_x, state.train_y,
                          state.queries[inp["rows"]], k=cfg["k"],
                          n_classes=cfg["n_classes"],
                          n_shards=cfg["n_shards"])
    acc = float((out.long() == truth).double().mean())
    acc_exact = float((exact == truth).double().mean())
    loss = max(0.0, (acc_exact - acc) / max(acc_exact, 1e-12))
    return (f"accuracy {acc:.6f}, exact job {acc_exact:.6f}, "
            f"accuracy loss {loss:.6f}")
