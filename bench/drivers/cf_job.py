"""The CF job of AccurateML as its users run it: one call of
``repro_torch.apps.cf.run_accurateml`` a job, over every neighbour user in
contiguous map-task shards, for a fresh batch of active users and with a
fresh LSH draw for every map task.  The job's answer, its predictions
[Q, I], is what the check compares."""
from __future__ import annotations

import dataclasses
import sys

import torch

from bench import data, work
from bench.reference import cf as ref

CAPTURE = None
# A prediction this close to the reference's is rounding (fp32 against
# float64 reads about 1e-6 stars).
SOUND_GAP = 1e-5


@dataclasses.dataclass
class State:
    cfg: dict
    eps_max: float
    seed: int
    device: torch.device
    ratings: torch.Tensor      # [U, I] neighbour users' training ratings
    mask: torch.Tensor
    active: torch.Tensor       # [batches * Q, I] active users' pool
    active_mask: torch.Tensor
    truth: torch.Tensor        # the pool's held-out ratings
    test_mask: torch.Tensor


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device):
    """One rating matrix of the neighbours and the active pool (the pool
    first), drawn on ``device`` from the seed; a share of every rating held
    out, as the paper holds out 20 % of each active user's ratings."""
    pool = cfg["users_per_job"] * cfg["user_batches"]
    ratings, mask = data.netflix_like(
        data.generator(device, seed, "data"), cfg["n_users"] + pool,
        cfg["n_items"], cfg["rank"], cfg["density"],
        cfg["popularity_skew"], cfg["noise"])
    train_mask, test_mask = data.holdout(
        data.generator(device, seed, "holdout"), mask, cfg["holdout"])
    del mask
    truth, test_mask = ratings[:pool].clone(), test_mask[:pool].clone()
    train = ratings.mul_(train_mask)
    return State(cfg, traffic["eps_max"], seed, device, train[pool:],
                 train_mask[pool:], train[:pool], train_mask[:pool], truth,
                 test_mask)


def inputs(state: State, stream: str, job: int) -> dict:
    """A job's active users (cycled through the pool) and its LSH draws,
    one family a map task, from the job's own seed."""
    from repro_torch.core import lsh   # the program's parameter types

    cfg = state.cfg
    q = cfg["users_per_job"]
    b = job % cfg["user_batches"]
    draws = data.lsh_draws(
        data.generator(state.device, state.seed, f"lsh-{stream}", job),
        cfg["n_items"], cfg["n_hashes"], cfg["bucket_width"],
        cfg["n_shards"])
    params = [
        lsh.LSHParams(a=a, b=bb, config=lsh.LSHConfig(
            n_hashes=cfg["n_hashes"], bucket_width=cfg["bucket_width"],
            n_buckets=data.n_buckets(hi - lo, cfg["compression_ratio"])))
        for (lo, hi), (a, bb) in zip(
            data.shard_bounds(state.ratings.shape[0], cfg["n_shards"]),
            draws)]
    return {"rows": slice(b * q, (b + 1) * q), "draws": draws,
            "params": params}


def run(state: State, inp: dict):
    from repro_torch.apps import cf

    cfg = state.cfg
    return cf.run_accurateml(
        state.ratings, state.mask, state.active[inp["rows"]],
        state.active_mask[inp["rows"]],
        compression_ratio=cfg["compression_ratio"], eps_max=state.eps_max,
        lsh_params=inp["params"], n_shards=cfg["n_shards"],
        n_hashes=cfg["n_hashes"], bucket_width=cfg["bucket_width"],
        device=state.device)


def reference(state: State, inp: dict, precision: str) -> ref.Answer:
    cfg = state.cfg
    return ref.accurateml_job(
        state.ratings, state.mask, state.active[inp["rows"]],
        state.active_mask[inp["rows"]], inp["draws"],
        ratio=cfg["compression_ratio"], eps_max=state.eps_max,
        width=cfg["bucket_width"], precision=precision)


def compare(state: State, out, captured, want: ref.Answer) -> torch.Tensor:
    """Each active user's gap: the largest absolute gap of its predictions,
    in stars; infinite where one is not finite.

    One neighbour user whose LSH projection lies within fp32 rounding of a
    bucket boundary moves every prediction when the program rounds it to
    the other side, and both sides are sound.  So where the job does not
    match the reference to rounding, the reference's ambiguous hashes are
    taken to their other side one at a time, each kept only if it halves
    the job's total gap: the gaps are those of the sound assignment that
    explains the answer best."""
    rows = want.pred.shape[0]
    if out is None:
        return torch.full((rows,), torch.inf, dtype=torch.float64)
    got = out.double()

    def gaps(num, den):
        pred = ref.predict(num, den, want.mean).to(got.device)
        return (got - pred).abs().max(1).values

    parts = list(want.parts)
    num, den = sum(p[0] for p in parts), sum(p[1] for p in parts)
    best = gaps(num, den)
    flips = [(s, f) for s, task in enumerate(want.tasks)
             for f in task.ambiguous]
    taken = [()] * len(parts)
    while flips and float(best.max()) > SOUND_GAP:
        trial = None
        for s, f in flips:
            (n_s, d_s), _ = want.tasks[s].contribution(taken[s] + (f,))
            g = gaps(num - parts[s][0] + n_s, den - parts[s][1] + d_s)
            if trial is None or float(g.sum()) < trial[0]:
                trial = (float(g.sum()), s, f, n_s, d_s, g)
        total, s, f, n_s, d_s, g = trial
        if total >= 0.5 * float(best.sum()):
            break
        num, den = num - parts[s][0] + n_s, den - parts[s][1] + d_s
        parts[s], taken[s], best = (n_s, d_s), taken[s] + (f,), g
        flips.remove((s, f))
    if any(taken):
        print(f"cf: job explained with {sum(map(len, taken))} of "
              f"{sum(len(t.ambiguous) for t in want.tasks)} ambiguous "
              "hashes on their other side", file=sys.stderr)
    gap = torch.where(torch.isfinite(got).all(1), best, torch.inf)
    return gap.cpu()


def launches(state: State, want: ref.Answer) -> list:
    cfg = state.cfg
    return work.cf_launches(want.shards, q=cfg["users_per_job"],
                            items=cfg["n_items"], h=cfg["n_hashes"])


def job_flops(state: State, want: ref.Answer) -> float:
    cfg = state.cfg
    return work.cf_job_flops(want.shards, q=cfg["users_per_job"],
                             items=cfg["n_items"], h=cfg["n_hashes"])


def quality(state: State, inp: dict, out) -> str:
    """The job's RMSE on the held-out ratings and its loss against the
    exact job (the paper's metric), for PERF.md."""
    cfg = state.cfg
    rows = inp["rows"]
    exact = ref.exact_job(state.ratings, state.mask, state.active[rows],
                          state.active_mask[rows], n_shards=cfg["n_shards"])
    got = ref.rmse(out, state.truth[rows], state.test_mask[rows])
    want = ref.rmse(exact, state.truth[rows], state.test_mask[rows])
    loss = max(0.0, (got - want) / max(want, 1e-12))
    return f"RMSE {got:.6f}, exact job {want:.6f}, RMSE loss {loss:.6f}"
