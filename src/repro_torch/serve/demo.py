"""Reference serving fixture shared by the examples and the benchmarks.

A demo and a latency benchmark must measure the same system: same synthetic
datasets, servable hyper-parameters, budget policy, and SLO derivation.
Keeping that setup here prevents the two from silently diverging.

SLO classes are derived from the *fitted* cost model (not hard-coded
milliseconds) so the behaviour — relaxed fits full eps_max, tight fits a
sliver, hopeless escalates — is hardware independent.

The JAX package draws its data and LSH projections from PRNG keys; here
they come from seeded ``torch.Generator``s (the same seeds), on the CPU so
that the draws do not depend on the device the servables run on.
"""
from __future__ import annotations

import torch

from repro_torch.apps.cf import CFServable
from repro_torch.apps.knn import KNNServable
from repro_torch.core.budget import BudgetPolicy
from repro_torch.data.synthetic import make_mfeat_like, make_netflix_like
from repro_torch.serve.deadline import DeadlineController
from repro_torch.serve.scheduler import ContinuousBatcher
from repro_torch.serve.server import Server
from repro_torch.store import AggregateStore

KNN_D, CF_ITEMS, N_CLASSES = 48, 384, 10


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def build_demo_server(
    *, knn_points: int = 16_384, cf_users: int = 3_072, batch: int = 4,
    device: str | torch.device = "cuda", **server_kwargs,
):
    """Server over synthetic kNN + CF shards; returns (server, queries,
    active, active_mask), the request arrays on the CPU.

    Extra keyword arguments (``tracer``, ``window_s``, ``slo_objectives``,
    ``flight``, ...) pass straight through to ``Server`` so the example and
    the benchmark can opt into observability without forking the fixture.
    """
    # One aggregate store shared by both shards: pyramids, cross-ratio
    # merges, and snapshot/warm-start all live in one place.
    store = AggregateStore()
    x, y = make_mfeat_like(
        _gen(0), n_points=knn_points + 64, n_features=KNN_D,
        n_classes=N_CLASSES, modes_per_class=24, mode_scale=0.5,
        device="cpu",
    )
    knn = KNNServable(
        x[64:], y[64:], n_classes=N_CLASSES, k=5,
        lsh_generator=_gen(7), store=store, device=device,
    )
    ratings, mask = make_netflix_like(
        _gen(1), n_users=cf_users, n_items=CF_ITEMS, density=0.12,
        device="cpu",
    )
    cf = CFServable(
        ratings[8:] * mask[8:], mask[8:], lsh_generator=_gen(8),
        store=store, device=device,
    )
    policy = BudgetPolicy(
        compression_ratio=20.0, eps_max=0.32, degrade_floor=0.004
    )
    server = Server(
        [knn, cf],
        controller=DeadlineController(policy),
        batcher=ContinuousBatcher(max_batch=batch, pad_sizes=(batch,)),
        **server_kwargs,
    )
    return server, x[:64], ratings[:8] * mask[:8], mask[:8]


def prepare_demo_server(server: Server, *, batch: int = 4) -> dict:
    """Calibrate, freeze the online correction, prewarm, derive SLO classes.

    Freezing ``ema`` makes grants a deterministic function of the fitted
    model, so warmup and measured traffic receive identical budgets.
    Returns ``{kind: {class_name: deadline_s}}``.
    """
    ctl = server.controller
    for kind in server.servables:
        server.calibrate(kind, batch=batch)
    ctl.ema = 0.0
    for kind in server.servables:
        server.prewarm(kind, batch=batch)
    server.reset_metrics()

    slos: dict = {}
    for kind, servable in server.servables.items():
        n = servable.n_points
        slos[kind] = {
            "relaxed": 1.5 * ctl.deadline_for(kind, n, ctl.policy.eps_max),
            "tight": 1.15 * ctl.deadline_for(kind, n, 0.02),
            "hopeless": 0.25 * ctl.deadline_for(kind, n, 0.0),
        }
    return slos
