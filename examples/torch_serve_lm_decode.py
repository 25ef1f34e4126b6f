"""Deadline-degraded LM decoding through the front door, on the PyTorch
port, as ``examples/serve_lm_decode.py`` does with the JAX package.

Generation as an anytime workload: a ``DecodeEngine`` over the aggregated
KV cache serves greedy decodes behind ``FrontDoor``, so the per-step
``refine_frac`` (the decode-side eps) is *granted* by the deadline
controller — and when the queue backs up, the load-shed ladder coarsens it
fleet-wide instead of rejecting traffic.  The script submits a burst past
the queue limit and prints, per request, the granted eps, the stage-1 vs
refined token disagreement, and the ladder's rung at admission — the
accuracy-for-latency trade, visible end to end.  The engine runs on the
card unless ``--device cpu`` asks for the plain versions.

    PYTHONPATH=src python examples/torch_serve_lm_decode.py [--device cpu]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.budget import BudgetPolicy
from repro_torch.device import resolve
from repro_torch.models.model import init_params
from repro_torch.serve.frontdoor import FrontDoor, LoadShedLadder
from repro_torch.serve.lm import DecodeEngine, LMServable, lm_pad_sizes
from repro_torch.serve.request import Response
from repro_torch.serve.scheduler import ContinuousBatcher
from repro_torch.serve.server import Server

PROMPT_LEN = 5
NEW_TOKENS = 4
BURST = 6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    def key(seed):
        return torch.Generator(dev).manual_seed(seed)

    cfg = get_config("qwen3-8b", smoke=True).with_(
        agg_kv=True, agg_layout="bucket_major", agg_compression=4
    )
    params = init_params(cfg, key(0), device=dev)
    engine = DecodeEngine(
        params, cfg, max_slots=2, s_max=16, generator=key(7), n_shards=2,
    )
    servable = LMServable(
        engine, prompt_len=PROMPT_LEN, max_new_tokens=NEW_TOKENS
    )
    server = Server(
        [servable],
        policy=BudgetPolicy(eps_max=1.0),
        batcher=ContinuousBatcher(
            max_batch=2, pad_sizes=lm_pad_sizes(engine.max_slots),
            slo_aware=False,
        ),
    )
    server.calibrate("lm")
    door = FrontDoor(server, queue_limit=2, ladder=LoadShedLadder())

    rng = np.random.default_rng(0)
    print(f"burst of {BURST} decodes into queue_limit=2 "
          f"(K={engine.n_buckets} buckets, {NEW_TOKENS} tokens each)")
    rids = []
    for i in range(BURST):
        prompt = rng.integers(
            0, cfg.vocab_size, size=(PROMPT_LEN,)
        ).astype(np.int32)
        rid = door.submit("lm", (prompt,), deadline_s=30.0)
        rids.append((rid, door.ladder.level))
    while door.backlog():
        door.pump(max_batches=4)

    for rid, rung in rids:
        ans = door.result(rid)
        if isinstance(ans, Response):
            toks = ans.refined["tokens"] if ans.refined is not None \
                else ans.stage1["tokens"]
            print(
                f"  rid={rid} rung@admit={rung} eps={ans.eps_granted:.3f} "
                f"disagree={ans.accuracy_proxy} tokens={toks.tolist()}"
            )
        else:
            print(f"  rid={rid} rung@admit={rung} REFUSED ({ans.reason})")

    # Shard death mid-service: degraded answers, never errors.
    engine.kill_shard(0)
    rid = door.submit(
        "lm",
        (rng.integers(0, cfg.vocab_size, size=(PROMPT_LEN,))
         .astype(np.int32),),
        deadline_s=30.0,
    )
    while door.backlog():
        door.pump(max_batches=4)
    ans = door.result(rid)
    if not isinstance(ans, Response):
        raise AssertionError(f"after kill_shard(0): {ans!r}, not an answer")
    print(
        f"after kill_shard(0): partial_shards={ans.partial_shards} "
        f"tokens={ans.stage1['tokens'].tolist()} (degraded, not an error)"
    )
    print(f"final shed level: {door.ladder.level} "
          f"(eps ceiling now {server.controller.policy.eps_max:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
