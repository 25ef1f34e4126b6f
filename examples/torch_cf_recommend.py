"""CF recommendation end-to-end on the PyTorch port: the paper's §IV
evaluation as a script.

Produces the Fig. 6/7/8 trade-off for the CF workload at one setting and
prints the recommended items for a few active users — exact vs AccurateML,
as ``examples/cf_recommend.py`` does with the JAX package.  It runs on the
card unless ``--device cpu`` asks for the plain versions.

    PYTHONPATH=src python examples/torch_cf_recommend.py [--device cpu]
"""
import argparse
import sys
import time

import torch

from repro_torch.apps import cf
from repro_torch.data.synthetic import holdout_split, make_netflix_like
from repro_torch.device import block_until_ready, resolve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    def key(seed):
        return torch.Generator(dev).manual_seed(seed)

    ratings, mask = make_netflix_like(
        key(1), n_users=2000, n_items=500, density=0.12, device=dev
    )
    train_mask, test_mask = holdout_split(key(2), mask, 0.2, device=dev)
    train_r = ratings * train_mask
    a, am = train_r[:20], train_mask[:20]
    truth, tmask = ratings[:20], test_mask[:20]
    nr, nm = train_r[20:], train_mask[20:]

    t0 = time.perf_counter()
    exact = block_until_ready(cf.run_exact(nr, nm, a, am, n_shards=4,
                                           device=dev))
    t_exact = time.perf_counter() - t0
    rmse_e = cf.rmse(exact, truth, tmask)

    t0 = time.perf_counter()
    approx = block_until_ready(
        cf.run_accurateml(
            nr, nm, a, am, compression_ratio=20.0, eps_max=0.05,
            lsh_generator=key(9), n_shards=4, device=dev,
        )
    )
    t_approx = time.perf_counter() - t0
    rmse_a = cf.rmse(approx, truth, tmask)

    print(f"exact:      rmse={rmse_e:.4f}  time={t_exact*1e3:.0f}ms")
    print(
        f"accurateml: rmse={rmse_a:.4f}  time={t_approx*1e3:.0f}ms  "
        f"(loss {100*cf.rmse_loss(rmse_e, rmse_a):.2f}%, "
        f"{t_exact/t_approx:.1f}x faster)"
    )

    unrated = (train_mask[:20] == 0) & (mask[:20] == 0)
    for u in range(3):
        # jnp.argsort's order: stable, ties by the lower index
        top_e = torch.argsort(-torch.where(unrated[u], exact[u], -1e9),
                              stable=True)[:5]
        top_a = torch.argsort(-torch.where(unrated[u], approx[u], -1e9),
                              stable=True)[:5]
        overlap = len(set(top_e.tolist()) & set(top_a.tolist()))
        print(f"user {u}: exact top-5 {top_e.tolist()} | "
              f"accurateml top-5 {top_a.tolist()} (overlap {overlap}/5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
