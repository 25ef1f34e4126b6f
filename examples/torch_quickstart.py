"""Quickstart on the PyTorch port: AccurateML's accuracy/time trade-off on
both paper workloads.

Runs exact, uniform-sampling, and AccurateML processing on synthetic
mfeat-like (kNN) and netflix-like (CF) data and prints the trade-off table,
as ``examples/quickstart.py`` does with the JAX package.  It runs on the
card (the kernels build at their first launch) unless ``--device cpu``
asks for the plain versions.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
import time

import torch

from repro_torch.apps import cf, knn
from repro_torch.data.synthetic import (
    holdout_split, make_mfeat_like, make_netflix_like,
)
from repro_torch.device import block_until_ready, resolve


def timed(fn):
    t0 = time.perf_counter()
    out = block_until_ready(fn())
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    def key(seed):
        return torch.Generator(dev).manual_seed(seed)

    print("=== kNN classification (paper workload 1) ===")
    x, y = make_mfeat_like(
        key(0), n_points=12_000, n_features=64, n_classes=10, device=dev,
    )
    tx, ty, qx, qy = x[200:], y[200:], x[:200], y[:200]
    k = 5

    exact, t_exact = timed(
        lambda: knn.run_exact(tx, ty, qx, k=k, n_classes=10, n_shards=4,
                              device=dev)
    )
    acc_exact = knn.accuracy(exact, qy)
    print(f"exact:            acc={acc_exact:.4f}  time={t_exact*1e3:.0f}ms")

    for ratio, eps in ((10.0, 0.01), (20.0, 0.05), (100.0, 0.1)):
        pred, t = timed(
            lambda: knn.run_accurateml(
                tx, ty, qx, k=k, n_classes=10, compression_ratio=ratio,
                eps_max=eps, lsh_generator=key(7), n_shards=4, device=dev,
            )
        )
        acc = knn.accuracy(pred, qy)
        print(
            f"accurateml r={ratio:5.0f} eps={eps:4.2f}: acc={acc:.4f} "
            f"loss={100*knn.accuracy_loss(acc_exact, acc):5.2f}%  "
            f"time={t*1e3:.0f}ms ({t_exact/t:.1f}x faster)"
        )

    pred, t = timed(
        lambda: knn.run_sampled(
            tx, ty, qx, k=k, n_classes=10, sample_frac=0.1,
            sample_generator=key(3), n_shards=4, device=dev,
        )
    )
    acc = knn.accuracy(pred, qy)
    print(
        f"sampled 10%:      acc={acc:.4f} "
        f"loss={100*knn.accuracy_loss(acc_exact, acc):5.2f}%  "
        f"time={t*1e3:.0f}ms"
    )

    print("\n=== CF recommendation (paper workload 2) ===")
    ratings, mask = make_netflix_like(
        key(1), n_users=1500, n_items=400, density=0.12, device=dev
    )
    train_mask, test_mask = holdout_split(key(2), mask, 0.2, device=dev)
    train_r = ratings * train_mask
    a, am = train_r[:50], train_mask[:50]
    truth, tmask = ratings[:50], test_mask[:50]
    nr, nm = train_r[50:], train_mask[50:]

    exact, t_exact = timed(lambda: cf.run_exact(nr, nm, a, am, n_shards=4,
                                                device=dev))
    rmse_exact = cf.rmse(exact, truth, tmask)
    print(f"exact:            rmse={rmse_exact:.4f}  time={t_exact*1e3:.0f}ms")
    for ratio, eps in ((10.0, 0.01), (20.0, 0.05)):
        pred, t = timed(
            lambda: cf.run_accurateml(
                nr, nm, a, am, compression_ratio=ratio, eps_max=eps,
                lsh_generator=key(9), n_shards=4, device=dev,
            )
        )
        r = cf.rmse(pred, truth, tmask)
        print(
            f"accurateml r={ratio:5.0f} eps={eps:4.2f}: rmse={r:.4f} "
            f"loss={100*cf.rmse_loss(rmse_exact, r):5.2f}%  "
            f"time={t*1e3:.0f}ms ({t_exact/t:.1f}x faster)"
        )
    pred, t = timed(
        lambda: cf.run_sampled(
            nr, nm, a, am, sample_frac=0.1, sample_generator=key(4),
            n_shards=4, device=dev,
        )
    )
    r = cf.rmse(pred, truth, tmask)
    print(
        f"sampled 10%:      rmse={r:.4f} "
        f"loss={100*cf.rmse_loss(rmse_exact, r):5.2f}%  time={t*1e3:.0f}ms"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
