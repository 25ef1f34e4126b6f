"""Running k-best machinery shared by the selection kernels and their plain
versions.

``BIG`` is the padding sentinel of every selection (never zero: a zero
distance wins every merge).  ``merge_kbest`` is the plain statement of the
tie rule the CUDA kernels implement in ``csrc/kbest.cuh``: the k smallest
of [best | candidates] under (value, column), so the incumbent wins a tie,
then the lowest column, as ``jax.lax.top_k`` does.  ``select_in_rounds``
widens the k of ``distance_topk``'s wide regime past ``MAX_K``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BIG = 3.0e38
MAX_K = 32  # the largest k of candidate_topk and distance_topk's wide regime


def merge_kbest(
    best_d: torch.Tensor, best_l: torch.Tensor,
    cand_d: torch.Tensor, cand_l: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge [TQ, TC] candidates into a sorted [TQ, k] running best by k
    rounds of (min, first argmin, mask out)."""
    d = torch.cat([best_d, cand_d], dim=1)
    lab = torch.cat([best_l, cand_l], dim=1)
    out_d, out_l = [], []
    for _ in range(k):
        m = d.min(dim=1, keepdim=True).values
        first = torch.argmax((d == m).to(torch.int8), dim=1, keepdim=True)
        out_d.append(m)
        out_l.append(lab.gather(1, first))
        d = d.scatter(1, first, BIG)
    return torch.cat(out_d, dim=1), torch.cat(out_l, dim=1)


def pad_to_multiple(x: torch.Tensor, mult: int, dim: int, value=0):
    """Pad ``dim`` of ``x`` at its end up to a multiple of ``mult`` with
    ``value`` (BIG for distances, never zero)."""
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - dim % x.dim())
    widths[-1] = pad
    return F.pad(x, widths, value=value)


def select_in_rounds(select, queries: torch.Tensor, points: torch.Tensor,
                     labels: torch.Tensor, valid: torch.Tensor | None, *,
                     k: int, metric: str):
    """A k-best wider than ``MAX_K`` from a selection of at most ``MAX_K``.

    ``select`` has ``distance_topk``'s signature and takes k <= MAX_K.  Each
    query row is selected on its own, in rounds of at most MAX_K; a round
    masks the points the earlier rounds chose, so the rounds together rank
    as one pass would: by (score, index), ties to the lowest index.  Returns
    ([Q,k] scores, [Q,k] int32 labels), padding slots (BIG, label 0).
    """
    n = points.shape[0]
    dev = queries.device
    if queries.shape[0] == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    cols = torch.arange(n, dtype=torch.int32, device=dev)
    rows_d, rows_l = [], []
    for i in range(queries.shape[0]):
        live = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
                else valid.clone())
        parts_d, parts_c = [], []
        for lo in range(0, k, MAX_K):
            d, c = select(queries[i:i + 1], points, cols, live,
                          k=min(MAX_K, k - lo), metric=metric)
            parts_d.append(d[0])
            parts_c.append(c[0])
            if lo + MAX_K < k:
                taken = torch.zeros(n + 1, dtype=torch.bool, device=dev)
                taken[torch.where(d[0] < BIG / 2, c[0].long(), n)] = True
                live &= ~taken[:n]
        d, c = torch.cat(parts_d), torch.cat(parts_c)
        rows_d.append(d)
        rows_l.append(torch.where(d < BIG / 2, labels[c.long()], 0)
                      .to(torch.int32))
    return torch.stack(rows_d), torch.stack(rows_l)
