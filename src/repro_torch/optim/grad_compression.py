"""Top-k gradient compression with error feedback — the training-time
analogue of the paper's shuffle-byte reduction, as
``src/repro/optim/grad_compression.py`` computes it.

A map task's "shuffle" in data-parallel training is the gradient
all-reduce.  AccurateML cuts shuffle bytes by transmitting aggregates first
and refining only the most accuracy-correlated parts; the gradient analogue
transmits only the top-k largest-magnitude gradient entries (the most
loss-correlated coordinates) and accumulates the untransmitted remainder
locally (error feedback), so — like the paper — no information is ever
discarded, only deferred.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib


class ErrorFeedback(NamedTuple):
    residual: Any            # tree like grads (f32)


def init_error_feedback(params: Any) -> ErrorFeedback:
    return ErrorFeedback(
        residual=tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device),
            params,
        )
    )


@torch.no_grad()
def compress_topk(
    grads: Any, ef: ErrorFeedback, *, frac: float,
) -> tuple[Any, ErrorFeedback, dict]:
    """Keep the top ``frac`` fraction of entries per tensor (by magnitude);
    the rest joins the residual for the next step.

    Returns (sparse-but-dense-layout grads, new error feedback, stats).
    The threshold is the k-th largest magnitude and every entry at or above
    it is kept, so ties at the threshold are all kept, whatever their
    order.  The k-th value comes from ``torch.kthvalue``: a full top-k of a
    large embedding's gradient would sort far more than it needs.
    """
    def one(g, r):
        acc = g.float() + r
        flat = acc.reshape(-1)
        k = max(1, int(frac * flat.shape[0]))
        thresh = torch.kthvalue(flat.abs(), flat.shape[0] - k + 1).values
        mask = (acc.abs() >= thresh).float()
        sent = acc * mask
        return sent, acc - sent

    flat_g = tree_lib.leaves(grads)
    flat_r = tree_lib.flatten_up_to(grads, ef.residual)
    outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
    sent = tree_lib.unflatten(grads, [o[0] for o in outs])
    resid = tree_lib.unflatten(grads, [o[1] for o in outs])
    total = sum(g.numel() for g in flat_g)
    kept = sum(max(1, int(frac * g.numel())) for g in flat_g)
    return sent, ErrorFeedback(residual=resid), {
        "kept_frac": kept / max(total, 1)
    }
