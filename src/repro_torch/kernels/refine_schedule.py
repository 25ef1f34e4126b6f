"""The scratch of the ``refine_distances`` kernel's schedule
(``csrc/refine_distances.cu``).

A run is a maximal stretch of valid slots of one query row whose rows lie
in one bucket (the schedule key, clipped into [0, n_keys)).  The kernel
lists each row's run starts and ends in order (the r-th start pairs with
the r-th end), groups the runs by key and cuts each key's runs into work
items of at most ``CHUNK``; a work item stages the rows of its longest run
once for all of its runs.  The wrapper takes the scratch from
``scratch``; a test pins ``CHUNK`` to the source's ``kChunk``.
"""
from __future__ import annotations

import torch

CHUNK = 16   # refine_distances.cu kChunk: runs a work item


def item_capacity(nq: int, nb: int, n_keys: int) -> int:
    """Room for every work item: each key's runs in chunks of CHUNK, at most
    nq nb runs in all."""
    return nq * nb // CHUNK + n_keys


def scratch(nq: int, nb: int, n_keys: int, device: torch.device):
    """The kernel's scratch, uninitialised, in its argument order: q2 [nq]
    fp32; starts, ends [nq, nb]; n_runs [nq]; counts, offsets, cursor
    [n_keys]; items [item_capacity, 2]; runs [nq nb, 2]; counters [2]
    (int32).  Sized without a count read back: a row has at most nb runs."""
    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)
    return (torch.empty(nq, dtype=torch.float32, device=device),
            ints(nq, nb), ints(nq, nb), ints(nq), ints(n_keys),
            ints(n_keys), ints(n_keys),
            ints(item_capacity(nq, nb, n_keys), 2), ints(nq * nb, 2), ints(2))
