"""Scratch of the two CF kernels (``csrc/cf_sparse.cuh``,
``csrc/cf_weights.cu``, ``csrc/cf_refine.cu``), in Python.

Both kernels first compact each rating row's rated entries on the card
(``cf_sparse.cuh:cf_compact``) into a list with room for I entries, so that
no count is read back to size it: ``[rows, I]`` float4 entries ``{item,
centred, mask, centred^2}`` and ``[rows, fine(I) + 1]`` int32 offsets of
every ``FINE`` items.  ``cf_weights`` then turns the neighbours' lists into
columns by item (``cf_columns``), counted in groups of ``GROUP_ROWS`` rows,
a range of ``RANGE`` neighbours at a time (a block's sums in shared
memory).
"""
from __future__ import annotations

import torch

FINE = 32           # cf_sparse.cuh kFine: items an offset step
GROUP_ROWS = 64     # cf_weights.cu kGroupRows: rows counted together
RANGE = 6144        # kRange: neighbour users a block


def fine(ni: int) -> int:
    return -(-ni // FINE)


def groups(rows: int) -> int:
    return -(-rows // GROUP_ROWS)


def ranges(nu: int) -> int:
    return -(-nu // RANGE)


def lists(rows: int, ni: int, device: torch.device):
    """(entries [rows, ni, 4] fp32, offsets [rows, fine(ni) + 1] int32)
    for one side of a call: the compaction's output, uninitialised."""
    return (torch.empty((rows, ni, 4), dtype=torch.float32, device=device),
            torch.empty((rows, fine(ni) + 1), dtype=torch.int32,
                        device=device))


def columns(nu: int, ni: int, device: torch.device):
    """(count [groups(nu), ni], total [ranges(nu), ni], colstart
    [ranges(nu) ni + 1] int32, columns [nu ni, 4] fp32): the neighbour
    side's columns by item and their counts, uninitialised."""
    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)
    return (ints(groups(nu), ni), ints(ranges(nu), ni),
            ints(ranges(nu) * ni + 1),
            torch.empty((nu * ni, 4), dtype=torch.float32, device=device))

