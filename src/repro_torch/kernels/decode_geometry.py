"""Launch geometry of the two decode-attention kernels (``csrc/agg_refine.cu``,
``csrc/aggregated_attention.cu``), in Python.

Both launch one thread-block cluster of ``CLUSTER`` blocks of ``WARPS`` warps
per (sequence, KV head, head tile, value tile): a tile holds up to
``HEAD_TILE`` of the KV head's G query heads and ``VALUE_TILE`` of its dv
value columns, and the grid is ``(CLUSTER, Hkv x head tiles x value tiles,
B)`` (``tile`` decomposes the y index).  The cluster's
warps split the work by what is live, on the card: in ``agg_refine`` all
``UNITS`` of them the selection slots; in ``aggregated_attention`` the first
``WARPS - 1`` warps of every block (``TOKEN_UNITS``) the written tokens and
the last warp of every block (``CENTROID_UNITS``) the centroids.  The
functions below mirror that split (``decode_attn.cuh`` and the two kernels)
so that it can be checked without a card, and size the shared-memory chunks
the wrappers pass to the kernels.
"""
from __future__ import annotations

import math

CLUSTER = 8          # decode_attn.cuh kCluster: blocks per (sequence, KV head)
WARPS = 4            # kWarps: warps per block
UNITS = CLUSTER * WARPS
TOKEN_UNITS = CLUSTER * (WARPS - 1)   # aggregated_attention.cu kTokUnits
CENTROID_UNITS = CLUSTER              # kCenUnits
ROWS = 16            # rows of a chunk at most (a lane each; kRows is 32):
                     # at the LM's decode shapes a warp's live rows fit in
                     # one chunk, and four blocks fit an SM's shared memory
ROW_BUDGET = 12 * 1024   # shared-memory bytes of a warp's row chunks
HEAD_TILE = 8        # decode_attn.cuh kMaxG: query heads of a head tile
VALUE_TILE = 256     # kValueTile: value columns of a value tile


def tiles(n: int, t: int) -> int:
    return -(-n // t)


def grid(b: int, hkv: int, g: int, dv: int) -> tuple[int, int, int]:
    """The launch grid: x is the block's rank within its cluster, y every
    (KV head, head tile, value tile)."""
    return CLUSTER, hkv * tiles(g, HEAD_TILE) * tiles(dv, VALUE_TILE), b


def tile(y: int, g: int, dv: int) -> tuple[int, range, range]:
    """(KV head, its query heads, its value columns) of grid row ``y``
    (``decode_attn.cuh`` Tile)."""
    tv, tg = tiles(dv, VALUE_TILE), tiles(g, HEAD_TILE)
    vt, y = y % tv, y // tv
    g0, v0 = (y % tg) * HEAD_TILE, vt * VALUE_TILE
    return (y // tg, range(g0, min(g0 + HEAD_TILE, g)),
            range(v0, min(v0 + VALUE_TILE, dv)))


def unit(rank: int, warp: int) -> int:
    """The cluster-wide index of warp ``warp`` of block ``rank``: consecutive
    units lie in different blocks, so a little work spreads over SMs.  In
    ``aggregated_attention`` the token warps' units are ``range(TOKEN_UNITS)``
    and the centroid warp of block ``rank`` takes centroid unit ``rank``."""
    return warp * CLUSTER + rank


def refine_slots(u: int, r: int) -> range:
    """The selection slots of ``r`` that unit ``u`` folds, in order."""
    return range(u, r, UNITS)


def span(u: int, n: int, units: int) -> range:
    """Unit ``u``'s share of ``range(n)`` among ``units``: the tokens below
    ``valid_len`` (n = valid_len, ``TOKEN_UNITS``) or the K centroids (n = K,
    ``CENTROID_UNITS``), in equal runs."""
    step = math.ceil(n / units)
    lo = min(u * step, n)
    return range(lo, min(lo + step, n))


def row_bytes(width: int, itemsize: int) -> int:
    """Shared memory of a row of ``width`` values: an odd number of 16-byte
    pieces (``decode_attn.cuh`` padded16)."""
    n16 = width * itemsize // 16
    return (n16 if n16 % 2 else n16 + 1) * 16


def refine_rows(r: int, cap: int, dk: int, dv: int, itemsize: int) -> int:
    """Rows of a warp's chunk in ``agg_refine_attention``: up to ``ROWS``,
    no more than a warp's slots can hold, within ``ROW_BUDGET`` (a row: a
    key and a value tile's columns)."""
    one = row_bytes(dk, itemsize) + row_bytes(min(dv, VALUE_TILE), itemsize)
    most = math.ceil(r / UNITS) * cap
    return max(1, min(ROWS, most, ROW_BUDGET // one))


def flat_rows(s: int, kb: int, dk: int, dv: int,
              itemsize: int) -> tuple[int, int]:
    """(token rows, centroid rows) of a token warp's and a centroid warp's
    chunk in ``aggregated_attention``: each up to ``ROWS``, no more than a
    warp's span (at ``valid_len`` = S for tokens) and within
    ``ROW_BUDGET``; centroid rows are f32.  A row: a key and a value
    tile's columns."""
    dv = min(dv, VALUE_TILE)
    tok_one = row_bytes(dk, itemsize) + row_bytes(dv, itemsize)
    tok = max(1, min(ROWS, math.ceil(s / TOKEN_UNITS),
                     ROW_BUDGET // tok_one))
    cen_one = row_bytes(dk, 4) + row_bytes(dv, 4)
    cen = max(1, min(ROWS, math.ceil(kb / CENTROID_UNITS),
                     ROW_BUDGET // cen_one))
    return tok, cen
