"""The decode-attention kernels' launch geometry (``kernels/decode_geometry``),
without a card: every (KV head, query head, value column) falls to exactly
one cluster's tile, every selection slot, every written token and every
centroid to exactly one warp of its cluster, and the chunk sizes the
wrappers pass fit the kernels' shared memory."""
import itertools
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.kernels import decode_geometry as geo

SWEEP = [  # (B, S, K, R, Hkv)
    (1, 1024, 64, 64, 8),      # qwen3-8b prefill at rf 1.0
    (4, 1024, 64, 4, 8),       # decode at rf 0.05
    (4, 1024, 64, 16, 8),      # rf 0.25
    (4, 1024, 64, 64, 8),      # rf 1.0
    (3, 64, 8, 3, 2),          # smoke heads
    (2, 128, 10, 5, 1),        # MQA
    (1, 4096, 128, 100, 8),    # R above the cluster's warps
    (2, 40, 1000, 1500, 3),    # more centroids and slots than 32 a warp
]


CSRC = Path(__file__).resolve().parent.parent / "src/repro_torch/csrc"


def _constexpr(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_geometry_mirrors_the_kernels_constants():
    assert _constexpr("decode_attn.cuh", "kCluster") == geo.CLUSTER
    assert _constexpr("decode_attn.cuh", "kWarps") == geo.WARPS
    assert geo.ROWS <= _constexpr("decode_attn.cuh", "kRows")
    assert _constexpr("decode_attn.cuh", "kMaxG") == geo.HEAD_TILE
    assert _constexpr("decode_attn.cuh", "kValueTile") == geo.VALUE_TILE


def _units():
    return [geo.unit(rank, warp) for rank in range(geo.CLUSTER)
            for warp in range(geo.WARPS)]


def test_units_number_the_cluster_warps_once():
    assert sorted(_units()) == list(range(geo.UNITS))
    # consecutive units lie in different blocks
    ranks = {geo.unit(rank, warp): rank for rank in range(geo.CLUSTER)
             for warp in range(geo.WARPS)}
    assert all(ranks[u] != ranks[u + 1] for u in range(geo.UNITS - 1))


# (G, dv) of the decode shapes: qwen3-8b and the smoke configs, MQA, and
# deepseek-v2-236b's absorbed MLA (128 heads over one latent KV head, 512
# values) with a partial tile of each
HEADS = [(4, 128), (2, 16), (8, 48), (128, 512), (16, 320), (12, 264)]


@pytest.mark.parametrize("g,dv", HEADS)
@pytest.mark.parametrize("b,s,kb,r,hkv", SWEEP)
def test_grid_is_whole_clusters(b, s, kb, r, hkv, g, dv):
    gx, gy, gz = geo.grid(b, hkv, g, dv)
    assert gx == geo.CLUSTER and gz == b
    assert gy == hkv * -(-g // geo.HEAD_TILE) * -(-dv // geo.VALUE_TILE)
    assert (gx * gy * gz) % geo.CLUSTER == 0


@pytest.mark.parametrize("g,dv", HEADS)
@pytest.mark.parametrize("hkv", [1, 2, 8])
def test_every_head_and_value_falls_to_one_tile(hkv, g, dv):
    seen = []
    for y in range(geo.grid(1, hkv, g, dv)[1]):
        kvh, heads, cols = geo.tile(y, g, dv)
        assert 0 <= kvh < hkv and len(heads) <= geo.HEAD_TILE
        assert len(cols) <= geo.VALUE_TILE and cols.start % geo.VALUE_TILE \
            == 0
        seen += [(kvh, h, c) for h in heads for c in cols]
    assert sorted(seen) == [(k, h, c) for k in range(hkv) for h in range(g)
                            for c in range(dv)]


@pytest.mark.parametrize("b,s,kb,r,hkv", SWEEP)
def test_every_selection_slot_falls_to_one_warp(b, s, kb, r, hkv):
    owners = [u for u in _units() for _ in geo.refine_slots(u, r)]
    slots = sorted(j for u in _units() for j in geo.refine_slots(u, r))
    assert slots == list(range(r)) and len(owners) == r


@pytest.mark.parametrize("b,s,kb,r,hkv", SWEEP)
def test_every_token_below_valid_len_falls_to_one_warp(b, s, kb, r, hkv):
    for vl in sorted({0, 1, 31, 33, 128, s // 3, s - 5, s, 1000 % (s + 1)}):
        token_warps = [geo.unit(rank, warp) for rank in range(geo.CLUSTER)
                       for warp in range(geo.WARPS - 1)]
        assert sorted(token_warps) == list(range(geo.TOKEN_UNITS))
        spans = [geo.span(u, vl, geo.TOKEN_UNITS)
                 for u in range(geo.TOKEN_UNITS)]
        # contiguous runs, one a unit, covering [0, valid_len) once
        assert [t for sp in spans for t in sp] == list(range(vl))
        assert max(len(sp) for sp in spans) <= -(-vl // geo.TOKEN_UNITS)


@pytest.mark.parametrize("b,s,kb,r,hkv", SWEEP)
def test_every_centroid_falls_to_one_warp(b, s, kb, r, hkv):
    # one centroid warp a block: unit = the block's rank
    spans = [geo.span(rank, kb, geo.CENTROID_UNITS)
             for rank in range(geo.CLUSTER)]
    assert geo.CENTROID_UNITS == geo.CLUSTER
    assert [c for sp in spans for c in sp] == list(range(kb))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,s,kb,r,hkv", SWEEP)
def test_chunks_fit_the_row_budget(b, s, kb, r, hkv, itemsize):
    for dk, dv in itertools.product((16, 64, 128, 256, 576),
                                    (16, 48, 128, 256, 320, 512)):
        cap = 32 if s >= 1024 else 40
        rows = geo.refine_rows(r, cap, dk, dv, itemsize)
        dvt = min(dv, geo.VALUE_TILE)
        one = geo.row_bytes(dk, itemsize) + geo.row_bytes(dvt, itemsize)
        assert 1 <= rows <= geo.ROWS
        assert rows * one <= geo.ROW_BUDGET
        tok, cen = geo.flat_rows(s, kb, dk, dv, itemsize)
        assert 1 <= tok <= geo.ROWS and 1 <= cen <= geo.ROWS
        assert tok * one <= geo.ROW_BUDGET
        assert cen * (geo.row_bytes(dk, 4) + geo.row_bytes(dvt, 4)) \
            <= geo.ROW_BUDGET


def test_rows_take_an_odd_number_of_16_byte_pieces():
    for width, itemsize in itertools.product((8, 16, 48, 128, 256), (2, 4)):
        n = geo.row_bytes(width, itemsize)
        assert n >= width * itemsize and n % 16 == 0 and (n // 16) % 2 == 1


def test_qwen3_8b_chunks_hold_a_warps_decode_rows():
    """At the LM's shapes a chunk holds 16 rows of bf16 and a centroid
    warp's eight centroids: more than a warp's live rows at decode
    (valid_len 160 over 64 buckets)."""
    assert geo.refine_rows(4, 32, 128, 128, 2) == 16
    assert geo.flat_rows(1024, 64, 128, 128, 2) == (16, 8)


def test_mla_chunks_fit_a_tile_of_latent_rows():
    """deepseek-v2-236b's latent rows (576-wide keys, a 256-column value
    tile, bf16): seven a chunk; its f32 centroids three."""
    assert geo.refine_rows(16, 32, 576, 512, 2) == 7
    assert geo.flat_rows(1024, 64, 576, 512, 2) == (7, 3)
