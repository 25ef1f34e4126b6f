"""``chip_smoke.work`` counts the work the kernels must do on their inputs:
for the two CF kernels operations on the rated and co-rated entries only;
for ``refine_distances`` each distinct selected row read once; for
``candidate_topk`` every candidate's value of a 2-D list or a [P, Q, M]
stack, and only the winners' labels.
Each input read once and each output written once.  Hand counts on tiny
CPU inputs; no card needed."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


# Active users rate {0, 1} and {2}; neighbours {0}, {0, 2} and nothing.
# Co-rated pairs: (0, 0) item 0, (0, 1) item 0, (1, 1) item 2.  The mask
# values 0.5 and 2 count as rated.
PATTERN_A = [[1.0, 0.5, 0.0], [0.0, 0.0, 1.0]]
PATTERN_U = [[2.0, 0.0, 0.0], [1.0, 0.0, 1.0], [0.0, 0.0, 0.0]]


def _ratings(mask):
    return _t(np.where(np.asarray(mask) != 0, 4.0, 0.0))


def _weights(am, um):
    am, um = _t(am), _t(um)
    return chip_smoke.work(torch, "cf_weights",
                           (_ratings(am), am, _ratings(um), um), {})


def test_cf_weights_with_no_ratings_does_no_operations():
    flops, nbytes = _weights(np.zeros((2, 5)), np.zeros((3, 5)))
    assert flops == 0
    assert nbytes == 4 * (2 * 2 * 5 + 2 * 3 * 5 + 2 * 3)


def test_cf_weights_dense_counts_every_triple():
    flops, nbytes = _weights(np.ones((2, 4)), np.ones((3, 4)))
    # 6 operations per (q, u, item) triple, a square per rated entry
    assert flops == 6 * 2 * 3 * 4 + (2 * 4 + 3 * 4)
    assert nbytes == 4 * (2 * 2 * 4 + 2 * 3 * 4 + 2 * 3)


def test_cf_weights_counts_the_co_rated_triples():
    flops, nbytes = _weights(PATTERN_A, PATTERN_U)
    assert flops == 6 * 3 + (3 + 3)
    assert nbytes == 4 * (2 * 2 * 3 + 2 * 3 * 3 + 2 * 3)


def _refine(am, um, idx, use):
    am, um = _t(am), _t(um)
    return chip_smoke.work(
        torch, "cf_refine",
        (_ratings(am), am, _ratings(um), um, _t(idx, torch.int32),
         _t(use, torch.bool)), {"shrink": 8.0})


def test_cf_refine_with_no_ratings_does_no_operations():
    flops, nbytes = _refine(np.zeros((2, 5)), np.zeros((3, 5)),
                            [[0, 1], [2, 2]], [[True, True], [True, True]])
    assert flops == 0
    # active rows and num / den, 3 distinct rows, idx + use + w
    assert nbytes == 16 * 2 * 5 + 8 * 3 * 5 + 9 * 2 * 2


def test_cf_refine_dense_counts_every_item_of_every_used_slot():
    flops, nbytes = _refine(np.ones((2, 4)), np.ones((3, 4)),
                            [[0, 1], [1, 2]], [[True, True], [True, True]])
    # 8 per co-rated item and 4 per item the selected user rated, a slot
    assert flops == 4 * (8 * 4 + 4 * 4)
    assert nbytes == 16 * 2 * 4 + 8 * 3 * 4 + 9 * 2 * 2


def test_cf_refine_counts_duplicate_used_slots_and_skips_unused_ones():
    # query 0: user 1 twice (co-rated item 0; user 1 rated 2 items) and an
    # unused slot; query 1: index 5 and -1 clip to users 2 and 0, user 2
    # rated nothing, the slot of user 0 is unused
    flops, nbytes = _refine(PATTERN_A, PATTERN_U, [[1, 1, 0], [5, -1, 2]],
                            [[True, True, False], [True, False, True]])
    assert flops == 2 * (8 * 1 + 4 * 2)
    # distinct used rows: users 1 and 2
    assert nbytes == 16 * 2 * 3 + 8 * 2 * 3 + 9 * 2 * 3


def test_cf_bounds_are_set_by_bytes_on_sparse_ratings():
    r = np.random.default_rng(0)
    am = (r.random((8, 500)) < 0.02).astype(np.float32)
    um = (r.random((40, 500)) < 0.02).astype(np.float32)
    idx = r.integers(0, 40, (8, 6))
    use = r.random((8, 6)) < 0.8
    for flops, nbytes in (_weights(am, um), _refine(am, um, idx, use)):
        assert chip_smoke.bound_ms(flops, nbytes)[1] == "bytes"


def _refine_distances(idx, valid, with_buckets):
    r = np.random.default_rng(1)
    args = [_t(r.standard_normal((2, 3))), _t(r.standard_normal((5, 3))),
            _t(idx, torch.int32), _t(valid, torch.bool)]
    kwargs = {}
    if with_buckets:   # the schedule key is not part of the work
        args.append(_t([0, 0, 1, 1, 2], torch.int32))
        kwargs = {"n_buckets": 3}
    return chip_smoke.work(torch, "refine_distances", tuple(args), kwargs)


@pytest.mark.parametrize("with_buckets", [False, True])
def test_refine_distances_reads_each_distinct_row_once(with_buckets):
    # valid slots: rows 0, 1 (query 0) and 4, 0, 2 (query 1); row 1's second
    # slot is padding
    flops, nbytes = _refine_distances([[0, 1, 1], [4, 0, 2]],
                                      [[True, True, False],
                                       [True, True, True]], with_buckets)
    assert flops == 4 * 5 * 3           # |x|^2 and q.x per valid slot
    # queries, distinct rows {0, 1, 2, 4}, idx, valid, out
    assert nbytes == 4 * 2 * 3 + 4 * 4 * 3 + 4 * 6 + 6 + 4 * 6


def test_refine_distances_with_nothing_valid_reads_no_row():
    flops, nbytes = _refine_distances([[0, 1, 1], [4, 0, 2]],
                                      np.zeros((2, 3), bool), True)
    assert flops == 0
    assert nbytes == 4 * 2 * 3 + 4 * 6 + 6 + 4 * 6


# k 3, two rows: each value read once, the labels of the winners only (3
# a row, fewer where the row has fewer columns), the [2, 3] output written
@pytest.mark.parametrize("shape,seeded,want", [
    ((2, 4), False, 4 * 2 * 4 + 4 * 2 * 3 + 8 * 2 * 3),
    # the seed's 3 values are columns too
    ((2, 4), True, 4 * 2 * (4 + 3) + 4 * 2 * 3 + 8 * 2 * 3),
    # a [3, 2, 4] stack: 12 candidates a row
    ((3, 2, 4), True, 4 * 2 * (12 + 3) + 4 * 2 * 3 + 8 * 2 * 3),
    # 2 columns for k 3: the third slot is unseeded and reads no label
    ((2, 2), False, 4 * 2 * 2 + 4 * 2 * 2 + 8 * 2 * 3),
])
def test_candidate_topk_reads_every_candidate_once(shape, seeded, want):
    d = torch.zeros(shape)
    lab = torch.zeros(shape, dtype=torch.int32)
    seed = ((torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32))
            if seeded else ())
    flops, nbytes = chip_smoke.work(torch, "candidate_topk",
                                    (d, lab, *seed), {"k": 3})
    assert flops == 0 and nbytes == want


def test_candidate_topk_yardstick_reads_a_stack_as_one_row():
    """chip_smoke's torch.topk call over [seed | part 0 | part 1 ...]."""
    r = np.random.default_rng(3)
    d = torch.tensor(r.random((3, 2, 4)), dtype=torch.float32)
    seed = torch.tensor(r.random((2, 2)), dtype=torch.float32)
    args = (d, torch.zeros((3, 2, 4), dtype=torch.int32), seed,
            torch.zeros((2, 2), dtype=torch.int32))
    got = chip_smoke.library_call(torch, "candidate_topk", args, {"k": 2})()
    flat = torch.cat([seed, d.permute(1, 0, 2).reshape(2, 12)], dim=1)
    assert torch.equal(got.values, flat.sort(dim=1).values[:, :2])


@pytest.mark.parametrize("ids", [False, True])
def test_lsh_hash_writes_one_id_or_h_hashes_a_row(ids):
    n, d, h = 7, 5, 3
    x, a, b = torch.zeros((n, d)), torch.zeros((d, h)), torch.zeros(h)
    flops, nbytes = chip_smoke.work(torch, "lsh_hash", (x, a, b, 4.0),
                                    {"base": 16, "factor": 2} if ids else {})
    assert flops == 2 * n * d * h
    # X, A and b read once; [N] ids (4 N bytes) or [N, H] hashes written
    assert nbytes == 4 * (n * d + d * h + h) + (4 * n if ids else 4 * n * h)
