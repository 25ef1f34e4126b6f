"""The CF kernels' scratch (``kernels/cf_sparse.py``) mirrors the CUDA
sources and holds what they write; no card needed."""
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.kernels import cf_sparse

CSRC = Path(__file__).resolve().parent.parent / "src/repro_torch/csrc"


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, f"{name} not in {source}"
    return int(found.group(1))


def test_scratch_mirrors_the_kernels_constants():
    assert _constant("cf_sparse.cuh", "kFine") == cf_sparse.FINE
    assert _constant("cf_weights.cu", "kGroupRows") == cf_sparse.GROUP_ROWS
    assert _constant("cf_weights.cu", "kRange") == cf_sparse.RANGE
    # a range is whole groups: cf_col_place finds a group's range by division
    assert cf_sparse.RANGE % cf_sparse.GROUP_ROWS == 0


@pytest.mark.parametrize("nu,ni", [
    (1, 1), (64, 32), (65, 33), (300, 17_700), (6145, 70),
])
def test_scratch_holds_every_entry_and_its_counts(nu, ni):
    ent, offs = cf_sparse.lists(nu, ni, "cpu")
    assert ent.shape == (nu, ni, 4) and offs.shape == (nu, -(-ni // 32) + 1)
    n_ranges = -(-nu // 6144)
    assert cf_sparse.ranges(nu) == n_ranges
    count, total, colstart, col = cf_sparse.columns(nu, ni, "cpu")
    assert count.shape == (-(-nu // 64), ni)
    assert total.shape == (n_ranges, ni)
    assert colstart.shape == (n_ranges * ni + 1,)
    assert col.shape == (nu * ni, 4)     # room for a rating of every item
