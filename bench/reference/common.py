"""What both reference jobs share: precision, LSH bucketing, aggregation
order and the refinement selection of Algorithm 1."""
from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = ("float64", "float32", "tf32")

# The uint32 signature of H p-stable hashes is sum_j uint32(h_j) * prime_j
# with wrap-around (src/repro/core/lsh.py, the JAX package's definition);
# the bucket id is the signature modulo the number of buckets.
SIGNATURE_PRIMES = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393, 2654435789,
    1103515245, 2971215073, 433494437, 1540483477, 2166136261, 16777619,
)
_MASK32 = 0xFFFFFFFF


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), as the tensor cores round a product's inputs."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32_products(on: bool):
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in the reference's precision.  TF32 runs on the tensor cores
    on a card; on the CPU, which has none, the inputs are rounded to TF32
    and multiplied in float32, which is what the tensor cores compute."""
    dt = dtype_of(precision)
    a, b = a.to(dt), b.to(dt)
    if precision != "tf32":
        with _tf32_products(False):
            return a @ b
    if a.is_cuda:
        with _tf32_products(True):
            return a @ b
    return _round_tf32(a) @ _round_tf32(b)


# A projection within this many fp32 rounding units (of its terms'
# absolute sum) of a bucket boundary may land on either side in a float32
# program, both sides sound: a sum's rounding error in any order is a few
# units, growing with the square root of its terms.
AMBIGUOUS_UNITS = 32.0


def hashes(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, width: float,
           precision: str) -> tuple[torch.Tensor, list]:
    """The p-stable hashes h_j = floor((x . a_j + b_j) / w), [N, H] int64,
    and the ambiguous ones: (row, j, the other side's hash) for each
    projection within ``AMBIGUOUS_UNITS`` fp32 units of a boundary."""
    dt = dtype_of(precision)
    proj = (mm(x, a, precision) + b.to(dt)) / width
    h = torch.floor(proj)
    scale = (mm(x.abs(), a.abs(), "float64")
             + b.abs().to(torch.float64)) / width
    slack = AMBIGUOUS_UNITS * 2.0 ** -24 * scale.to(dt)
    low = (proj - h) < slack
    high = (h + 1 - proj) < slack
    rows, js = torch.nonzero(low | high, as_tuple=True)
    alt = torch.where(low, h - 1, h + 1)[rows, js]
    amb = list(zip(rows.tolist(), js.tolist(), alt.long().tolist()))
    return h.to(torch.int64), amb


def ids_of(h: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """[N] int64 bucket of each row: the hashes' uint32 signature modulo
    the bucket count."""
    h = h & _MASK32
    sig = torch.zeros(h.shape[0], dtype=torch.int64, device=h.device)
    for j in range(h.shape[1]):
        p = SIGNATURE_PRIMES[j]
        lo, hi = p & 0xFFFF, p >> 16          # keeps each product < 2^63
        sig = sig + h[:, j] * lo + (((h[:, j] * hi) & 0xFFFF) << 16)
        sig = sig & _MASK32
    return sig % n_buckets


def bucket_ids(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               width: float, n_buckets: int, precision: str) -> torch.Tensor:
    """[N] int64 LSH bucket of each row."""
    return ids_of(hashes(x, a, b, width, precision)[0], n_buckets)


def bucket_order(ids: torch.Tensor, n_buckets: int):
    """(counts [K], order [N]: the rows sorted by bucket, each bucket's rows
    in index order, offsets [K] of each bucket's first row in that order)."""
    counts = torch.bincount(ids, minlength=n_buckets)
    order = torch.sort(ids, stable=True).indices
    offsets = torch.cumsum(counts, 0) - counts
    return counts, order, offsets


def budget(n_points: int, eps_max: float) -> int:
    """Originals a query refines in a map task: ceil(eps_max N)."""
    return math.ceil(eps_max * n_points) if eps_max > 0 else 0


def select(key: torch.Tensor, live: torch.Tensor, counts: torch.Tensor,
           order: torch.Tensor, offsets: torch.Tensor, n_budget: int):
    """Algorithm 1, lines 4-10, for each query: rank the live buckets by
    ``key`` ascending (equal keys: the lower bucket first), then take the
    ranked buckets' originals, each bucket's in index order, until
    ``n_budget`` are taken.  Returns (idx [Q, B] rows, 0 where not valid;
    valid [Q, B]; covered [Q, K]: live buckets all of whose originals were
    taken, which the refined originals replace)."""
    q, k = key.shape
    keyed = torch.where(live[None, :], key, torch.inf)
    rank = torch.sort(keyed, dim=1, stable=True).indices        # [Q, K]
    cnt = torch.where(live, counts, 0)[rank]
    cum = torch.cumsum(cnt, dim=1)
    pos = torch.arange(n_budget, device=key.device).expand(q, n_budget)
    slot = torch.searchsorted(cum, pos.contiguous(), right=True)
    slot = slot.clamp_max(k - 1)
    within = pos - (cum - cnt).gather(1, slot)
    valid = pos < cum[:, -1:]
    where = offsets[rank.gather(1, slot)] + within
    idx = torch.where(valid, order[torch.where(valid, where, 0)], 0)
    covered = torch.zeros((q, k), dtype=torch.bool, device=key.device)
    covered = covered.scatter(1, rank, (cum <= n_budget) & (cnt > 0))
    return idx, valid, covered
