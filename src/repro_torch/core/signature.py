"""The uint32 bucket signature of H p-stable hashes, in torch's integers.

``sum_j uint32(h_j) * prime_j`` with uint32 wrap-around, as
``src/repro/core/lsh.py:fine_bucket_ids`` computes it in JAX.  The plain
version of the ``lsh_hash`` kernel's ids epilogue (``kernels/ref.py``) and
the LM cache's key hashing (``models/aggregated_kv.py``) use it.
"""
from __future__ import annotations

import torch

# Large primes combining the H p-stable hashes into one bucket signature.
SIGNATURE_PRIMES = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393, 2654435789,
    1103515245, 2971215073, 433494437, 1540483477, 2166136261, 16777619,
)
_MASK32 = 0xFFFFFFFF


def wrapped_signature(h: torch.Tensor) -> torch.Tensor:
    """[..., H] int32 hashes -> [...] int64 holding the uint32 signature
    ``sum_j uint32(h_j) * prime_j`` with uint32 wrap-around.

    torch has no uint32 arithmetic, so it runs in int64: each prime splits
    into 16-bit halves, so that every product, and the sum of the H terms,
    stays below 2^53; the sum is then taken mod 2^32.
    """
    lo, hi = _prime_halves(h.shape[-1], h.device)
    h = h.to(torch.int64) & _MASK32                          # uint32(h)
    terms = h * lo + (((h * hi) & 0xFFFF) << 16)             # mod 2^32
    return terms.sum(dim=-1) & _MASK32


_PRIME_HALVES: dict = {}


def _prime_halves(n: int, device: torch.device):
    """The low and high 16 bits of the first n signature primes, [n] int64
    on ``device``, made once per device: a copy from the host to the card
    would wait for the card at every call (every layer of every decode
    step)."""
    key = (n, str(device))
    if key not in _PRIME_HALVES:
        if n > len(SIGNATURE_PRIMES):
            raise ValueError(f"{n} hashes: at most {len(SIGNATURE_PRIMES)}")
        primes = SIGNATURE_PRIMES[:n]
        _PRIME_HALVES[key] = tuple(
            torch.tensor([f(p) for p in primes], dtype=torch.int64,
                         device=device)
            for f in (lambda p: p & 0xFFFF, lambda p: p >> 16))
    return _PRIME_HALVES[key]
