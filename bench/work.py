"""The work a job needs: operations and bytes of each kernel launch, and
of the whole job, at the cell's shapes; and the card's published peaks.

Counted from the shapes and from what the reference's own selection needs
(its per-map-task counts, ``reference.knn`` / ``reference.cf``), never
from the program: the work is the same whatever implements it.  Each input
byte is read once and each output byte written once; the data-dependent
parts (live buckets, refined slots, distinct rows, rated and co-rated
entries) are counted on these inputs.  The kernel counts are those of the
port's kernel table (PERF.md): bytes over 3.35 TB/s against fp32
operations over 67 TFLOP/s, the CF kernels by rated and co-rated entries.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit: fp32 on the
# CUDA cores (the port's kernels and products run in fp32) and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def _topk(q: int, cols: int, k: int) -> float:
    """Bytes of a k-best selection over ``cols`` candidates a row: every
    value read, a label for each winner, the k pairs written."""
    return 4 * q * cols + 4 * q * min(k, cols) + 8 * q * k


def knn_launches(shards: list[dict], *, q: int, d: int, h: int, k: int
                 ) -> list[tuple[str, float, float]]:
    """(op, flops, bytes) of each kernel launch of one AccurateML kNN job."""
    out = []
    for s in shards:
        n, nb, live = s["n"], s["buckets"], s["live"]
        out.append(("lsh_hash", 2.0 * n * d * h,
                    4 * (n * d + d * h + h + n)))
        stage1 = 2.0 * q * live * d
        if "budget" not in s:
            out.append(("distance_topk", stage1,
                        4 * (q * d + live * d + nb) + nb + 8 * q * k))
            continue
        b = s["budget"]
        out.append(("knn_distance", stage1, 4 * (q * d + live * d + q * live)))
        out.append(("refine_distances", 4.0 * s["refined"] * d,
                    4 * q * d + 4 * s["rows"] * d + 9 * q * b))
        out.append(("candidate_topk", 0.0, _topk(q, nb, k)))
        out.append(("candidate_topk", 0.0, _topk(q, b + k, k)))
    out.append(("candidate_topk", 0.0, _topk(q, len(shards) * k, k)))
    return out


def knn_job_flops(shards: list[dict], *, q: int, d: int, h: int) -> float:
    """Operations the kNN job needs: the LSH projections, the centroid sums,
    stage 1 over the live centroids and the refined distances."""
    return sum(2.0 * s["n"] * d * h + s["n"] * d + 2.0 * q * s["live"] * d
               + 4.0 * s.get("refined", 0) * d for s in shards)


def cf_launches(shards: list[dict], *, q: int, items: int, h: int
                ) -> list[tuple[str, float, float]]:
    """(op, flops, bytes) of each kernel launch of one AccurateML CF job."""
    out = []
    for s in shards:
        n, nb = s["n"], s["buckets"]
        out.append(("lsh_hash", 2.0 * s["rated"] * h,
                    4 * (n * items + items * h + h + n)))
        out.append(("cf_weights",
                    6.0 * s["stage1_co"] + s["active_rated"]
                    + s["profile_entries"],
                    4 * (2 * q * items + 2 * nb * items + q * nb)))
        if "budget" in s:
            out.append(("cf_refine",
                        8.0 * s["refine_co"] + 4.0 * s["refine_rated"],
                        16 * q * items + 8 * s["rows"] * items
                        + 9 * q * s["budget"]))
    return out


def cf_job_flops(shards: list[dict], *, q: int, items: int, h: int) -> float:
    """Operations the CF job needs: LSH projections and the bucket sums
    over rated entries, the stage-1 weights over co-rated ones, the
    surrogate sums over the unrefined buckets' rated items (numerator and
    denominator), the refined users' terms, and the prediction."""
    total = 2.0 * q * items
    for s in shards:
        total += (2.0 * s["rated"] * h + 4.0 * s["rated"]
                  + 6.0 * s["stage1_co"] + s["active_rated"]
                  + s["profile_entries"] + 4.0 * s["surrogate_entries"]
                  + 8.0 * s.get("refine_co", 0)
                  + 4.0 * s.get("refine_rated", 0))
    return total
