// Running k-best lists held in registers, and their merge across a warp.
//
// The semantics are those of src/repro/kernels/topk_stream.py:merge_kbest:
// the k smallest candidates under the order (value, column), so on equal
// values the lower column (the incumbent, or the earlier original index)
// wins, as jax.lax.top_k does.  A list has CAP >= k slots, sorted
// ascending; empty slots hold (+inf, INT_MAX) and sort after every real or
// BIG-padded candidate.
#pragma once

#include <climits>
#include <math.h>

#include "common.cuh"

__device__ __forceinline__ bool kb_less(float d1, int c1, float d2, int c2) {
  return d1 < d2 || (d1 == d2 && c1 < c2);
}

template <int CAP>
__device__ __forceinline__ void kb_clear(float (&bd)[CAP], int (&bc)[CAP]) {
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    bd[j] = INFINITY;
    bc[j] = INT_MAX;
  }
}

// Insert (d, c) into the sorted list; the largest entry falls off the end.
// Fully unrolled so that the list stays in registers.
template <int CAP>
__device__ __forceinline__ void kb_insert(float (&bd)[CAP], int (&bc)[CAP],
                                          float d, int c) {
  if (!kb_less(d, c, bd[CAP - 1], bc[CAP - 1])) return;
  bool placed = false;
#pragma unroll
  for (int j = CAP - 1; j >= 0; --j) {
    if (!placed) {
      if (j > 0 && kb_less(d, c, bd[j - 1], bc[j - 1])) {
        bd[j] = bd[j - 1];
        bc[j] = bc[j - 1];
      } else {
        bd[j] = d;
        bc[j] = c;
        placed = true;
      }
    }
  }
}

// Drop the head of the list (it was taken by the merge).
template <int CAP>
__device__ __forceinline__ void kb_pop(float (&bd)[CAP], int (&bc)[CAP]) {
#pragma unroll
  for (int j = 0; j < CAP - 1; ++j) {
    bd[j] = bd[j + 1];
    bc[j] = bc[j + 1];
  }
  bd[CAP - 1] = INFINITY;
  bc[CAP - 1] = INT_MAX;
}

// One merge round over the lanes of a group of WIDTH lanes (WIDTH a power of
// two, at most 32, groups aligned in the warp): every lane offers its head,
// a butterfly of shuffles finds the least (value, column), and the lane that
// owned it pops it.  Columns are unique across the group's real entries, so
// exactly one lane pops a real winner.  Returns the winner to every lane.
template <int CAP, int WIDTH>
__device__ __forceinline__ void kb_take(float (&bd)[CAP], int (&bc)[CAP],
                                        float& wd, int& wc) {
  float hd = bd[0];
  int hc = bc[0];
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, hd, off);
    const int oc = __shfl_xor_sync(0xffffffffu, hc, off);
    if (kb_less(od, oc, hd, hc)) {
      hd = od;
      hc = oc;
    }
  }
  if (bc[0] == hc && bd[0] == hd) kb_pop(bd, bc);
  wd = hd;
  wc = hc;
}

// k-best of one row, computed by one whole warp: the seed occupies columns
// [0, k) and the m candidates columns [k, k + m), so seeded selection equals
// one selection over the concatenation [seed | candidates].  A null seed
// means (BIG, label 0) in every seed slot, as the Pallas wrapper seeds it.
template <int CAP>
__device__ __forceinline__ void warp_row_topk(
    const float* __restrict__ cand_d, const int* __restrict__ cand_l, int m,
    const float* __restrict__ seed_d, const int* __restrict__ seed_l, int k,
    float* __restrict__ out_d, int* __restrict__ out_l, int lane) {
  float bd[CAP];
  int bc[CAP];
  kb_clear(bd, bc);
  if (lane < k) kb_insert(bd, bc, seed_d ? seed_d[lane] : REPRO_BIG, lane);
  for (int j = lane; j < m; j += 32) kb_insert(bd, bc, cand_d[j], k + j);

  float my_d = REPRO_BIG;
  int my_c = 0;
  for (int r = 0; r < k; ++r) {
    float wd;
    int wc;
    kb_take<CAP, 32>(bd, bc, wd, wc);
    if (lane == r) {
      my_d = wd;
      my_c = wc;
    }
  }
  if (lane < k) {
    out_d[lane] = my_d;
    if (my_c < k) {
      out_l[lane] = seed_l ? seed_l[my_c] : 0;
    } else {
      out_l[lane] = cand_l[my_c - k];
    }
  }
}

// ---------------------------------------------------------------------------
// Rows split over several lanes, each lane with loads in flight.
//
// A row's candidates may come in parts: part p holds columns
// [k + p m, k + (p + 1) m) at d + p * part_stride (a [parts, q, m] stack of
// shard-local lists, read in place).  The seed holds columns [0, k).
// ---------------------------------------------------------------------------

constexpr int kScanBatch = 8;   // loads a lane issues before it inserts

// Feed this lane's list with seed column first (a lane has at most one:
// k <= 32 <= stride) and candidates first, first + stride, ... of every
// part, kScanBatch loads issued before any of them is inserted.  A null
// seed is (BIG, label 0) in every seed slot.  The order of insertion does
// not change the list.
template <int CAP>
__device__ __forceinline__ void kb_scan_parts(
    float (&bd)[CAP], int (&bc)[CAP], const float* __restrict__ d, int parts,
    size_t part_stride, int m, const float* __restrict__ seed_d, int k,
    int first, int stride) {
  const float sv =
      first < k ? (seed_d ? seed_d[first] : REPRO_BIG) : INFINITY;
  for (int p = 0; p < parts; ++p) {
    const float* row = d + p * part_stride;
    const int col0 = k + p * m;
    for (int j0 = first; j0 < m; j0 += kScanBatch * stride) {
      float v[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int j = j0 + u * stride;
        v[u] = j < m ? row[j] : INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int j = j0 + u * stride;
        if (j < m) kb_insert(bd, bc, v[u], col0 + j);
      }
    }
  }
  if (first < k) kb_insert(bd, bc, sv, first);
}

// The label of column c of a row laid out as kb_scan_parts reads it.
__device__ __forceinline__ int kb_label(int c, const int* __restrict__ l,
                                        size_t part_stride, int m,
                                        const int* __restrict__ seed_l,
                                        int k) {
  if (c < k) return seed_l ? seed_l[c] : 0;
  const int p = (c - k) / m;
  return l[p * part_stride + (c - k - p * m)];
}
