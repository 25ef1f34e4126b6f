// The 64 x 64 fp32 staging of cf_weights.
//
// A block of 256 threads computes a 64-query by 64-user tile.  Feature
// columns are staged 16 at a time through shared memory, transposed so that
// each thread reads its 4 queries and 4 users with one broadcast or
// conflict-free access each, and every thread keeps a 4 x 4 block of sums
// in registers.  fp32 throughout, no TF32: the reference is fp32.
// (knn_distance and distance_topk use the wider tile of fp32_tile.cuh.)
#pragma once

#include <cuda_runtime.h>

constexpr int kTile = 64;      // queries and points per tile
constexpr int kDepth = 16;     // feature columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPitch = kTile + 1;

// Stage rows [r0, r0 + 64) and feature columns [c0, c0 + 16) of the
// row-major [rows, dim] matrix `a` into s[column][row]; zeros outside.
// Zero features are neutral for both the cross term and the norms.
__device__ __forceinline__ void stage_tile(const float* __restrict__ a,
                                           int rows, int dim, int r0, int c0,
                                           float (*s)[kPitch]) {
  for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
    const int r = e / kDepth;
    const int c = e % kDepth;
    const int gr = r0 + r;
    const int gc = c0 + c;
    s[c][r] = (gr < rows && gc < dim)
                  ? a[static_cast<size_t>(gr) * dim + gc]
                  : 0.f;
  }
}
