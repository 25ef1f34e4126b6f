// knn_distance: the [Q, N] squared-L2 matrix max(|q|^2 - 2 q.p + |p|^2, 0).
//
// Replaces the TPU kernel src/repro/kernels/knn_distance.py:
// knn_distance_pallas (pallas_call at line 51), which runs the cross term on
// the MXU and assembles the expanded form in VREGs, one [TQ, TN] tile per
// grid step.
//
// What bounds it here: operations at the kNN stage-1 shapes (Q = 1024,
// N = K = 2875 centroids, D = 217): 2 Q N D = 1.3 GFLOP against 14 MB moved,
// about 90 FLOP per byte, above the fp32 balance point of the CUDA cores.
//
// Design: one block per 128 x 64 output tile (fp32_tile.cuh: 4-byte
// cp.async four stages deep, 8 x 4 outputs a thread, fp32 FMAs, no TF32).
// 64-wide tiles: at [1024, 2875] the 360 tiles of 128 x 64 leave the
// busiest of 132 SMs three tiles (24 K outputs) where 184 of 128 x 128
// would leave it two (32 K).  The norms are summed from the same staged
// values, so the inputs are read once per tile.  The epilogue clamps at 0
// and, a pair of rows at a time, turns each warp's fragments around through
// shared memory so that every store writes 32 neighbouring floats of a row
// (the rows, 11,500 bytes at N = 2875, are not 16-byte aligned).
#include <cuda_runtime.h>

#include "common.cuh"
#include "fp32_tile.cuh"

constexpr int kBN = 64;   // points per tile

__global__ void __launch_bounds__(kTileThreads, 2)
knn_distance_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    int nq, int n, int dim, float* __restrict__ out) {
  using T = Fp32Tile<kBN>;
  constexpr int NC = T::kCols;
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.y * kBM;
  const int p0 = blockIdx.x * kBN;
  const float* qn = smem + kStages * T::kStageFloats;
  const float* pn = qn + kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tyl = (threadIdx.x >> 4) & 1;   // the warp's two ty rows
  const int tx = threadIdx.x & 15;
  // one tile: its epilogue may use the stages, all loads are done
  tile_stream<kBN, true>(q, nq, p, min(n, p0 + kBN), dim, q0, p0, smem,
                        [&](int, float (&acc)[8][NC]) {
    float pj[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) pj[j] = pn[T::col(j)];
    float* w = smem + warp * 2 * T::kBPitch;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qi = qn[T::row(i)];
#pragma unroll
      for (int h = 0; h < NC / 4; ++h) {
        float4 v;
        v.x = fmaxf(qi - 2.f * acc[i][4 * h] + pj[4 * h], 0.f);
        v.y = fmaxf(qi - 2.f * acc[i][4 * h + 1] + pj[4 * h + 1], 0.f);
        v.z = fmaxf(qi - 2.f * acc[i][4 * h + 2] + pj[4 * h + 2], 0.f);
        v.w = fmaxf(qi - 2.f * acc[i][4 * h + 3] + pj[4 * h + 3], 0.f);
        *reinterpret_cast<float4*>(w + tyl * T::kBPitch + h * 64 + tx * 4) =
            v;
      }
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + (i >> 2) * 64 + (2 * warp + rr) * 4 + (i & 3);
        if (row < nq) {
          float* o = out + static_cast<size_t>(row) * n;
#pragma unroll
          for (int m = 0; m < kBN / 32; ++m) {
            const int c = p0 + m * 32 + lane;
            if (c < n) o[c] = w[rr * T::kBPitch + m * 32 + lane];
          }
        }
      }
      __syncwarp();
    }
  });
}

// q: [nq, dim], p: [n, dim] fp32 -> out: [nq, n] fp32.  nq, n >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int knn_distance_f32(const void* q, const void* p, int nq, int n,
                                int dim, void* out, void* stream) {
  constexpr int bytes = Fp32Tile<kBN>::kSmemFloats * 4;
  cudaFuncSetAttribute(knn_distance_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((n + kBN - 1) / kBN, (nq + kBM - 1) / kBM);
  knn_distance_kernel<<<grid, kTileThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), nq, n, dim,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
