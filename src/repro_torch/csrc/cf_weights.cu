// cf_weights: masked Pearson weights between active users and neighbour
// users, from three contractions over the item axis,
//
//   num  = ac . uc     a_sq = ac^2 . um     u_sq = am . uc^2
//   w    = num / sqrt(max(a_sq * u_sq, 1e-12))
//
// where ac / uc are the centred, masked ratings and am / um the masks (the
// wrapper centres them with plain torch, as the TPU wrapper does outside its
// pallas_call).
//
// Replaces the TPU kernel src/repro/kernels/cf_weights.py:cf_weights_pallas
// (pallas_call at line 70), which holds whole [TQ, I] and [TU, I] rows in
// VMEM and runs the three products on the MXU.
//
// What bounds it here: operations.  At the CF exact-shard shape ([1024,
// 17,700] x [6,002, 17,700]) the three contractions are 6 Q U I = 6.5e11
// fp32 operations against 1.0 GB moved, far above the fp32 balance point of
// the CUDA cores.
//
// Design: one block of 256 threads per 64 x 64 output tile (the scaffolding
// of sqdist_tile.cuh).  The item axis is a loop: 16 items of each of the
// four inputs are staged per step in shared memory, transposed, and every
// thread keeps three 4 x 4 blocks of sums in registers.  The squares ac^2
// and uc^2 are formed in registers from the staged values and never
// stored, so each input is read once per tile.  fp32 FMAs, no TF32: the
// reference is fp32.  Stage 1 against a shard's 300 centroid profiles
// gives only 16 x 5 = 80 tiles for 132 SMs; splitting the item axis across
// blocks is later work.
#include <cuda_runtime.h>

#include "common.cuh"
#include "sqdist_tile.cuh"

__global__ void __launch_bounds__(kThreads)
cf_weights_kernel(const float* __restrict__ ac, const float* __restrict__ am,
                  const float* __restrict__ uc, const float* __restrict__ um,
                  int nq, int nu, int ni, float* __restrict__ out) {
  __shared__ float acs[kDepth][kPitch];
  __shared__ float ams[kDepth][kPitch];
  __shared__ float ucs[kDepth][kPitch];
  __shared__ float ums[kDepth][kPitch];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.y * kTile;
  const int u0 = blockIdx.x * kTile;
  float num[4][4];
  float asq[4][4];
  float usq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      num[i][j] = 0.f;
      asq[i][j] = 0.f;
      usq[i][j] = 0.f;
    }
  }
  for (int c0 = 0; c0 < ni; c0 += kDepth) {
    stage_tile(ac, nq, ni, q0, c0, acs);
    stage_tile(am, nq, ni, q0, c0, ams);
    stage_tile(uc, nu, ni, u0, c0, ucs);
    stage_tile(um, nu, ni, u0, c0, ums);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kDepth; ++c) {
      float a[4];
      float a2[4];
      float m[4];
      float u[4];
      float u2[4];
      float n[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = acs[c][ty + 16 * i];
        a2[i] = a[i] * a[i];
        m[i] = ams[c][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        u[j] = ucs[c][tx + 16 * j];
        u2[j] = u[j] * u[j];
        n[j] = ums[c][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          num[i][j] = fmaf(a[i], u[j], num[i][j]);
          asq[i][j] = fmaf(a2[i], n[j], asq[i][j]);
          usq[i][j] = fmaf(m[i], u2[j], usq[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = u0 + tx + 16 * j;
      if (col < nu) {
        out[static_cast<size_t>(row) * nu + col] =
            num[i][j] / sqrtf(fmaxf(asq[i][j] * usq[i][j], 1e-12f));
      }
    }
  }
}

// ac, am: [nq, ni]; uc, um: [nu, ni] fp32 -> out: [nq, nu] fp32.
// nq, nu >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int cf_weights_f32(const void* ac, const void* am, const void* uc,
                              const void* um, int nq, int nu, int ni,
                              void* out, void* stream) {
  const dim3 grid((nu + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
  cf_weights_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ac), static_cast<const float*>(am),
      static_cast<const float*>(uc), static_cast<const float*>(um), nq, nu,
      ni, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
