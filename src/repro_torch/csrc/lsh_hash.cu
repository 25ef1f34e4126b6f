// lsh_hash: the p-stable hashes floor((X @ A + b) / w), [N, H] int32.
//
// Replaces the TPU kernel src/repro/kernels/lsh_hash.py:lsh_hash_pallas
// (pallas_call at line 50), which holds the whole [D, H] projection in VMEM
// and runs one [TN, D] x [D, H] product on the MXU per grid step, so the
// fp32 projection never reaches HBM.
//
// What bounds it here: bytes.  H = 4 outputs per row: 2 H = 8 operations per
// 4-byte input, far below the balance point.  At the CF width A is 17,700 x
// 4 x 4 B = 283 KB, more than a block's shared memory.
//
// Design: a block of 8 warps owns 8 rows, one a warp.  A is staged in
// chunks of D, transposed to [H][chunk] so that neighbouring lanes read
// neighbouring words; each lane keeps the H partial sums of its row in
// registers while the warp walks the chunk with neighbouring lanes on
// neighbouring floats of X (coalesced).  The sums are reduced with shuffles
// and lane 0 writes floor((s + b) / w), the expression of the reference.
// The product is computed here, never by a library GEMM.
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kWarps = 8;
constexpr int kMaxH = 8;        // hashes per row the kernel takes
constexpr int kStage = 4096;    // floats of A staged per chunk (16 KB)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, int n, int d, int h,
                float width, int* __restrict__ out) {
  __shared__ float sa[kStage];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int chunk = kStage / h;
  float acc[kMaxH];
#pragma unroll
  for (int j = 0; j < kMaxH; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += chunk) {
    const int len = min(chunk, d - c0);
    // A[c0:c0+len, :] is contiguous: len * h floats, staged as sa[j][c].
    for (int e = threadIdx.x; e < len * h; e += blockDim.x) {
      sa[(e % h) * chunk + e / h] = a[static_cast<size_t>(c0) * h + e];
    }
    __syncthreads();
    if (row < n) {
      const float* xr = x + static_cast<size_t>(row) * d + c0;
      for (int c = lane; c < len; c += 32) {
        const float v = xr[c];
#pragma unroll
        for (int j = 0; j < kMaxH; ++j) {
          if (j < h) acc[j] = fmaf(v, sa[j * chunk + c], acc[j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kMaxH; ++j) {
    if (j >= h) break;
    const float s = warp_sum(acc[j]);
    if (lane == 0 && row < n) {
      out[static_cast<size_t>(row) * h + j] =
          static_cast<int>(floorf((s + b[j]) / width));
    }
  }
}

// x: [n, d], a: [d, h], b: [h] fp32 -> out: [n, h] int32.  n >= 1,
// 1 <= h <= kMaxH.  Returns cudaGetLastError().
extern "C" int lsh_hash_f32(const void* x, const void* a, const void* b,
                            int n, int d, int h, float width, void* out,
                            void* stream) {
  if (h < 1 || h > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kWarps - 1) / kWarps);
  lsh_hash_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), n, d, h, width, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
