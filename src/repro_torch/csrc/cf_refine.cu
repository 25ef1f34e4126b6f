// cf_refine: CF stage-2 refinement without the [Q, B, I] gathers.
//
// For each query q and selected user v = idx[q, b] with use[q, b] != 0:
//
//   w[q, b]    = shrunk Pearson weight of q and v over their co-rated items
//   num[q, :] += w[q, b] * centred[v, :]
//   den[q, :] += |w[q, b]| * mask[v, :]
//
// A slot with use == 0 has w exactly 0 and adds exactly 0, so it is skipped
// without reading its row.  Indices are clipped to [0, U) as the TPU
// wrapper clips them.
//
// Replaces the TPU kernel src/repro/kernels/cf_refine.py:cf_refine_pallas
// (pallas_call at line 115).  There the grid walks (q, b) in order; a
// scalar-prefetch index map DMAs the selected user's centred and mask rows
// into VMEM, and the query's [1, I] num / den blocks stay resident in VMEM
// across b.  At I = 17,700 a query's active row, mask and two accumulators
// are 283 KB, more than the 227 KB of shared memory a block may have.
//
// What bounds it here: at eps 0.05 ([1024, 301] slots against a 6,002-user
// shard) the least time is set by its operations, about 13 per item and
// used slot (6.9e10, 1.0 ms in fp32), over its bytes with each distinct
// selected row read once (1.1 GB, 0.35 ms).  This design reads each used
// slot's two I-float rows (141.6 KB at I = 17,700) once per launch, so a
// row selected by many queries is read once per query: 43.6 GB a launch,
// most of it served by the L2 cache or not is not measured.
//
// Design: two launches, both deterministic and free of atomics.
//   (a) cf_refine_weights: one warp per (q, b).  Neighbouring lanes read
//       neighbouring floats of the query's rows and the selected user's
//       rows, accumulate the four sums (w_num, a_sq, u_sq, co) and reduce
//       them with shuffles; lane 0 writes the shrunk, use-gated w.
//   (b) cf_refine_accumulate: one block per (q, 1024-item tile).  Each
//       thread holds the num / den of 4 items in registers and walks b in
//       ascending order, the TPU's order, adding w * centred_row and
//       |w| * mask_row.  The query's used slots (row, w) are compacted
//       into shared memory 256 slots at a time, so the loop issues only the
//       row loads.
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kWarps = 8;
constexpr int kSlotsPerBlock = 64;   // (a): slots of one query per block
constexpr int kAccThreads = 256;     // (b): threads per block
constexpr int kItemsPerThread = 4;   // (b): items each thread accumulates
constexpr int kItemTile = kAccThreads * kItemsPerThread;
constexpr int kSlotStage = kAccThreads;  // (b): slots staged per pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
cf_refine_weights(const float* __restrict__ ac, const float* __restrict__ am,
                  const float* __restrict__ uc, const float* __restrict__ um,
                  const int* __restrict__ idx,
                  const unsigned char* __restrict__ use, int nu, int b,
                  int ni, float shrink, float* __restrict__ w) {
  const int qi = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* acr = ac + static_cast<size_t>(qi) * ni;
  const float* amr = am + static_cast<size_t>(qi) * ni;
  const int b0 = blockIdx.x * kSlotsPerBlock;
  const int b1 = min(b, b0 + kSlotsPerBlock);
  for (int slot = b0 + warp; slot < b1; slot += kWarps) {
    const size_t o = static_cast<size_t>(qi) * b + slot;
    if (use[o] == 0) {
      if (lane == 0) w[o] = 0.f;
      continue;
    }
    const int row = min(max(idx[o], 0), nu - 1);
    const float* ucr = uc + static_cast<size_t>(row) * ni;
    const float* umr = um + static_cast<size_t>(row) * ni;
    float w_num = 0.f;
    float a_sq = 0.f;
    float u_sq = 0.f;
    float co = 0.f;
    for (int i = lane; i < ni; i += 32) {
      const float a = acr[i];
      const float m = amr[i];
      const float c = ucr[i];
      const float n = umr[i];
      w_num = fmaf(a, c, w_num);
      a_sq = fmaf(a * a, n, a_sq);
      u_sq = fmaf(m, c * c, u_sq);
      co = fmaf(m, n, co);
    }
    w_num = warp_sum(w_num);
    a_sq = warp_sum(a_sq);
    u_sq = warp_sum(u_sq);
    co = warp_sum(co);
    if (lane == 0) {
      const float wt = w_num / sqrtf(fmaxf(a_sq * u_sq, 1e-12f));
      w[o] = wt * (co / (co + shrink));
    }
  }
}

__global__ void __launch_bounds__(kAccThreads)
cf_refine_accumulate(const float* __restrict__ uc,
                     const float* __restrict__ um,
                     const int* __restrict__ idx,
                     const unsigned char* __restrict__ use,
                     const float* __restrict__ w, int nu, int b, int ni,
                     float* __restrict__ num, float* __restrict__ den) {
  __shared__ int rows[kSlotStage];
  __shared__ float ws[kSlotStage];
  __shared__ int warp_used[kAccThreads / 32];
  const int qi = blockIdx.y;
  const int i0 = blockIdx.x * kItemTile + threadIdx.x;
  float acc_n[kItemsPerThread];
  float acc_d[kItemsPerThread];
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    acc_n[k] = 0.f;
    acc_d[k] = 0.f;
  }
  for (int s0 = 0; s0 < b; s0 += kSlotStage) {
    // Compact the used slots of this pass into shared memory, in ascending
    // slot order: one slot per thread, ranked by a ballot within each warp
    // and by the warp counts before it.
    const int s = s0 + threadIdx.x;
    bool used = false;
    int row = 0;
    float wt = 0.f;
    if (s < b) {
      const size_t o = static_cast<size_t>(qi) * b + s;
      used = use[o] != 0;
      if (used) {
        row = min(max(idx[o], 0), nu - 1);
        wt = w[o];
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, used);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_used[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u));
    int n = 0;
#pragma unroll
    for (int k = 0; k < kAccThreads / 32; ++k) {
      pos += k < warp ? warp_used[k] : 0;
      n += warp_used[k];
    }
    if (used) {
      rows[pos] = row;
      ws[pos] = wt;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float wj = ws[j];
      const float aw = fabsf(wj);
      const size_t base = static_cast<size_t>(rows[j]) * ni;
#pragma unroll
      for (int k = 0; k < kItemsPerThread; ++k) {
        const int i = i0 + k * kAccThreads;
        if (i < ni) {
          acc_n[k] = fmaf(wj, uc[base + i], acc_n[k]);
          acc_d[k] = fmaf(aw, um[base + i], acc_d[k]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const int i = i0 + k * kAccThreads;
    if (i < ni) {
      num[static_cast<size_t>(qi) * ni + i] = acc_n[k];
      den[static_cast<size_t>(qi) * ni + i] = acc_d[k];
    }
  }
}

// ac, am: [nq, ni]; uc, um: [nu, ni] fp32; idx: [nq, b] int32; use: [nq, b]
// bytes -> w: [nq, b], num, den: [nq, ni] fp32.  nq, nu >= 1; b may be 0
// (then num and den are written as zeros).  Returns cudaGetLastError()
// after the launches.
extern "C" int cf_refine_f32(const void* ac, const void* am, const void* uc,
                             const void* um, const void* idx, const void* use,
                             int nq, int nu, int b, int ni, float shrink,
                             void* w, void* num, void* den, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b > 0) {
    const dim3 grid((b + kSlotsPerBlock - 1) / kSlotsPerBlock, nq);
    cf_refine_weights<<<grid, kWarps * 32, 0, st>>>(
        static_cast<const float*>(ac), static_cast<const float*>(am),
        static_cast<const float*>(uc), static_cast<const float*>(um),
        static_cast<const int*>(idx), static_cast<const unsigned char*>(use),
        nu, b, ni, shrink, static_cast<float*>(w));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const dim3 grid((ni + kItemTile - 1) / kItemTile, nq);
  cf_refine_accumulate<<<grid, kAccThreads, 0, st>>>(
      static_cast<const float*>(uc), static_cast<const float*>(um),
      static_cast<const int*>(idx), static_cast<const unsigned char*>(use),
      static_cast<const float*>(w), nu, b, ni, static_cast<float*>(num),
      static_cast<float*>(den));
  return static_cast<int>(cudaGetLastError());
}
