// The rated entries of CF rating rows, compacted on the card with the
// centring fused: the shared first step of cf_weights and cf_refine.
//
// The reference centres a row as (r - mean) * m with mean = sum(r m) /
// max(sum(m), 1), and every term of its Pearson sums and neighbourhood
// accumulations carries the mask of a row it reads, so an entry whose mask
// is 0 adds exactly 0.  At the Netflix density (1.2 %) a row of 17,700
// items holds about 170 such entries, so both kernels work on them alone.
//
// cf_compact writes, for each row, its entries whose mask is nonzero in item
// order into a list with room for I entries (no count is read back to size
// it), each a float4 {item (int bits), centred, mask, centred^2}, and the
// position of the first entry of every kFine items, so that a kernel finds
// any row's part in an aligned item range with two loads:
//
//   ent  [rows, I]            float4   (the first offs[r][nfine] valid)
//   offs [rows, nfine + 1]    int      offs[r][f] = entries before item 32 f
//
// One warp a row.  The dense row is read once: the first pass streams r and
// m, forms sum(r m) and sum(m) lane by lane in item order (the butterfly
// that joins the lanes is fixed, so the mean has the same bits every run),
// and writes the raw (item, r, m) of each rated entry at the place a ballot
// gives it; the second pass rewrites the few entries written (from L2)
// with the centred value and its square.
#pragma once

#include <cuda_runtime.h>

constexpr int kFine = 32;          // items an offset step: a ballot's
constexpr int kCompactWarps = 8;   // rows a block of cf_compact
constexpr int kCompactUnroll = 8;  // 32-item steps whose loads go at once

__host__ __device__ constexpr int cf_fine(int ni) {
  return (ni + kFine - 1) / kFine;
}

__device__ __forceinline__ float cf_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int cf_item(const float4& e) {
  return __float_as_int(e.x);
}

// cp.async: a 16-byte copy to shared memory that takes no registers, so
// that a block can have the loads of several steps in flight.
__device__ __forceinline__ void copy16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Rows [0, na) come from (ra, ma), rows [na, na + nb) from (rb, mb); each
// side has its own ent / offs.
__global__ void __launch_bounds__(kCompactWarps * 32)
cf_compact_kernel(const float* __restrict__ ra, const float* __restrict__ ma,
                  int na, float4* __restrict__ enta, int* __restrict__ offsa,
                  const float* __restrict__ rb, const float* __restrict__ mb,
                  int nb, float4* __restrict__ entb, int* __restrict__ offsb,
                  int ni) {
  const int lane = threadIdx.x & 31;
  int row = blockIdx.x * kCompactWarps + (threadIdx.x >> 5);
  if (row >= na + nb) return;
  const float* r = ra;
  const float* m = ma;
  float4* ent = enta;
  int* offs = offsa;
  if (row >= na) {
    row -= na;
    r = rb;
    m = mb;
    ent = entb;
    offs = offsb;
  }
  const int nfine = cf_fine(ni);
  r += static_cast<size_t>(row) * ni;
  m += static_cast<size_t>(row) * ni;
  ent += static_cast<size_t>(row) * ni;
  offs += static_cast<size_t>(row) * (nfine + 1);

  float s_rm = 0.f;
  float s_m = 0.f;
  int cnt = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = 0; i0 < ni; i0 += 32 * kCompactUnroll) {
    float rv[kCompactUnroll];
    float mv[kCompactUnroll];
#pragma unroll
    for (int s = 0; s < kCompactUnroll; ++s) {
      const int i = i0 + 32 * s + lane;
      rv[s] = i < ni ? __ldcs(r + i) : 0.f;  // read once: evict first,
      mv[s] = i < ni ? __ldcs(m + i) : 0.f;  // so that the lists stay in L2
    }
#pragma unroll
    for (int s = 0; s < kCompactUnroll; ++s) {
      const int f = i0 / 32 + s;
      if (f < nfine) {
        s_rm = fmaf(rv[s], mv[s], s_rm);
        s_m += mv[s];
        const bool rated = mv[s] != 0.f;
        const unsigned ballot = __ballot_sync(0xffffffffu, rated);
        if (rated) {
          ent[cnt + __popc(ballot & below)] =
              make_float4(__int_as_float(32 * f + lane), rv[s], mv[s], 0.f);
        }
        if (lane == 0) offs[f] = cnt;
        cnt += __popc(ballot);
      }
    }
  }
  if (lane == 0) offs[nfine] = cnt;
  const float mean = cf_warp_sum(s_rm) / fmaxf(cf_warp_sum(s_m), 1.f);
  __syncwarp();
  for (int e = lane; e < cnt; e += 32) {
    float4 v = ent[e];
    const float c = (v.y - mean) * v.z;
    v.y = c;
    v.w = c * c;
    ent[e] = v;
  }
}

// Compacts both sides in one launch; returns cudaGetLastError().
inline int cf_compact(const float* ra, const float* ma, int na, float4* enta,
                      int* offsa, const float* rb, const float* mb, int nb,
                      float4* entb, int* offsb, int ni, cudaStream_t st) {
  const int rows = na + nb;
  if (rows > 0 && ni > 0) {
    const int blocks = (rows + kCompactWarps - 1) / kCompactWarps;
    cf_compact_kernel<<<blocks, kCompactWarps * 32, 0, st>>>(
        ra, ma, na, enta, offsa, rb, mb, nb, entb, offsb, ni);
  }
  return static_cast<int>(cudaGetLastError());
}
