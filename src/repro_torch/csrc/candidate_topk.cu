// candidate_topk: seeded streaming k-best over precomputed candidates.
//
// Replaces the TPU kernel src/repro/kernels/topk_stream.py:
// candidate_topk_pallas (pallas_call at line 118), whose grid walks the
// candidate columns in order on one core and carries a [TQ, k] running best
// in VMEM scratch, merged by k rounds of (min, first argmin).
//
// What bounds it here: bytes.  Each candidate's value is read once and
// compared with the lane's k-th best; labels are read only for the k
// winners.  The work per byte is a few compares, far below the card's
// compute rate, so the design is about keeping enough loads in flight.
//
// Design: a row is split over many lanes, and each lane issues a batch of
// loads before it inserts any of them into its sorted k-best in registers
// (kbest.cuh:kb_scan_parts).  By the row's length:
//   * long rows (more than kWarpMax candidates, as a shard's): a block of
//     kBlockThreads a row; each warp merges its 32 lists in k rounds of a
//     shuffle butterfly, and one warp merges the warps' k-bests from shared
//     memory;
//   * rows of at most kWarpMax (as the shard reduce's 35 to 42): a warp a
//     row, four rows a block.
// Merges take the least (value, column), merge_kbest's tie rule: the seed,
// then the lowest column.  The candidates may be a [parts, q, m] stack read
// in place, part p after part p - 1, so that the S - 1 folds of the shard
// reduce are one selection over [seed | part 0 | part 1 | ...].  A list is
// as long as k up to 8 (each insert moves fewer entries than a list of 8).
#include <cuda_runtime.h>

#include "kbest.cuh"

namespace {

constexpr int kThreads = 128;        // a block of the warp regime
constexpr int kBlockThreads = 128;   // a row of the block regime
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kWarpMax = 1024;       // a warp a row up to here

struct Args {
  const float* d;
  const int* l;
  const float* init_d;
  const int* init_l;
  int parts, q, m, k;
  float* out_d;
  int* out_l;
};

template <int CAP>
__global__ void __launch_bounds__(kThreads)
candidate_topk_warp_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  if (row >= a.q) return;   // whole warps: the shuffles stay full
  const size_t stride = static_cast<size_t>(a.q) * a.m;
  const size_t off = static_cast<size_t>(row) * a.m;
  const size_t koff = static_cast<size_t>(row) * a.k;
  float bd[CAP];
  int bc[CAP];
  kb_clear(bd, bc);
  kb_scan_parts(bd, bc, a.d + off, a.parts, stride, a.m,
                a.init_d ? a.init_d + koff : nullptr, a.k, lane, 32);
  for (int i = 0; i < a.k; ++i) {
    float wd;
    int wc;
    kb_take<CAP, 32>(bd, bc, wd, wc);
    if (lane == i) {
      a.out_d[koff + i] = wd;
      a.out_l[koff + i] = kb_label(wc, a.l + off, stride, a.m,
                                   a.init_l ? a.init_l + koff : nullptr, a.k);
    }
  }
}

template <int CAP>
__global__ void __launch_bounds__(kBlockThreads)
candidate_topk_block_kernel(Args a) {
  __shared__ float sd[kBlockWarps * 32];
  __shared__ int sc[kBlockWarps * 32];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t stride = static_cast<size_t>(a.q) * a.m;
  const size_t off = static_cast<size_t>(row) * a.m;
  const size_t koff = static_cast<size_t>(row) * a.k;
  float bd[CAP];
  int bc[CAP];
  kb_clear(bd, bc);
  kb_scan_parts(bd, bc, a.d + off, a.parts, stride, a.m,
                a.init_d ? a.init_d + koff : nullptr, a.k, threadIdx.x,
                kBlockThreads);
  for (int i = 0; i < a.k; ++i) {
    float wd;
    int wc;
    kb_take<CAP, 32>(bd, bc, wd, wc);
    if (lane == i) {
      sd[warp * 32 + i] = wd;
      sc[warp * 32 + i] = wc;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  kb_clear(bd, bc);
  if (lane < a.k) {
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w)
      kb_insert(bd, bc, sd[w * 32 + lane], sc[w * 32 + lane]);
  }
  for (int i = 0; i < a.k; ++i) {
    float wd;
    int wc;
    kb_take<CAP, 32>(bd, bc, wd, wc);
    if (lane == i) {
      a.out_d[koff + i] = wd;
      a.out_l[koff + i] = kb_label(wc, a.l + off, stride, a.m,
                                   a.init_l ? a.init_l + koff : nullptr, a.k);
    }
  }
}

template <int CAP>
void launch(const Args& a, cudaStream_t stream) {
  if (static_cast<long long>(a.parts) * a.m <= kWarpMax) {
    const long long lanes = static_cast<long long>(a.q) * 32;
    candidate_topk_warp_kernel<CAP>
        <<<static_cast<int>((lanes + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>(a);
  } else {
    candidate_topk_block_kernel<CAP><<<a.q, kBlockThreads, 0, stream>>>(a);
  }
}

}  // namespace

// d, l: [parts, q, m] (parts 1: [q, m]); init_d, init_l: [q, k] or both
// null; out: [q, k].  1 <= k <= 32, q >= 1.  Returns cudaGetLastError()
// after the launch.
extern "C" int candidate_topk_f32(const void* d, const void* l,
                                  const void* init_d, const void* init_l,
                                  int parts, int q, int m, int k, void* out_d,
                                  void* out_l, void* stream) {
  const Args a{static_cast<const float*>(d), static_cast<const int*>(l),
               static_cast<const float*>(init_d),
               static_cast<const int*>(init_l), parts, q, m, k,
               static_cast<float*>(out_d), static_cast<int*>(out_l)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {   // the list as long as k, up to 8
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    case 4: launch<4>(a, s); break;
    case 5: launch<5>(a, s); break;
    case 6: launch<6>(a, s); break;
    case 7: launch<7>(a, s); break;
    case 8: launch<8>(a, s); break;
    default:
      if (k <= 16) {
        launch<16>(a, s);
      } else {
        launch<32>(a, s);
      }
  }
  return static_cast<int>(cudaGetLastError());
}
