// cf_aggregate: a CF map task's four additive bucket statistics in one pass
// over its rating matrix.  For each LSH bucket g of users and each item i,
// summed over the bucket's users u in the order of the stable sort:
//
//   sr[g, i]  = sum r·m             sr2[g, i] = sum (r·m)·r
//   s[g, i]   = sum (r − mean_u)·m  c[g, i]   = sum m
//
// Replaces no TPU kernel: the JAX package leaves these segment sums to XLA
// (src/repro/apps/cf.py, the sums behind build_cf_aggregates and
// cf_mergeable_stats).  It was added because the port's torch chain for
// them (two [U, I] products, four gathers into bucket order, four
// segment_reduce calls) moves about 7.9 GB a map task at the CF shard shape
// (6,002 users x 17,700 items, K = 300), about 8 times what the result
// needs, and was the largest stage of a CF job.
//
// What bounds it here: bytes.  The ratings and the mask are read once (850
// MB at that shape), the means and the sort order (48 KB) once, and the four
// [K, I] sums written once (85 MB): 0.28 ms at 3.35 TB/s.  No product and
// no gathered row ever reaches device memory.
//
// Numbers: each product is rounded on its own (__fmul_rn, __fsub_rn; no FMA
// contraction), and each (bucket, item) sum starts from 0.0f and adds its
// users one after another in sort order (__fadd_rn), which is how
// torch.segment_reduce sums a run of rows: the same bits as the plain
// version (kernels/ref.py:cf_aggregate).
//
// Design:
//   (a) cf_aggregate_order: one block lists the buckets by size class
//       (floor(log2(count)) + 1, the empty ones last), largest first, so
//       that the blocks of a large bucket are handed out before the small
//       ones and do not set the kernel's length.  Only the hand-out order
//       changes; no sum depends on it.
//   (b) cf_aggregate_kernel: a block (one warp) per (bucket, tile of 128
//       items), so that a bucket spreads over ceil(I / 128) blocks.  Each
//       thread holds 4 neighbouring items (16-byte loads and stores where
//       the rows allow) and the four sums of each in registers: no atomics,
//       no shared memory.  The warp reads 32 of the bucket's user indices
//       and means at a time, one a lane, and hands them round by shuffles;
//       then kUsers users' rows are loaded before any is added, so that
//       kUsers x 32 bytes a thread are in flight.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

constexpr int kThreads = 32;                // one warp a block
constexpr int kVec = 4;                     // items a thread
constexpr int kTile = kThreads * kVec;      // items a block
constexpr int kUsers = 8;                   // rows in flight a thread
constexpr int kClasses = 32;                // size classes of a bucket
constexpr int kOrderThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads % kUsers == 0, "a batch of users lies in one round");

__device__ __forceinline__ int size_class(int count) {
  return count <= 0 ? 0 : 32 - __clz(count);
}

__device__ __forceinline__ int bucket_count(const int* offsets, int b,
                                            int n_users) {
  const int lo = min(max(offsets[b], 0), n_users);
  const int hi = min(max(offsets[b + 1], lo), n_users);
  return hi - lo;
}

// rank_to_bucket[r]: the bucket whose blocks are handed out r-th, larger
// size classes first.  A permutation of [0, k); within a class the order
// is whatever the shared-memory atomics give, which no result depends on.
__global__ void __launch_bounds__(kOrderThreads)
cf_aggregate_order(const int* __restrict__ offsets, int k, int n_users,
                   int* __restrict__ rank_to_bucket) {
  __shared__ int count[kClasses];
  __shared__ int cursor[kClasses];
  if (threadIdx.x < kClasses) count[threadIdx.x] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < k; b += blockDim.x)
    atomicAdd(&count[size_class(bucket_count(offsets, b, n_users))], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int start = 0;
    for (int c = kClasses - 1; c >= 0; --c) {
      cursor[c] = start;
      start += count[c];
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < k; b += blockDim.x) {
    const int c = size_class(bucket_count(offsets, b, n_users));
    rank_to_bucket[atomicAdd(&cursor[c], 1)] = b;
  }
}

struct Sums {
  float sr[kVec], sr2[kVec], s[kVec], c[kVec];
};

__device__ __forceinline__ void add_user(Sums& acc, const float (&r)[kVec],
                                         const float (&m)[kVec], float mean) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float rm = __fmul_rn(r[e], m[e]);
    acc.sr[e] = __fadd_rn(acc.sr[e], rm);
    acc.sr2[e] = __fadd_rn(acc.sr2[e], __fmul_rn(rm, r[e]));
    acc.s[e] = __fadd_rn(acc.s[e], __fmul_rn(__fsub_rn(r[e], mean), m[e]));
    acc.c[e] = __fadd_rn(acc.c[e], m[e]);
  }
}

// Row u's kVec items from col (col < n_items): one 16-byte load where the
// rows are 16-byte aligned (kAligned), else one load an item, the ragged
// tail read as 0 (its sums are never stored).
template <bool kAligned>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         size_t row, int col, int n_items,
                                         float (&out)[kVec]) {
  const float* p = x + row * n_items + col;
  if (kAligned) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      out[e] = col + e < n_items ? __ldcs(p + e) : 0.f;
  }
}

template <bool kAligned>
__device__ __forceinline__ void store_row(float* __restrict__ x, size_t row,
                                          int col, int n_items,
                                          const float (&v)[kVec]) {
  float* p = x + row * n_items + col;
  if (kAligned) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (col + e < n_items) p[e] = v[e];
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 16)
cf_aggregate_kernel(const float* __restrict__ ratings,
                    const float* __restrict__ mask,
                    const float* __restrict__ means,
                    const int* __restrict__ order,
                    const int* __restrict__ offsets,
                    const int* __restrict__ rank_to_bucket, int n_users,
                    int n_items, int n_tiles, float* __restrict__ sr,
                    float* __restrict__ sr2, float* __restrict__ s,
                    float* __restrict__ c) {
  const int rank = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - rank * n_tiles;
  const int bucket = rank_to_bucket[rank];
  const int lo = min(max(offsets[bucket], 0), n_users);
  const int hi = min(max(offsets[bucket + 1], lo), n_users);
  const int lane = threadIdx.x;
  const int col = tile * kTile + lane * kVec;
  const bool live = col < n_items;

  Sums acc;
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    acc.sr[e] = acc.sr2[e] = acc.s[e] = acc.c[e] = 0.f;

  for (int j0 = lo; j0 < hi; j0 += kThreads) {
    const int n = min(kThreads, hi - j0);
    int my_user = 0;
    float my_mean = 0.f;
    if (lane < n) {
      my_user = min(max(order[j0 + lane], 0), n_users - 1);
      my_mean = means[my_user];
    }
    for (int b0 = 0; b0 < n; b0 += kUsers) {
      float r[kUsers][kVec], m[kUsers][kVec], mean[kUsers];
#pragma unroll
      for (int t = 0; t < kUsers; ++t) {
        const int u = __shfl_sync(kFull, my_user, b0 + t);
        mean[t] = __shfl_sync(kFull, my_mean, b0 + t);
        if (live && b0 + t < n) {
          load_row<kAligned>(ratings, u, col, n_items, r[t]);
          load_row<kAligned>(mask, u, col, n_items, m[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kUsers; ++t)
        if (live && b0 + t < n) add_user(acc, r[t], m[t], mean[t]);
    }
  }
  if (!live) return;
  store_row<kAligned>(sr, bucket, col, n_items, acc.sr);
  store_row<kAligned>(sr2, bucket, col, n_items, acc.sr2);
  store_row<kAligned>(s, bucket, col, n_items, acc.s);
  store_row<kAligned>(c, bucket, col, n_items, acc.c);
}

constexpr int kTooMany = -1;   // more (bucket, tile) blocks than a grid holds

// ratings, mask: [n_users, n_items] fp32; means: [n_users] fp32; order:
// [n_users] int32 (users in stable bucket order); offsets: [k + 1] int32
// (bucket starts in that order); rank_to_bucket: [k] int32 scratch; sr,
// sr2, s, c: [k, n_items] fp32 outputs.  n_users >= 1, n_items >= 1, k >= 1.
// Two launches on ``stream``; returns cudaGetLastError() after them, or
// kTooMany.
extern "C" int cf_aggregate_f32(const void* ratings, const void* mask,
                                const void* means, const void* order,
                                const void* offsets, int n_users, int n_items,
                                int k, void* rank_to_bucket, void* sr,
                                void* sr2, void* s, void* c, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_tiles =
      (static_cast<long long>(n_items) + kTile - 1) / kTile;
  if (n_tiles * k > 0x7fffffffLL) return kTooMany;
  const int* off = static_cast<const int*>(offsets);
  int* rtb = static_cast<int*>(rank_to_bucket);
  cf_aggregate_order<<<1, kOrderThreads, 0, st>>>(off, k, n_users, rtb);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool vec = n_items % kVec == 0 && aligned(ratings) && aligned(mask) &&
                   aligned(sr) && aligned(sr2) && aligned(s) && aligned(c);
  const auto* r = static_cast<const float*>(ratings);
  const auto* m = static_cast<const float*>(mask);
  const auto* mu = static_cast<const float*>(means);
  const auto* ord = static_cast<const int*>(order);
  auto* o0 = static_cast<float*>(sr);
  auto* o1 = static_cast<float*>(sr2);
  auto* o2 = static_cast<float*>(s);
  auto* o3 = static_cast<float*>(c);
  const unsigned blocks = static_cast<unsigned>(n_tiles * k);
  if (vec) {
    cf_aggregate_kernel<true><<<blocks, kThreads, 0, st>>>(
        r, m, mu, ord, off, rtb, n_users, n_items, static_cast<int>(n_tiles),
        o0, o1, o2, o3);
  } else {
    cf_aggregate_kernel<false><<<blocks, kThreads, 0, st>>>(
        r, m, mu, ord, off, rtb, n_users, n_items, static_cast<int>(n_tiles),
        o0, o1, o2, o3);
  }
  return static_cast<int>(cudaGetLastError());
}
