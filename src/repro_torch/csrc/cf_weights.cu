// cf_weights: masked Pearson weights between active users and neighbour
// users over their co-rated items,
//
//   num  = ac . uc     a_sq = ac^2 . um     u_sq = am . uc^2
//   w    = num / sqrt(max(a_sq * u_sq, 1e-12))
//
// where ac / uc are the centred, masked ratings and am / um the masks.
//
// Replaces the TPU kernel src/repro/kernels/cf_weights.py:cf_weights_pallas
// (pallas_call at line 70), which holds whole [TQ, I] and [TU, I] rows in
// VMEM and runs the three products densely on the MXU.
//
// What bounds it here: bytes.  Every term carries a mask of each side, so
// only the co-rated (q, u, item) triples add anything: at the CF exact-shard
// shape ([1024, 17,700] x [6,002, 17,700], density 1.2 %) about 1.1e8 of
// them against 1.1e11 dense ones.  Counted that way the work is 7e8
// operations against 1.0 GB of dense input read once (0.30 ms at 3.35
// TB/s).  This design reads the dense input once (the compaction) and then
// each co-rated triple's 16-byte rater entry from L2 (1.75 GB at that
// shape, two thirds of it on the 32 most rated items).
//
// Design: the product of two sparse matrices into a dense one, a row of the
// output at a time (Gustavson's order), so that only co-rated triples are
// touched.
//   (a) cf_compact (cf_sparse.cuh) reads both sides' dense rows once and
//       writes each row's rated entries {item, centred, mask, centred^2},
//       centred on the card.  No plain-torch centring.
//   (b) cf_columns turns the neighbours' lists into columns: for each item,
//       its raters {user, centred, mask, centred^2}, in ranges of kRange
//       users (counts in shared memory, integer scans; no float atomics).
//   (c) cf_weights_kernel: a block per (active user q, range of neighbour
//       users).  The range's three sums live in shared memory, a slot a
//       user.  The block walks q's rated items in item order; for each, its
//       threads add the item's raters' terms, one rater a thread, and meet
//       at a barrier: a user rates an item once, so no two threads touch
//       one sum in a step, and each sum is added in q's item order, the
//       same bits every run.  An item's first kThreads raters come through
//       a ring of kDepth steps in shared memory, copied with cp.async
//       kDepth - 1 steps ahead (an item with more raters reads the rest
//       itself).  The weights are written once, coalesced.
#include <cuda_runtime.h>

#include "cf_sparse.cuh"
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kRange = 6144;      // neighbour users a block (72 KB of sums)
constexpr int kStage = 256;       // active entries staged at a time
constexpr int kDepth = 4;         // steps in the ring (16 KB)

__host__ __device__ constexpr int sums_floats(int users) {
  return 3 * ((users + 3) & ~3);
}

// ---------------------------------------------------------------------------
// The neighbours' columns: for every item, its raters.
//
// The rows are cut into groups of kGroupRows.  cf_col_count counts each
// group's entries by item ([groups, I] ints; a block a group and window of
// kWindowItems items, counted in shared memory, so no global atomics);
// cf_col_scan turns each item's counts into each group's start within the
// item's column and sums them per range of kRange rows; cf_col_start lays
// the ranges' columns end to end (colstart [ranges I + 1]: range r's raters
// of item i are [colstart[r I + i], colstart[r I + i + 1])).  All integer
// sums: the same numbers every run.  cf_col_place writes each entry {row -
// range start (int bits), centred, mask, centred^2} into its column; the
// order within a group's part of a column follows shared-memory atomics
// and may differ between runs, which cf_weights_kernel does not see: it
// adds a column's entries into different sums.
// ---------------------------------------------------------------------------

constexpr int kGroupRows = 64;      // rows counted together
constexpr int kWindowItems = 512;   // items a counting block covers
constexpr int kColThreads = 256;
static_assert(kRange % kGroupRows == 0, "a range is whole groups");

__host__ __device__ constexpr int cf_groups(int rows) {
  return (rows + kGroupRows - 1) / kGroupRows;
}

// Calls fn(row, entry) for every entry of the group's rows in items
// [w0, w0 + kWindowItems), warps over rows, lanes over entries.
template <typename Fn>
__device__ __forceinline__ void window_entries(
    const float4* __restrict__ ent, const int* __restrict__ offs, int rows,
    int ni, int g, int w0, Fn fn) {
  const int nfine = cf_fine(ni);
  const int f0 = w0 / kFine;
  const int f1 = min(nfine, (w0 + kWindowItems) / kFine);
  const int lane = threadIdx.x & 31;
  for (int r = g * kGroupRows + (threadIdx.x >> 5);
       r < min(rows, (g + 1) * kGroupRows); r += kColThreads / 32) {
    const int* o = offs + static_cast<size_t>(r) * (nfine + 1);
    const int end = o[f1];
    const float4* e = ent + static_cast<size_t>(r) * ni;
    for (int j = o[f0] + lane; j < end; j += 32) fn(r, e[j]);
  }
}

__global__ void __launch_bounds__(kColThreads)
cf_col_count(const float4* __restrict__ ent, const int* __restrict__ offs,
             int rows, int ni, int* __restrict__ count) {
  __shared__ int cnt[kWindowItems];
  const int g = blockIdx.x;
  const int w0 = blockIdx.y * kWindowItems;
  const int wn = min(kWindowItems, ni - w0);
  for (int i = threadIdx.x; i < wn; i += kColThreads) cnt[i] = 0;
  __syncthreads();
  window_entries(ent, offs, rows, ni, g, w0, [&](int, float4 v) {
    atomicAdd(cnt + cf_item(v) - w0, 1);
  });
  __syncthreads();
  int* out = count + static_cast<size_t>(g) * ni + w0;
  for (int i = threadIdx.x; i < wn; i += kColThreads) out[i] = cnt[i];
}

__global__ void cf_col_scan(int* __restrict__ count, int groups, int ni,
                            int range_groups, int* __restrict__ total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  for (int g0 = 0, r = 0; g0 < groups; g0 += range_groups, ++r) {
    int run = 0;
    for (int g = g0; g < min(groups, g0 + range_groups); ++g) {
      int* c = count + static_cast<size_t>(g) * ni + i;
      const int t = *c;
      *c = run;
      run += t;
    }
    total[static_cast<size_t>(r) * ni + i] = run;
  }
}

// One block: colstart[k] = sum of total[0 .. k), k in [0, n].
__global__ void __launch_bounds__(1024)
cf_col_start(const int* __restrict__ total, int n, int* __restrict__ colstart) {
  __shared__ int warp_sum[32];
  const int per = (n + 1023) / 1024;
  const int k0 = threadIdx.x * per;
  int sum = 0;
  for (int k = k0; k < min(n, k0 + per); ++k) sum += total[k];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  int run = base + incl - sum;
  for (int k = k0; k < min(n, k0 + per); ++k) {
    colstart[k] = run;
    run += total[k];
  }
  if (threadIdx.x == 1023) colstart[n] = run;
}

__global__ void __launch_bounds__(kColThreads)
cf_col_place(const float4* __restrict__ ent, const int* __restrict__ offs,
             int rows, int ni, const int* __restrict__ count,
             const int* __restrict__ colstart, float4* __restrict__ col) {
  __shared__ int cur[kWindowItems];
  const int g = blockIdx.x;
  const int r0 = (g * kGroupRows) / kRange * kRange;
  const int* start = colstart + static_cast<size_t>(r0 / kRange) * ni;
  const int* gstart = count + static_cast<size_t>(g) * ni;
  const int w0 = blockIdx.y * kWindowItems;
  const int wn = min(kWindowItems, ni - w0);
  for (int i = threadIdx.x; i < wn; i += kColThreads) cur[i] = 0;
  __syncthreads();
  window_entries(ent, offs, rows, ni, g, w0, [&](int r, float4 v) {
    const int item = cf_item(v);
    const int k = atomicAdd(cur + item - w0, 1);
    v.x = __int_as_float(r - r0);
    col[start[item] + gstart[item] + k] = v;
  });
}

// The columns of rows [0, rows) in ranges of kRange; count:
// [cf_groups(rows), ni] ints, total: [ranges, ni] ints, colstart:
// [ranges ni + 1] ints, col: room for every entry.  Returns
// cudaGetLastError().
static int cf_columns(const float4* ent, const int* offs, int rows, int ni,
                      int* count, int* total, int* colstart, float4* col,
                      cudaStream_t st) {
  const int groups = cf_groups(rows);
  const int ranges = (rows + kRange - 1) / kRange;
  const dim3 grid(groups, (ni + kWindowItems - 1) / kWindowItems);
  cf_col_count<<<grid, kColThreads, 0, st>>>(ent, offs, rows, ni, count);
  cf_col_scan<<<(ni + 255) / 256, 256, 0, st>>>(count, groups, ni,
                                                 kRange / kGroupRows, total);
  cf_col_start<<<1, 1024, 0, st>>>(total, ranges * ni, colstart);
  cf_col_place<<<grid, kColThreads, 0, st>>>(ent, offs, rows, ni, count,
                                             colstart, col);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads, 2)
cf_weights_kernel(const float4* __restrict__ aent,
                  const int* __restrict__ aoffs,
                  const float4* __restrict__ col,
                  const int* __restrict__ colstart, int nu, int ni,
                  float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int q = blockIdx.x;
  const int u0 = blockIdx.y * kRange;
  const int un = min(kRange, nu - u0);
  const int pitch = (un + 3) & ~3;
  float4* ring = smem;                        // [kDepth][kThreads]
  float4* s_ent = ring + kDepth * kThreads;   // [kStage]
  int* s_beg = reinterpret_cast<int*>(s_ent + kStage);
  int* s_end = s_beg + kStage;
  float* num = reinterpret_cast<float*>(s_end + kStage);
  float* asq = num + pitch;
  float* usq = asq + pitch;
  for (int i = tid; i < 3 * pitch; i += kThreads) num[i] = 0.f;

  const int nfine = cf_fine(ni);
  const int qcnt = aoffs[static_cast<size_t>(q) * (nfine + 1) + nfine];
  const float4* qe = aent + static_cast<size_t>(q) * ni;
  const int* cs = colstart + static_cast<size_t>(blockIdx.y) * ni;
  for (int e0 = 0; e0 < qcnt; e0 += kStage) {
    const int n = min(kStage, qcnt - e0);
    __syncthreads();
    if (tid < n) {
      const float4 v = qe[e0 + tid];
      const int item = cf_item(v);
      s_ent[tid] = v;
      s_beg[tid] = cs[item];
      s_end[tid] = cs[item + 1];
    }
    __syncthreads();
    // Step t's first kThreads raters go to ring slot t % kDepth, copied
    // kDepth - 1 steps ahead; a step's active entry, its column and first
    // rater are read before the step before it is added, so that a step is
    // one read-add-write of three sums and a barrier.
    auto issue = [&](int t) {
      if (t < n && s_beg[t] + tid < s_end[t])
        copy16(ring + (t % kDepth) * kThreads + tid, col + s_beg[t] + tid);
      copy_commit();
    };
#pragma unroll
    for (int t = 0; t < kDepth - 1; ++t) issue(t);
    copy_wait<kDepth - 2>();
    __syncthreads();
    float4 a = s_ent[0];  // {item, ac, am, ac^2}
    int beg = s_beg[0];
    int end = s_end[0];
    float4 c = ring[tid];  // {user, uc, um, uc^2}
    for (int t = 0; t < n; ++t) {
      issue(t + kDepth - 1);
      auto add = [&](const float4& v) {
        const int u = __float_as_int(v.x);
        num[u] = fmaf(a.y, v.y, num[u]);
        asq[u] = fmaf(a.w, v.z, asq[u]);
        usq[u] = fmaf(a.z, v.w, usq[u]);
      };
      if (beg + tid < end) add(c);
      for (int j = beg + tid + kThreads; j < end; j += kThreads) add(col[j]);
      copy_wait<kDepth - 2>();
      __syncthreads();  // step t is added; step t + 1's raters landed
      if (t + 1 < n) {
        a = s_ent[t + 1];
        beg = s_beg[t + 1];
        end = s_end[t + 1];
        c = ring[((t + 1) % kDepth) * kThreads + tid];
      }
    }
    copy_wait<0>();
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(q) * nu + u0;
  for (int u = tid; u < un; u += kThreads)
    __stcs(o + u, num[u] / sqrtf(fmaxf(asq[u] * usq[u], 1e-12f)));
}

// a, am: [nq, ni]; u, um: [nu, ni] fp32 -> out: [nq, nu] fp32.  Scratch:
// aent / aoffs and uent / uoffs, each side's lists ([rows, ni] float4,
// [rows, cf_fine(ni) + 1] int); count [cf_groups(nu), ni], total
// [ranges, ni] and colstart [ranges ni + 1] int and col [nu ni] float4,
// the neighbours' columns, ranges = ceil(nu / kRange).  nq, nu, ni >= 1.
// Returns cudaGetLastError() after the launches.
extern "C" int cf_weights_f32(const void* a, const void* am, const void* u,
                              const void* um, int nq, int nu, int ni,
                              void* aent, void* aoffs, void* uent,
                              void* uoffs, void* count, void* total,
                              void* colstart, void* col, void* out,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* ae = static_cast<float4*>(aent);
  float4* ue = static_cast<float4*>(uent);
  int* ao = static_cast<int*>(aoffs);
  int* uo = static_cast<int*>(uoffs);
  int err = cf_compact(static_cast<const float*>(a),
                       static_cast<const float*>(am), nq, ae, ao,
                       static_cast<const float*>(u),
                       static_cast<const float*>(um), nu, ue, uo, ni, st);
  if (err != 0) return err;
  int* cs = static_cast<int*>(colstart);
  float4* c = static_cast<float4*>(col);
  err = cf_columns(ue, uo, nu, ni, static_cast<int*>(count),
                   static_cast<int*>(total), cs, c, st);
  if (err != 0) return err;
  const int users = nu < kRange ? nu : kRange;
  const int bytes =
      (kDepth * kThreads + kStage) * 16 + kStage * 8 + sums_floats(users) * 4;
  err = static_cast<int>(cudaFuncSetAttribute(
      cf_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err != 0) return err;
  const dim3 grid(nq, (nu + kRange - 1) / kRange);
  cf_weights_kernel<<<grid, kThreads, bytes, st>>>(ae, ao, c, cs, nu, ni,
                                                   static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
