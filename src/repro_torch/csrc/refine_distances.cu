// refine_distances: exact distances from each query to its own selected
// originals, with each refined row read once per bucket, not once per query.
//
// Replaces the TPU kernel src/repro/kernels/refine_distances.py:
// refine_distances_pallas (pallas_call at line 66), where the selection
// idx[q, b] is a scalar-prefetch operand and the BlockSpec index map DMAs
// exactly the selected row of train_x into VMEM, one (query, slot) per grid
// step.
//
// What bounds it here: bytes.  The distinct selected rows are read once
// (868 B each at D = 217) and every valid slot costs 2 D FMAs.  A refinement
// selection is made of whole bucket runs (idx[q, base + j] =
// perm[offsets[bucket] + j], core/aggregate.py:refinement_indices), and on
// the kNN path each bucket is refined by about ten queries, so a design that
// gives each query its own copy of the rows reads them ten times over.
//
// Design: a schedule built on the card, then one pass a bucket.
//   1. mark (a block a query row): the key of slot b is the bucket of its
//      row, -1 where valid is False (and BIG is written there).  A run is a
//      maximal stretch of valid slots of one key; its start and end slots
//      are listed in order, so that the r-th start of a row pairs with its
//      r-th end, and each start adds one to its key's count.  |q|^2 of the
//      row is summed here once.
//   2. plan (one block): an exclusive scan of the counts gives each key its
//      place in the run list, and each key's runs are cut into work items
//      of at most kChunk runs.
//   3. place (a block a query row): each run takes a place in its key's
//      list by an atomic cursor.  The order within a list may vary from run
//      to run; no sum depends on it.
//   4. compute (persistent blocks of four warps, items taken from an
//      atomic counter, the next one fetched while this one runs): a block
//      stages the item's queries (transposed, so that four runs' values
//      are one broadcast float4) and, a tile of kTileRows rows at a time,
//      the rows of its longest run in shared memory (4-byte cp.async:
//      868-byte rows cannot take 16-byte copies), with the row each output
//      slot holds.  Warp g sums runs 4g..4g+3 against the tile, a lane a
//      row: q.x and |x|^2 from shared memory.  Slot j of another run must
//      hold the same row as the staged slot j; where it does not (an
//      arbitrary idx, never a refinement selection) the pair is summed
//      from device memory instead, in the same order.
// Each output is written once.  Every sum is an fp32 FMA chain over the
// features in ascending order, whichever path computes it, and no float is
// summed by atomics: the same inputs give the same bits on every run.
#include <cuda_runtime.h>

#include "common.cuh"
#include "fp32_tile.cuh"   // cp_async4, cp_async_commit, cp_async_wait

namespace {

constexpr int kMarkThreads = 256;
constexpr int kMarkPer = 12;                         // slots a thread
constexpr int kWindow = kMarkThreads * kMarkPer;     // slots a pass
constexpr int kLoads = (kWindow + 2 + kMarkThreads - 1) / kMarkThreads;
constexpr int kHalf = (kLoads + 1) / 2;   // loads in flight a thread
constexpr int kPlanThreads = 1024;
constexpr int kPlaceThreads = 128;
constexpr int kChunk = 16;        // runs a work item
constexpr int kTileRows = 32;     // staged rows a tile (a lane each)
constexpr int kSpanRows = 256;    // staged run's row ids read at a time
constexpr int kSlice = 256;       // features staged at a time
constexpr int kQPitch = kChunk + 4;   // s_q[feature][run]: aligned float4s
constexpr int kWarps = kChunk / 4;    // a warp for four runs (a float4)
constexpr int kComputeThreads = kWarps * 32;

__device__ __forceinline__ int clip_row(int r, int n) {
  return min(max(r, 0), n - 1);
}

// The one formula of every output, so that both paths round alike.
__device__ __forceinline__ float finish(float q2, float cross, float x2) {
  return fmaxf(__fadd_rn(__fmaf_rn(-2.f, cross, q2), x2), 0.f);
}

// Exclusive sum over the block of one value a thread (a multiple of 32
// threads); *total gets the block's sum.  Ends with a barrier.
template <typename T, int THREADS>
__device__ __forceinline__ T block_exclusive_sum(T v, T* total) {
  __shared__ T warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < THREADS / 32 ? warp_sums[lane] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    if (lane < THREADS / 32) warp_sums[lane] = w;   // inclusive
  }
  __syncthreads();
  const T before = warp == 0 ? T(0) : warp_sums[warp - 1];
  *total = warp_sums[THREADS / 32 - 1];
  __syncthreads();
  return before + incl - v;
}

// ---------------------------------------------------------------------------
// 1. mark
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMarkThreads, 8)   // one wave at Q 1024
refine_mark_kernel(const float* __restrict__ q,
                   const int* __restrict__ idx,
                   const unsigned char* __restrict__ valid,
                   const int* __restrict__ bucket_of, int n, int b, int dim,
                   int n_keys, float* __restrict__ q2,
                   int* __restrict__ starts, int* __restrict__ ends,
                   int* __restrict__ n_runs, int* __restrict__ counts,
                   float* __restrict__ out) {
  __shared__ int keys[kWindow + 2];   // keys[1 + j]: slot w0 + j
  __shared__ float red[kMarkThreads];
  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(qi) * b;

  // |q|^2: strided partial sums, then a fixed tree
  const float* qr = q + static_cast<size_t>(qi) * dim;
  float s = 0.f;
  for (int c = t; c < dim; c += kMarkThreads) s = fmaf(qr[c], qr[c], s);
  red[t] = s;
  __syncthreads();
  for (int w = kMarkThreads / 2; w > 0; w >>= 1) {
    if (t < w) red[t] += red[t + w];
    __syncthreads();
  }
  if (t == 0) q2[qi] = red[0];

  int n_start = 0, n_end = 0;
  for (int w0 = 0; w0 < b; w0 += kWindow) {
    const int wn = min(kWindow, b - w0);
    // the window's keys, half of a thread's slots at a time: every load of
    // the half first, then the bucket lookups
#pragma unroll
    for (int h = 0; h < kLoads; h += kHalf) {
      int rows[kHalf];
      bool live[kHalf];
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {   // in range or not: no load waits
        const int slot = w0 + t + (h + u) * kMarkThreads - 1;
        const size_t o = row0 + min(max(slot, 0), b - 1);
        const bool v = valid[o] != 0;
        rows[u] = clip_row(idx[o], n);
        live[u] = v && h + u < kLoads && t + (h + u) * kMarkThreads < wn + 2 &&
                  slot >= 0 && slot < b;
      }
#pragma unroll
      for (int u = 0; u < kHalf; ++u) rows[u] = bucket_of[rows[u]];
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {
        const int j = t + (h + u) * kMarkThreads;
        if (h + u >= kLoads || j >= wn + 2) continue;
        const int slot = w0 + j - 1;
        keys[j] = live[u] ? min(max(rows[u], 0), n_keys - 1) : -1;
        if (!live[u] && j >= 1 && j <= wn) out[row0 + slot] = REPRO_BIG;
      }
    }
    __syncthreads();

    // slots [t kMarkPer, (t + 1) kMarkPer) of the window, in order
    const int j0 = t * kMarkPer;
    unsigned smask = 0, emask = 0;
#pragma unroll
    for (int u = 0; u < kMarkPer; ++u) {
      const int j = j0 + u;
      if (j < wn) {
        const int k = keys[j + 1];
        if (k >= 0 && k != keys[j]) smask |= 1u << u;
        if (k >= 0 && k != keys[j + 2]) emask |= 1u << u;
      }
    }
    int total;
    const int before = block_exclusive_sum<int, kMarkThreads>(
        __popc(smask) | (__popc(emask) << 16), &total);
    int rs = n_start + (before & 0xffff);
    int re = n_end + (before >> 16);
#pragma unroll
    for (int u = 0; u < kMarkPer; ++u) {
      if (smask >> u & 1u) {
        starts[row0 + rs++] = w0 + j0 + u;
        atomicAdd(&counts[keys[j0 + u + 1]], 1);
      }
      if (emask >> u & 1u) ends[row0 + re++] = w0 + j0 + u;
    }
    n_start += total & 0xffff;
    n_end += total >> 16;
    __syncthreads();   // keys[] is the next window's
  }
  if (t == 0) n_runs[qi] = n_start;
}

// ---------------------------------------------------------------------------
// 2. plan
// ---------------------------------------------------------------------------

// offsets[key]: the key's first place in the run list; items: (first run,
// runs) of each chunk of at most kChunk runs, keys in order; counters[0]:
// the number of items.
__global__ void __launch_bounds__(kPlanThreads)
refine_plan_kernel(const int* __restrict__ counts, int n_keys,
                   int* __restrict__ offsets, int2* __restrict__ items,
                   int* __restrict__ counters) {
  const int t = threadIdx.x;
  const int per = (n_keys + kPlanThreads - 1) / kPlanThreads;
  const int k0 = min(n_keys, t * per);
  const int k1 = min(n_keys, k0 + per);
  long long mine = 0;   // chunks << 32 | runs
  for (int k = k0; k < k1; ++k) {
    const int c = counts[k];
    mine += (static_cast<long long>((c + kChunk - 1) / kChunk) << 32) + c;
  }
  long long total;
  long long at = block_exclusive_sum<long long, kPlanThreads>(mine, &total);
  for (int k = k0; k < k1; ++k) {
    const int c = counts[k];
    int run = static_cast<int>(at & 0xffffffffLL);
    int item = static_cast<int>(at >> 32);
    offsets[k] = run;
    for (int r = 0; r < c; r += kChunk) {
      items[item++] = make_int2(run + r, min(kChunk, c - r));
    }
    at += (static_cast<long long>((c + kChunk - 1) / kChunk) << 32) + c;
  }
  if (t == 0) counters[0] = static_cast<int>(total >> 32);
}

// ---------------------------------------------------------------------------
// 3. place
// ---------------------------------------------------------------------------

// runs[place]: (q * b + base, length), grouped by key.
__global__ void __launch_bounds__(kPlaceThreads)
refine_place_kernel(const int* __restrict__ idx,
                    const int* __restrict__ bucket_of, int n, int b,
                    int n_keys, const int* __restrict__ starts,
                    const int* __restrict__ ends,
                    const int* __restrict__ n_runs,
                    const int* __restrict__ offsets,
                    int* __restrict__ cursor, int2* __restrict__ runs) {
  const int qi = blockIdx.x;
  const size_t row0 = static_cast<size_t>(qi) * b;
  const int nr = n_runs[qi];
  for (int r = threadIdx.x; r < nr; r += kPlaceThreads) {
    const int base = starts[row0 + r];
    const int len = ends[row0 + r] - base + 1;
    const int key = min(max(bucket_of[clip_row(idx[row0 + base], n)], 0),
                        n_keys - 1);
    const int at = offsets[key] + atomicAdd(&cursor[key], 1);
    runs[at] = make_int2(qi * b + base, len);
  }
}

// ---------------------------------------------------------------------------
// 4. compute
// ---------------------------------------------------------------------------

struct ComputeSmem {
  int q[kChunk], base[kChunk], len[kChunk];
  float q2[kChunk];
  int row[kSpanRows];   // the staged run's rows, kSpanRows at a time
  int next, span, src;
};

__global__ void __launch_bounds__(kComputeThreads)
refine_compute_kernel(const float* __restrict__ q,
                      const float* __restrict__ x,
                      const int* __restrict__ idx, int n, int b, int dim,
                      const float* __restrict__ q2g,
                      const int2* __restrict__ runs,
                      const int2* __restrict__ items,
                      int* __restrict__ counters, float* __restrict__ out) {
  extern __shared__ float4 dyn[];
  __shared__ ComputeSmem sm;
  const int slice = min(dim, kSlice);
  const bool q_once = dim <= kSlice;   // one slice: the queries stay put
  const int xpitch = slice | 1;   // odd: lanes on rows hit distinct banks
  float* s_q = reinterpret_cast<float*>(dyn);       // [slice][kQPitch]
  float* s_x = s_q + slice * kQPitch;               // [kTileRows][xpitch]
  int* s_idx = reinterpret_cast<int*>(s_x + kTileRows * xpitch);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int g = t >> 5;   // this warp's runs: 4g .. 4g + 3
  const int n_items = counters[0];

  if (t == 0) sm.next = atomicAdd(&counters[1], 1);
  for (;;) {
    __syncthreads();   // sm.next is set; the last item's reads are done
    const int item = sm.next;
    if (item >= n_items) return;
    const int2 it = items[item];
    const int nr = it.y;
    if (t < 32) {
      const int2 run = t < nr ? runs[it.x + t] : make_int2(0, -1);
      if (t < nr) {
        sm.q[t] = run.x / b;
        sm.base[t] = run.x - (run.x / b) * b;
        sm.len[t] = run.y;
        sm.q2[t] = q2g[run.x / b];
      }
      int len = run.y;   // the longest run, the first of equals
      int who = t;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ol = __shfl_xor_sync(0xffffffffu, len, off);
        const int ow = __shfl_xor_sync(0xffffffffu, who, off);
        if (ol > len || (ol == len && ow < who)) {
          len = ol;
          who = ow;
        }
      }
      if (t == 0) {
        sm.span = len;
        sm.src = who;
      }
    }
    __syncthreads();
    const int span = sm.span;
    const size_t src0 =
        static_cast<size_t>(sm.q[sm.src]) * b + sm.base[sm.src];
    if (t == 0) sm.next = atomicAdd(&counters[1], 1);   // in flight meanwhile

    for (int j0 = 0; j0 < span; j0 += kTileRows) {
      const int rows = min(kTileRows, span - j0);
      const int at = j0 % kSpanRows;   // this tile's rows in sm.row
      if (at == 0) {
        for (int i = t; i < min(kSpanRows, span - j0); i += kComputeThreads)
          sm.row[i] = clip_row(idx[src0 + j0 + i], n);
      }
      // lane's row of the tile; this warp's sums of its four runs
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float x2 = 0.f;
      for (int k0 = 0; k0 < dim; k0 += slice) {
        const int kn = min(slice, dim - k0);
        __syncthreads();   // sm.row written; the last slice's reads done
        if (!q_once || j0 == 0) {   // a warp a run, lanes on features
          for (int r = g; r < nr; r += kWarps) {
            const float* qr = q + static_cast<size_t>(sm.q[r]) * dim + k0;
            for (int c = lane; c < kn; c += 32)
              cp_async4(s_q + c * kQPitch + r, qr + c, true);
          }
        }
        if (k0 == 0) {   // the row each output slot holds, for its check
          for (int r = g; r < nr; r += kWarps) {
            const bool live = lane < rows && j0 + lane < sm.len[r];
            const int* src = idx + (live ? static_cast<size_t>(sm.q[r]) * b +
                                    sm.base[r] + j0 + lane : 0);
            cp_async4(reinterpret_cast<float*>(s_idx + r * kTileRows + lane),
                      reinterpret_cast<const float*>(src), live);
          }
        }
        for (int i = g; i < rows; i += kWarps) {
          const float* xr =
              x + static_cast<size_t>(sm.row[at + i]) * dim + k0;
          for (int c = lane; c < kn; c += 32)
            cp_async4(s_x + i * xpitch + c, xr + c, true);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (4 * g < nr) {
          const float4* qg = reinterpret_cast<const float4*>(s_q) + g;
          const float* xl = s_x + lane * xpitch;
#pragma unroll 8
          for (int c = 0; c < kn; ++c) {
            const float4 qv = qg[c * (kQPitch / 4)];
            const float v = xl[c];
            acc[0] = fmaf(qv.x, v, acc[0]);
            acc[1] = fmaf(qv.y, v, acc[1]);
            acc[2] = fmaf(qv.z, v, acc[2]);
            acc[3] = fmaf(qv.w, v, acc[3]);
            x2 = fmaf(v, v, x2);
          }
        }
      }

      if (4 * g < nr && lane < rows) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * g + i;
          if (r >= nr || j0 + lane >= sm.len[r]) continue;
          const size_t o =
              static_cast<size_t>(sm.q[r]) * b + sm.base[r] + j0 + lane;
          const int row = clip_row(s_idx[r * kTileRows + lane], n);
          float cross = acc[i], xx = x2;
          if (row != sm.row[at + lane]) {   // not the staged row: sum it here
            const float* xr = x + static_cast<size_t>(row) * dim;
            const float* qr = q + static_cast<size_t>(sm.q[r]) * dim;
            cross = 0.f;
            xx = 0.f;
            for (int c = 0; c < dim; ++c) {
              const float v = xr[c];
              cross = fmaf(qr[c], v, cross);
              xx = fmaf(v, v, xx);
            }
          }
          out[o] = finish(sm.q2[r], cross, xx);
        }
      }
      __syncthreads();   // sm.row and s_idx are the next tile's
    }
  }
}

}  // namespace

// q: [nq, dim], x: [n, dim] fp32; idx: [nq, b] int32; valid: [nq, b] bytes;
// bucket_of: [n] int32, taken into [0, n_keys); out: [nq, b] fp32.
// Scratch (int32 unless named): q2 [nq] fp32, starts and ends [nq, b],
// n_runs [nq], counts, offsets and cursor [n_keys] (counts and cursor
// zeroed here), items [nq b / kChunk + n_keys] int2, runs [nq b] int2,
// counters [2].  nq, n, b, dim, n_keys >= 1 and nq b < 2^31.
// Returns cudaGetLastError().
extern "C" int refine_distances_f32(
    const void* q, const void* x, const void* idx, const void* valid,
    const void* bucket_of, int nq, int n, int b, int dim, int n_keys,
    void* q2, void* starts, void* ends, void* n_runs, void* counts,
    void* offsets, void* cursor, void* items, void* runs, void* counters,
    void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* xp = static_cast<const float*>(x);
  const auto* ip = static_cast<const int*>(idx);
  const auto* bp = static_cast<const int*>(bucket_of);
  auto* q2p = static_cast<float*>(q2);
  auto* cnt = static_cast<int*>(counts);
  auto* off = static_cast<int*>(offsets);
  auto* cur = static_cast<int*>(cursor);
  auto* ctr = static_cast<int*>(counters);
  auto* itp = static_cast<int2*>(items);
  auto* rnp = static_cast<int2*>(runs);
  auto* op = static_cast<float*>(out);
  cudaMemsetAsync(cnt, 0, sizeof(int) * n_keys, s);
  cudaMemsetAsync(cur, 0, sizeof(int) * n_keys, s);
  cudaMemsetAsync(ctr, 0, sizeof(int) * 2, s);
  refine_mark_kernel<<<nq, kMarkThreads, 0, s>>>(
      qp, ip, static_cast<const unsigned char*>(valid), bp, n, b, dim, n_keys,
      q2p, static_cast<int*>(starts), static_cast<int*>(ends),
      static_cast<int*>(n_runs), cnt, op);
  refine_plan_kernel<<<1, kPlanThreads, 0, s>>>(cnt, n_keys, off, itp, ctr);
  refine_place_kernel<<<nq, kPlaceThreads, 0, s>>>(
      ip, bp, n, b, n_keys, static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const int*>(n_runs), off,
      cur, rnp);

  const int slice = dim < kSlice ? dim : kSlice;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(slice) * kQPitch +
                       static_cast<size_t>(kTileRows) * (slice | 1) +
                       kChunk * kTileRows);
  // persistent: as many blocks as fit on the card at once (asked once per
  // card and shared-memory size)
  static int known_device = -1, known_blocks = 0;
  static size_t known_smem = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device != known_device || smem != known_smem) {
    cudaFuncSetAttribute(refine_compute_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, refine_compute_kernel, kComputeThreads, smem);
    known_device = device;
    known_smem = smem;
    known_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int blocks = known_blocks;
  refine_compute_kernel<<<blocks, kComputeThreads, smem, s>>>(
      qp, xp, ip, n, b, dim, q2p, rnp, itp, ctr, op);
  return static_cast<int>(cudaGetLastError());
}
