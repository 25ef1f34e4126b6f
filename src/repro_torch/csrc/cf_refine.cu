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
// across b.
//
// What bounds it here: bytes.  Every term carries the selected user's mask,
// so only the items it rated add anything: at eps 0.05 ([1024, 301] slots
// against a 6,002-user shard, density 1.2 %) about 170 an used slot, not
// 17,700.  The least time is then the dense inputs read once (the active
// rows and about 6,000 distinct shard rows) and num / den written once:
// 1.14 GB, 0.34 ms at 3.35 TB/s.
//
// Design, in two launches (cf_sparse.cuh's compaction, then the rest):
//   (a) cf_compact reads the active rows and the shard once and writes each
//       row's rated entries {item, centred, mask, centred^2}, centred on the
//       card, with their offsets by item.  No plain-torch centring.  The
//       shard's lists (about 16 MB at the path's shape) stay in the L2.
//   (b) cf_refine_kernel, one block a query, its items in passes of up to
//       kPass (one pass at I = 17,700) held in shared memory:
//       - weights: the query's (centred, mask) row is scattered from its
//         list into shared memory; a warp a used slot walks the selected
//         user's entries (neighbouring lanes, neighbouring entries), looks
//         the query up at each item and sums the four terms, joined by a
//         fixed butterfly; lane 0 writes the shrunk, use-gated w;
//       - accumulation: (num, den) pairs of the pass in shared memory; the
//         used slots go in ascending order, the TPU's order, one slot a
//         step: a thread an entry adds w * centred and |w| * mask at its
//         item, then the block meets at a barrier, so that no two slots
//         touch an item at once.  A slot's entries come through a ring of
//         kDepth steps in shared memory, copied with cp.async kDepth - 1
//         steps ahead, so that a step waits on no load.  Each output row
//         is written once.
//       No atomics: every sum has one fixed order, so two runs give the
//       same bits.
#include <cuda_runtime.h>

#include "cf_sparse.cuh"
#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPass = 20480;         // items a pass (160 KB of pairs)
constexpr int kPassFine = kPass / kFine;
constexpr int kWindow = kThreads;    // slots listed at a time, a thread each
constexpr int kAhead = 8;            // a slot's entries a lane loads at once
constexpr int kDepth = 4;            // steps in the ring
// Shared memory besides the row: s_part (float4), s_src (long long),
// s_slot, s_n (int) and s_w (float), kWindow each, and the ring (float4).
constexpr int kTableBytes =
    kWindow * (16 + 4 * 4 + 4) + kDepth * kThreads * 16;

// Lists the used slots of [w0, w0 + kWindow) in ascending order: s_slot,
// and each one's entries in fine steps [f0, f1) of its row (clipped to
// [0, nu)): s_src (their start in uent), s_n.  With zero_w, writes w = 0
// for the unused slots.
// Returns their number, the same on every thread.
__device__ int list_used(const int* __restrict__ idx,
                         const unsigned char* __restrict__ use, size_t qb,
                         int b, int w0, int nu, const int* __restrict__ uoffs,
                         int nfine, int ni, int f0, int f1, int* s_slot,
                         long long* s_src, int* s_n, int* warp_used,
                         float* __restrict__ w, bool zero_w) {
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = w0 + threadIdx.x;
  bool used = false;
  int row = 0;
  if (s < b) {
    used = use[qb + s] != 0;
    if (used) {
      row = min(max(idx[qb + s], 0), nu - 1);
    } else if (zero_w) {
      w[qb + s] = 0.f;
    }
  }
  int lo = 0;
  int hi = 0;
  if (used) {
    const int* o = uoffs + static_cast<size_t>(row) * (nfine + 1);
    lo = o[f0];
    hi = o[f1];
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, used);
  if (lane == 0) warp_used[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u));
  int n = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    pos += k < warp ? warp_used[k] : 0;
    n += warp_used[k];
  }
  if (used) {
    s_slot[pos] = s;
    s_src[pos] = static_cast<long long>(row) * ni + lo;
    s_n[pos] = hi - lo;
  }
  __syncthreads();
  return n;
}

// The four sums of the weight, for the entry v of the selected user
// against the query's (centred, mask) row.
__device__ __forceinline__ void weight_terms(const float2* row, int p0,
                                             float4 v, float4& t) {
  const float2 a = row[cf_item(v) - p0];
  t.x = fmaf(a.x, v.y, t.x);
  t.y = fmaf(a.x * a.x, v.z, t.y);
  t.z = fmaf(a.y, v.w, t.z);
  t.w = fmaf(a.y, v.z, t.w);
}

__global__ void __launch_bounds__(kThreads, 1)
cf_refine_kernel(const float4* __restrict__ aent,
                 const int* __restrict__ aoffs,
                 const float4* __restrict__ uent,
                 const int* __restrict__ uoffs, const int* __restrict__ idx,
                 const unsigned char* __restrict__ use, int nu, int b, int ni,
                 float shrink, float* __restrict__ w, float* __restrict__ num,
                 float* __restrict__ den) {
  extern __shared__ float4 smem[];
  __shared__ int warp_used[kWarps];
  const int rowlen = min(ni, kPass);
  float4* s_part = smem;
  float4* ring = s_part + kWindow;            // [kDepth][kThreads]
  float2* row = reinterpret_cast<float2*>(ring + kDepth * kThreads);
  long long* s_src = reinterpret_cast<long long*>(row + rowlen);
  int* s_slot = reinterpret_cast<int*>(s_src + kWindow);
  int* s_n = s_slot + kWindow;
  float* s_w = reinterpret_cast<float*>(s_n + kWindow);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = blockIdx.x;
  const size_t qb = static_cast<size_t>(q) * b;
  const int nfine = cf_fine(ni);
  const int npass = (ni + kPass - 1) / kPass;
  const int* qo = aoffs + static_cast<size_t>(q) * (nfine + 1);
  const float4* qe = aent + static_cast<size_t>(q) * ni;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- weights: the query's row in shared memory, a warp a used slot ----
  for (int w0 = 0; w0 < b; w0 += kWindow) {
    for (int p = 0; p < npass; ++p) {
      const int p0 = p * kPass;
      const int p1 = min(ni, p0 + kPass);
      const int f0 = p * kPassFine;
      const int f1 = cf_fine(p1);
      const int n = list_used(idx, use, qb, b, w0, nu, uoffs, nfine, ni, f0,
                              f1, s_slot, s_src, s_n, warp_used, w, p == 0);
      for (int i = tid; i < p1 - p0; i += kThreads)
        row[i] = make_float2(0.f, 0.f);
      __syncthreads();
      for (int j = qo[f0] + tid; j < qo[f1]; j += kThreads) {
        const float4 v = qe[j];
        row[cf_item(v) - p0] = make_float2(v.y, v.z);
      }
      __syncthreads();
      for (int s = warp; s < n; s += kWarps) {
        float4 x[kAhead];  // the slot's first 32 kAhead entries, at once
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
          const int j = lane + 32 * i;
          x[i] = j < s_n[s] ? uent[s_src[s] + j] : zero;
        }
        const int cnt = s_n[s];
        float4 t = zero;
#pragma unroll
        for (int i = 0; i < kAhead; ++i)
          if (lane + 32 * i < cnt) weight_terms(row, p0, x[i], t);
        for (int j = lane + 32 * kAhead; j < cnt; j += 32)
          weight_terms(row, p0, uent[s_src[s] + j], t);
        t = make_float4(cf_warp_sum(t.x), cf_warp_sum(t.y),
                        cf_warp_sum(t.z), cf_warp_sum(t.w));
        if (lane == 0) {
          if (p > 0) {
            const float4 prev = s_part[s];
            t = make_float4(prev.x + t.x, prev.y + t.y, prev.z + t.z,
                            prev.w + t.w);
          }
          s_part[s] = t;
          if (p == npass - 1) {
            const float wt = t.x / sqrtf(fmaxf(t.y * t.z, 1e-12f));
            w[qb + s_slot[s]] = wt * (t.w / (t.w + shrink));
          }
        }
      }
    }
  }

  // ---- accumulation: one used slot a step, in ascending order ----
  for (int p = 0; p < npass; ++p) {
    const int p0 = p * kPass;
    const int p1 = min(ni, p0 + kPass);
    const int f0 = p * kPassFine;
    const int f1 = cf_fine(p1);
    __syncthreads();
    for (int i = tid; i < p1 - p0; i += kThreads)
      row[i] = make_float2(0.f, 0.f);
    for (int w0 = 0; w0 < b; w0 += kWindow) {
      const int n = list_used(idx, use, qb, b, w0, nu, uoffs, nfine, ni, f0,
                              f1, s_slot, s_src, s_n, warp_used, w, false);
      for (int s = tid; s < n; s += kThreads) s_w[s] = w[qb + s_slot[s]];
      __syncthreads();
      // Step t's first kThreads entries go to ring slot t % kDepth, copied
      // kDepth - 1 steps ahead; a step's weight, count and first entry are
      // read before the step before it is added, so that a step is one
      // read-add-write of a pair and a barrier.
      auto issue = [&](int t) {
        if (t < n && tid < s_n[t])
          copy16(ring + (t % kDepth) * kThreads + tid, uent + s_src[t] + tid);
        copy_commit();
      };
#pragma unroll
      for (int t = 0; t < kDepth - 1; ++t) issue(t);
      copy_wait<kDepth - 2>();
      __syncthreads();
      float wt = n > 0 ? s_w[0] : 0.f;
      int cnt = n > 0 ? s_n[0] : 0;
      float4 v = ring[tid];
      for (int t = 0; t < n; ++t) {
        issue(t + kDepth - 1);
        auto add = [&](const float4& e) {
          float2& a = row[cf_item(e) - p0];
          a.x = fmaf(wt, e.y, a.x);
          a.y = fmaf(fabsf(wt), e.z, a.y);
        };
        if (tid < cnt) add(v);
        if (cnt > kThreads) {
          const float4* ve = uent + s_src[t];
          for (int j = tid + kThreads; j < cnt; j += kThreads) add(ve[j]);
        }
        copy_wait<kDepth - 2>();
        __syncthreads();  // step t is added; step t + 1's entries landed
        if (t + 1 < n) {
          wt = s_w[t + 1];
          cnt = s_n[t + 1];
          v = ring[((t + 1) % kDepth) * kThreads + tid];
        }
      }
      copy_wait<0>();
    }
    __syncthreads();
    float* nq_row = num + static_cast<size_t>(q) * ni + p0;
    float* dq_row = den + static_cast<size_t>(q) * ni + p0;
    for (int i = tid; i < p1 - p0; i += kThreads) {
      const float2 a = row[i];
      __stcs(nq_row + i, a.x);  // written once: evict first
      __stcs(dq_row + i, a.y);
    }
  }
}

// a, am: [nq, ni]; r, m: [nu, ni] fp32; idx: [nq, b] int32; use: [nq, b]
// bytes -> w: [nq, b], num, den: [nq, ni] fp32.  aent / aoffs and uent /
// uoffs: the compaction's scratch for each side ([rows, ni] float4,
// [rows, cf_fine(ni) + 1] int).  nq, nu, ni >= 1; b may be 0 (then num and
// den are written as zeros).  Returns cudaGetLastError() after the
// launches.
extern "C" int cf_refine_f32(const void* a, const void* am, const void* r,
                             const void* m, const void* idx, const void* use,
                             int nq, int nu, int b, int ni, float shrink,
                             void* aent, void* aoffs, void* uent, void* uoffs,
                             void* w, void* num, void* den, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* ae = static_cast<float4*>(aent);
  float4* ue = static_cast<float4*>(uent);
  int* ao = static_cast<int*>(aoffs);
  int* uo = static_cast<int*>(uoffs);
  int err = cf_compact(static_cast<const float*>(a),
                       static_cast<const float*>(am), nq, ae, ao,
                       static_cast<const float*>(r),
                       static_cast<const float*>(m), nu, ue, uo, ni, st);
  if (err != 0) return err;
  const int bytes = kTableBytes + (ni < kPass ? ni : kPass) *
                                      static_cast<int>(sizeof(float2));
  err = static_cast<int>(cudaFuncSetAttribute(
      cf_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err != 0) return err;
  cf_refine_kernel<<<nq, kThreads, bytes, st>>>(
      ae, ao, ue, uo, static_cast<const int*>(idx),
      static_cast<const unsigned char*>(use), nu, b, ni, shrink,
      static_cast<float*>(w), static_cast<float*>(num),
      static_cast<float*>(den));
  return static_cast<int>(cudaGetLastError());
}
