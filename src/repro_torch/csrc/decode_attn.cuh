// Shared pieces of the two decode-attention kernels (agg_refine.cu,
// aggregated_attention.cu).
//
// Both are latency-bound: at the LM's shapes a (sequence, KV head) owns
// tens of kilobytes of live rows, and what sets a launch's time is the
// launch itself and the chain of dependent steps behind it.  So both run as
// one launch, one thread-block cluster of kCluster blocks of kWarps warps
// per (sequence, KV head, head tile, value tile), and the partial softmaxes
// meet on the chip.  A tile holds up to kMaxG query heads and kValueTile
// value columns (Tile): MLA's absorbed decode has 128 query heads of 576
// wide keys over one KV head, whose f32 queries alone (295 KB) would not
// fit a block's shared memory, so its (sequence, KV head) takes 16 head
// tiles times 2 value tiles of clusters, each re-reading the key rows it
// needs (from L2 after the first).
//
// - Each warp of the cluster (unit = warp * kCluster + rank, so consecutive
//   units land on different SMs) takes a fixed share of the rows: selection
//   slots, or a span of tokens, or a span of centroids.  Its first indices
//   are loaded (a lane each) while the block stages the queries and the
//   sequence's bucket counts; the live rows' ids go to a list in shared
//   memory, and a chunk of live K and V rows (as many as the wrapper's
//   geometry gives, at most 32) is copied into the warp's shared memory
//   with 16-byte cp.async, all issued before the first FMA, and folded
//   into a running (m, l, acc) for the G query heads of the KV head.  Rows
//   that are not live are never read.
// - Each block merges its warps' partials in shared memory in warp order
//   and scatters the result over the cluster: share j of the values goes to
//   block rank j's shared memory (distributed shared memory), so after one
//   cluster barrier every block merges its share over the ranks in rank
//   order and writes that part of the output (rank 0 writes m and l).  A
//   merge takes each head's largest m first, then one weight exp(m - max)
//   per partial and head, and sums in a fixed order: no chain of
//   exponentials per value, and the same bits on every run.
//
// Within a chunk of n rows, row i takes lane i and, when n <= 16, the lanes
// i + R, i + 2R, ... as well (R: n rounded up to a power of two), which
// split its dot products with the queries (staged in shared memory, zero
// rows past g) and add them in a butterfly; the chunk's max and sum are
// reductions over R lanes, all heads at once.  For the values the warp
// splits into row groups of lpr lanes, each lane a 16-byte piece of a row,
// and the groups' sums are added at the end.  Rows sit in shared memory at
// an odd number of 16-byte pieces, so the lanes of a quarter warp that read
// different rows hit different banks.  Masked logits take the finite NEG =
// -1e30 of the reference (src/repro/kernels/ref.py:261); a partial that saw
// no live row stays (NEG, 0, 0) and merges to nothing, so an all-masked
// input gives exact zeros and never a NaN.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace decode_attn {

namespace cg = cooperative_groups;

constexpr float kNeg = -1.0e30f;
constexpr int kMaxG = 8;          // query heads of a head tile
constexpr int kValueTile = 256;   // value columns of a value tile
constexpr int kCluster = 8;       // blocks per (sequence, KV head)
constexpr int kWarps = 4;         // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnits = kCluster * kWarps;  // warps per (sequence, KV head)
constexpr int kRows = 32;         // rows of a window: one per lane
constexpr unsigned kFull = 0xffffffffu;

// Tiles of n by t.
__host__ __device__ inline int tiles(int n, int t) { return (n + t - 1) / t; }

// The part of a (sequence, KV head)'s work a cluster takes: a tile of at
// most kMaxG of its g query heads and one of at most kValueTile of its dv
// value columns.  blockIdx.y = (kvh * head tiles + head tile) * value tiles
// + value tile, so one launch covers every tile (kernels/decode_geometry.py
// mirrors this).  Every tile reads the whole key rows: the logits are the
// same in each value tile, and the first writes m and l.
struct Tile {
  int kvh, g0, g, v0, dv;
  __device__ Tile(int y, int g_all, int dv_all) {
    const int tv = tiles(dv_all, kValueTile);
    const int tg = tiles(g_all, kMaxG);
    const int vt = y % tv;
    y /= tv;
    const int gt = y % tg;
    kvh = y / tg;
    g0 = gt * kMaxG;
    g = min(kMaxG, g_all - g0);
    v0 = vt * kValueTile;
    dv = min(kValueTile, dv_all - v0);
  }
};

// The launch grid's y extent: every (KV head, head tile, value tile).
inline int grid_y(int hkv, int g, int dv) {
  return hkv * tiles(g, kMaxG) * tiles(dv, kValueTile);
}

// Blocks an SM should hold, for the register limit: a kernel instantiated
// for GM <= 4 query heads and one 16-byte piece of a value row a lane (P)
// keeps 4 blocks (128 registers a thread), so the B Hkv clusters of a
// decode batch are resident at once; wider ones take what they need.
template <int GM, int P>
constexpr int min_blocks() {
  return GM <= 4 && P == 1 ? 4 : 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 bytes of a row as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// An odd number of 16-byte pieces per row in shared memory.
__host__ __device__ inline int padded16(int n16) {
  return n16 % 2 ? n16 : n16 + 1;
}

__host__ __device__ inline int lanes_per_row(int n16) {
  int p = 1;
  while (p < n16 && p < 32) p <<= 1;
  return p;
}

// How K rows of dk and V rows of dv values of T sit in shared memory.
template <typename T>
struct Rows {
  static constexpr int kN = Vec<T>::kN;
  int n16k, n16v;  // 16-byte pieces of a K row, of a V row
  int kst, vst;    // row strides in shared memory, in values
  int lpr;         // lanes per V row (a power of two)
  __host__ __device__ Rows(int dk, int dv)
      : n16k(dk / kN),
        n16v(dv / kN),
        kst(padded16(dk / kN) * kN),
        vst(padded16(dv / kN) * kN),
        lpr(lanes_per_row(dv / kN)) {}
  // shared memory of one row's K and V
  __host__ __device__ int bytes() const {
    return (kst + vst) * static_cast<int>(sizeof(T));
  }
};

// Bytes of a partial triple of g heads, a slot: acc [g][dv] (16-byte
// aligned), then m [g], then l [g], floats.
__host__ __device__ inline int slot_bytes(int g, int dv) {
  return align16(g * (dv + 2) * static_cast<int>(sizeof(float)));
}

// Bytes of the merge weights (a block's kWarps and the cluster's kCluster
// per head) and of the cluster's l per head.
__host__ __device__ inline int weight_bytes(int g) {
  return align16((kWarps + kCluster + 1) * g * 4);
}

// Copy the g query rows [g][dk] (contiguous f32) into shared memory, by the
// whole block, and commit the copies; rows g .. gm - 1 are zeros, so a
// warp computes all gm heads without a branch per head.
__device__ __forceinline__ void stage_queries(const float* __restrict__ q,
                                              float* q_s, int g, int gm,
                                              int dk) {
  const int n = g * dk;
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) {
    cp_async16(q_s + i, q + i);
  }
  cp_async_commit();
  for (int i = n + threadIdx.x; i < gm * dk; i += kThreads) q_s[i] = 0.f;
}

// Issue the copies of a chunk's n rows into ks / vs: row i's id is rid_s[i]
// (shared memory), its K row at kg + id * dk and its V row at vg + id * dv.
// Row by row, the lanes over its 16-byte pieces; all of the chunk's copies
// are in flight together, and the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_rows(T* ks, T* vs, const Rows<T>& rs,
                                           const T* __restrict__ kg,
                                           const T* __restrict__ vg, int dk,
                                           int dv, const long long* rid_s,
                                           int n, int lane) {
  constexpr int kN = Vec<T>::kN;
  const int per = rs.n16k + rs.n16v;
#pragma unroll 4
  for (int row = 0; row < n; ++row) {
    const long long r = rid_s[row];
    for (int pc = lane; pc < per; pc += 32) {
      if (pc < rs.n16k) {
        cp_async16(ks + row * rs.kst + pc * kN, kg + r * dk + pc * kN);
      } else {
        const int pv = pc - rs.n16k;
        cp_async16(vs + row * rs.vst + pv * kN, vg + r * dv + pv * kN);
      }
    }
  }
}

// The online-softmax state of one warp for GM query heads (q rows past g
// are zeros, and their partials are never written): m and l the same on
// every lane; acc[gi][pc * kN + e] holds value dimension
// (lir + pc * lpr) * kN + e of the lane's row group (lir = lane % lpr),
// summed over the groups by store().
template <typename T, int P, int GM>
struct Partial {
  static constexpr int kN = Vec<T>::kN;
  float m[GM];
  float l[GM];
  float acc[GM][P * kN];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      m[gi] = kNeg;
      l[gi] = 0.f;
#pragma unroll
      for (int j = 0; j < P * kN; ++j) acc[gi][j] = 0.f;
    }
  }

  // Fold in a staged chunk of 1 <= n <= 32 live rows (ks, vs); row i's
  // scaled logits get bias_s[i] added (no bias when bias_s is null).  The
  // rows take the first R lanes (R: n rounded up to a power of two) and the
  // 32 / R lane groups split each row's dot products, added in a butterfly,
  // so every lane of a row holds the same logits.
  __device__ __forceinline__ void absorb(const T* ks, const T* vs,
                                         const Rows<T>& rs, int n,
                                         const float* bias_s,
                                         const float* q_s, int dk,
                                         float scale, int lane) {
    int big = 1;
    while (big < n) big <<= 1;
    const int row = lane & (big - 1);
    const bool live = row < n;
    float logit[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) logit[gi] = 0.f;
    if (live) {
      const T* kr = ks + row * rs.kst;
#pragma unroll 2
      for (int pc = lane / big; pc < rs.n16k; pc += 32 / big) {
        float x[kN];
        Vec<T>::load(kr + pc * kN, x);
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
          const float* qr = q_s + gi * dk + pc * kN;
#pragma unroll
          for (int e = 0; e < kN; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            logit[gi] = fmaf(qv.x, x[e], logit[gi]);
            logit[gi] = fmaf(qv.y, x[e + 1], logit[gi]);
            logit[gi] = fmaf(qv.z, x[e + 2], logit[gi]);
            logit[gi] = fmaf(qv.w, x[e + 3], logit[gi]);
          }
        }
      }
    }
    for (int off = big; off < 32; off <<= 1) {
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        logit[gi] += __shfl_xor_sync(kFull, logit[gi], off);
      }
    }
    // the chunk's max and sum over the rows' lanes, every head at once
    const float bias = live && bias_s != nullptr ? bias_s[row] : 0.f;
    float cm[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      logit[gi] = live ? logit[gi] * scale + bias : kNeg;
      cm[gi] = logit[gi];
    }
    for (int o = big >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        cm[gi] = fmaxf(cm[gi], __shfl_xor_sync(kFull, cm[gi], o));
      }
    }
    float p[GM];
    float sum[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      const float mn = fmaxf(m[gi], cm[gi]);
      cm[gi] = expf(m[gi] - mn);  // the old partial's rescale
      p[gi] = live ? expf(logit[gi] - mn) : 0.f;
      sum[gi] = p[gi];
      m[gi] = mn;
    }
    for (int o = big >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        sum[gi] += __shfl_xor_sync(kFull, sum[gi], o);
      }
    }
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      l[gi] = l[gi] * cm[gi] + sum[gi];
#pragma unroll
      for (int j = 0; j < P * kN; ++j) acc[gi][j] *= cm[gi];
    }
    const int grp = lane / rs.lpr;
    const int lir = lane - grp * rs.lpr;
    const int n_grp = 32 / rs.lpr;
    for (int j0 = 0; j0 < n; j0 += n_grp) {
      const int j = j0 + grp;
      const bool ok = j < n;
      float w[GM];
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        w[gi] = __shfl_sync(kFull, p[gi], ok ? j : 0);
      }
      if (ok) {
        const T* vrow = vs + j * rs.vst;
#pragma unroll
        for (int pc = 0; pc < P; ++pc) {
          const int piece = lir + pc * rs.lpr;
          if (piece < rs.n16v) {
            float v[kN];
            Vec<T>::load(vrow + piece * kN, v);
#pragma unroll
            for (int gi = 0; gi < GM; ++gi) {
#pragma unroll
              for (int e = 0; e < kN; ++e) {
                acc[gi][pc * kN + e] = fmaf(w[gi], v[e], acc[gi][pc * kN + e]);
              }
            }
          }
        }
      }
    }
  }

  // Add up the row groups and write the triple of heads gi < g to slot.
  __device__ __forceinline__ void store(float* slot, const Rows<T>& rs,
                                        int g, int dv, int lane) {
    for (int off = rs.lpr; off < 32; off <<= 1) {
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
#pragma unroll
        for (int j = 0; j < P * kN; ++j) {
          acc[gi][j] += __shfl_xor_sync(kFull, acc[gi][j], off);
        }
      }
    }
    if (lane < rs.lpr) {
#pragma unroll
      for (int pc = 0; pc < P; ++pc) {
        const int piece = lane + pc * rs.lpr;
        if (piece < rs.n16v) {
#pragma unroll
          for (int gi = 0; gi < GM; ++gi) {
            if (gi < g) {
#pragma unroll
              for (int e = 0; e < kN; e += 4) {
                *reinterpret_cast<float4*>(slot + gi * dv + piece * kN + e) =
                    make_float4(acc[gi][pc * kN + e], acc[gi][pc * kN + e + 1],
                                acc[gi][pc * kN + e + 2],
                                acc[gi][pc * kN + e + 3]);
              }
            }
          }
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi < g) {
          slot[g * dv + gi] = m[gi];
          slot[g * dv + g + gi] = l[gi];
        }
      }
    }
  }
};

__device__ __forceinline__ void fma4(float4& a, const float4 x, float w) {
  a.x = fmaf(x.x, w, a.x);
  a.y = fmaf(x.y, w, a.y);
  a.z = fmaf(x.z, w, a.z);
  a.w = fmaf(x.w, w, a.w);
}

// The cluster barrier in two halves: every thread arrives once it starts
// (cluster_arrive) and waits (cluster_wait) before its block first writes
// to another block's shared memory, by which time all have started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A block's share of the cluster merge: share4 float4 groups of the g x dv
// values (the last share may be short), so each block merges and writes
// one kCluster-th of the output.
__host__ __device__ inline int share4(int g, int dv) {
  return (g * dv / 4 + kCluster - 1) / kCluster;
}

// Floats a rank's partial takes in a block's gather area: its share of
// acc, then m [g] and l [g] (16-byte aligned).
__host__ __device__ inline int slice_floats(int g, int dv) {
  return (share4(g, dv) * 4 + 2 * g + 3) / 4 * 4;
}

// Bytes of a block's gather area: one slice from every rank.
__host__ __device__ inline int gather_bytes(int g, int dv) {
  return kCluster * slice_floats(g, dv) * 4;
}

// Merge the block's warps' partials (warp w's slot at slot0 + w * stride
// floats) and scatter the result over the cluster: each head's largest m
// over the warps, one weight exp(m_w - max) per warp and head (kept in
// wts), the sums in warp order four values a thread at a time; share j of
// the values, with every head's m and l, goes to block rank j's gather
// area (distributed shared memory) at slice `rank`.  The caller's cluster
// barrier then completes every block's gather area.
__device__ __forceinline__ void merge_block(cg::cluster_group& cluster,
                                            int rank, const float* slot0,
                                            int stride, float* gather,
                                            float* wts, int g, int dv) {
  const int n = g * dv;
  const int sh = share4(g, dv);
  const int sf = slice_floats(g, dv);
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    float ms[kWarps];
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ms[w] = slot0[w * stride + n + gi];
      mx = fmaxf(mx, ms[w]);
    }
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = expf(ms[w] - mx);
      wts[w * g + gi] = x;
      l = fmaf(slot0[w * stride + n + g + gi], x, l);
    }
#pragma unroll
    for (int j = 0; j < kCluster; ++j) {
      float* dst = cluster.map_shared_rank(gather, j) + rank * sf + sh * 4;
      dst[gi] = mx;
      dst[g + gi] = l;
    }
  }
  __syncthreads();
  for (int e4 = threadIdx.x; e4 < n / 4; e4 += kThreads) {
    const int gi = e4 * 4 / dv;
    const float4* s0 = reinterpret_cast<const float4*>(slot0) + e4;
    float4 x[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x[w] = s0[w * (stride / 4)];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) fma4(a, x[w], wts[w * g + gi]);
    const int j = e4 / sh;
    float* dst = cluster.map_shared_rank(gather, j) + rank * sf;
    reinterpret_cast<float4*>(dst)[e4 - j * sh] = a;
  }
}

// After the cluster barrier that completes the gather area: merge this
// block's share of the values over the ranks, in rank order.  Each head's
// largest m over the ranks, one weight exp(m_r - max) per rank and head
// (kept in wts; the heads' l in lsum); block rank 0 calls emit(gi, m, l)
// once per head.  emit4(e4, a, l) is called once per four values
// e4 * 4 .. e4 * 4 + 3 of acc [g][dv] in this block's share, with their
// head's l.  A share takes at most one value group a thread
// (g dv <= 32 kThreads).
template <typename Emit, typename Emit4>
__device__ __forceinline__ void merge_cluster(int rank, const float* gather,
                                              float* wts, float* lsum, int g,
                                              int dv, Emit emit,
                                              Emit4 emit4) {
  const int sh = share4(g, dv);
  const int sf = slice_floats(g, dv);
  const int gi = threadIdx.x;
  if (gi < g) {
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mx = fmaxf(mx, gather[r * sf + sh * 4 + gi]);
    }
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float w = expf(gather[r * sf + sh * 4 + gi] - mx);
      wts[r * g + gi] = w;
      l = fmaf(gather[r * sf + sh * 4 + g + gi], w, l);
    }
    lsum[gi] = l;
    if (rank == 0) emit(gi, mx, l);
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int e4 = rank * sh + t;
  if (t < sh && e4 < g * dv / 4) {
    const int h = e4 * 4 / dv;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      fma4(a, reinterpret_cast<const float4*>(gather + r * sf)[t],
           wts[r * g + h]);
    }
    emit4(e4, a, lsum[h]);
  }
}

// Set a kernel's dynamic shared memory limit to `bytes` when it is above
// the limit already set (once per kernel and size).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& set) {
  if (bytes <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) set = bytes;
  return err;
}

}  // namespace decode_attn
