// Shared pieces of the two decode-attention kernels (agg_refine.cu,
// aggregated_attention.cu): one warp folds rows of keys and values into a
// partial softmax (running max m, normaliser l, weighted value sum acc) for
// the g query heads of one KV head, and a second kernel merges the partial
// triples of a (sequence, KV head) in a fixed order.
//
// A chunk is up to 32 rows, one per lane.  Each lane takes the dot products
// of its own row with the g queries (kept in shared memory) in 16-byte
// loads, so no shuffle is spent on the q.k sums.  The chunk's max and sum
// are warp reductions; then the warp walks the chunk's live rows four at a
// time, lanes over the value dimensions, so the value loads are coalesced
// and four rows' loads are in flight at once.  Rows that are not live are
// never read.  Masked logits take the finite NEG = -1e30 of the reference
// (src/repro/kernels/ref.py:261); a partial that saw no live row stays
// (NEG, 0, 0) and merges to nothing, so an all-masked input gives exact
// zeros and never a NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace decode_attn {

constexpr float kNeg = -1.0e30f;
constexpr int kMaxG = 8;   // query heads per KV head
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// out[gi] = q_s[gi, :] . row for gi < g; q_s is [g][dk] f32 in shared
// memory, row holds dk values of T (dk a multiple of Vec<T>::kN, 16-byte
// aligned).
template <typename T>
__device__ __forceinline__ void row_dots(const T* __restrict__ row,
                                         const float* q_s, int dk, int g,
                                         float (&out)[kMaxG]) {
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) out[gi] = 0.f;
#pragma unroll 4
  for (int d0 = 0; d0 < dk; d0 += Vec<T>::kN) {
    float x[Vec<T>::kN];
    Vec<T>::load(row + d0, x);
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float* qr = q_s + gi * dk + d0;
#pragma unroll
        for (int e = 0; e < Vec<T>::kN; ++e) {
          out[gi] = fmaf(qr[e], x[e], out[gi]);
        }
      }
    }
  }
}

// Copy the g query rows [g][dk] (contiguous f32) into shared memory.
__device__ __forceinline__ void stage_queries(const float* __restrict__ q,
                                              float* q_s, int n) {
  for (int i = threadIdx.x; i < n; i += 32) q_s[i] = q[i];
  __syncwarp();
}

// The online-softmax state of one warp for g query heads, the same on every
// lane; acc[gi][j] holds value dimension lane + 32 j.
template <int DVL>
struct Partial {
  float m[kMaxG];
  float l[kMaxG];
  float acc[kMaxG][DVL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      m[gi] = kNeg;
      l[gi] = 0.f;
#pragma unroll
      for (int j = 0; j < DVL; ++j) acc[gi][j] = 0.f;
    }
  }

  // Fold in one chunk: lane i holds row i's logits (scaled, biased) and
  // whether it is live; row i's values start at vals0 + i * vstride.
  template <typename V>
  __device__ __forceinline__ void absorb(bool live,
                                         const float (&logit)[kMaxG], int g,
                                         const V* __restrict__ vals0,
                                         size_t vstride, int dv, int lane) {
    const unsigned live_mask = __ballot_sync(kFull, live);
    if (live_mask == 0) return;
    float p[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      p[gi] = 0.f;
      if (gi < g) {
        const float x = live ? logit[gi] : kNeg;
        const float mn = fmaxf(m[gi], warp_max(x));
        const float alpha = expf(m[gi] - mn);
        p[gi] = live ? expf(x - mn) : 0.f;
        l[gi] = l[gi] * alpha + warp_sum(p[gi]);
#pragma unroll
        for (int j = 0; j < DVL; ++j) acc[gi][j] *= alpha;
        m[gi] = mn;
      }
    }
    unsigned rest = live_mask;
    while (rest != 0) {
      int src[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        src[u] = rest != 0 ? __ffs(rest) - 1 : -1;
        rest &= rest - 1;
      }
      float v[4][DVL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < DVL; ++j) {
          const int d = lane + 32 * j;
          v[u][j] = (src[u] >= 0 && d < dv)
                        ? to_float(vals0[src[u] * vstride + d])
                        : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (src[u] < 0) break;
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            const float w = __shfl_sync(kFull, p[gi], src[u]);
#pragma unroll
            for (int j = 0; j < DVL; ++j) {
              acc[gi][j] = fmaf(w, v[u][j], acc[gi][j]);
            }
          }
        }
      }
    }
  }

  // Write the triple of head gi < g to m_out[base + gi], l_out[base + gi],
  // acc_out[(base + gi) * dv + d].
  __device__ __forceinline__ void store(float* m_out, float* l_out,
                                        float* acc_out, size_t base, int g,
                                        int dv, int lane) const {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        if (lane == 0) {
          m_out[base + gi] = m[gi];
          l_out[base + gi] = l[gi];
        }
#pragma unroll
        for (int j = 0; j < DVL; ++j) {
          const int d = lane + 32 * j;
          if (d < dv) acc_out[(base + gi) * dv + d] = acc[gi][j];
        }
      }
    }
  }
};

// One warp per (sequence, KV head, query head) = blockIdx.x (query head
// fastest): merge its n_parts partial triples ([n_parts][g] of a (sequence,
// KV head); acc [n_parts][g][dv]) in part order, four parts' loads in
// flight at a time.  normalize: write acc / max(l, 1e-30) to out_acc
// [g][dv]; otherwise write the merged triple to out_m, out_l [g] and
// out_acc [g][dv].
template <int DVL>
__global__ void __launch_bounds__(32)
merge_parts_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, int n_parts, int g,
                   int dv, bool normalize, float* __restrict__ out_m,
                   float* __restrict__ out_l, float* __restrict__ out_acc) {
  const int bh = blockIdx.x / g;
  const int gi = blockIdx.x % g;
  const int lane = threadIdx.x;
  float m = kNeg;
  float l = 0.f;
  float acc[DVL];
#pragma unroll
  for (int j = 0; j < DVL; ++j) acc[j] = 0.f;
  for (int p0 = 0; p0 < n_parts; p0 += 4) {
    float pm[4], pl[4], pa[4][DVL];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = p0 + u < n_parts;
      const size_t idx =
          (static_cast<size_t>(bh) * n_parts + p0 + u) * g + gi;
      pm[u] = in ? part_m[idx] : kNeg;   // (NEG, 0, 0) merges to nothing
      pl[u] = in ? part_l[idx] : 0.f;
#pragma unroll
      for (int j = 0; j < DVL; ++j) {
        const int d = lane + 32 * j;
        pa[u][j] = (in && d < dv) ? part_acc[idx * dv + d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float mn = fmaxf(m, pm[u]);
      const float a = expf(m - mn);
      const float b = expf(pm[u] - mn);
      l = l * a + pl[u] * b;
#pragma unroll
      for (int j = 0; j < DVL; ++j) acc[j] = acc[j] * a + pa[u][j] * b;
      m = mn;
    }
  }
  const size_t o = static_cast<size_t>(bh) * g + gi;
  if (!normalize && lane == 0) {
    out_m[o] = m;
    out_l[o] = l;
  }
  const float den = normalize ? fmaxf(l, 1e-30f) : 1.f;
#pragma unroll
  for (int j = 0; j < DVL; ++j) {
    const int d = lane + 32 * j;
    if (d < dv) out_acc[o * dv + d] = normalize ? acc[j] / den : acc[j];
  }
}

// The number of value dimensions a lane holds: 1, 2, 4 or 8 (dv <= 256).
inline int dv_per_lane(int dv) {
  const int n = (dv + 31) / 32;
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8;
}

}  // namespace decode_attn
