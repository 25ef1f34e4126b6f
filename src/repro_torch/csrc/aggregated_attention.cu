// aggregated_attention: AccurateML's two-stage decode attention over a flat
// (insertion-order) aggregated KV cache, for a whole decode batch.
//
// Replaces the TPU kernel src/repro/kernels/aggregated_attention.py:
// aggregated_attention_pallas (line 131), which runs masked_decode_attention
// (pallas_call at line 94, body _decode_kernel at 30) twice per sequence,
// once over the raw tokens with a bias masking every token outside the
// refined buckets and at or past valid_len, once over the bucket centroids
// with bias log(count) (masking refined and empty buckets), then merges the
// two partial softmaxes (merge_partials, line 118).  The bias vectors are
// built outside the kernel, the grid is (KV head, token tile) with the
// partials carried across tiles in the output block, and the JAX caller
// vmaps it over the batch.
//
// What bounds it here: bytes.  The flat layout keeps tokens in insertion
// order, so the refined tokens lie anywhere below valid_len.  It must read
// bucket_of below valid_len, the centroid tables and the K/V rows of the
// refined tokens; the TPU kernel reads every slot of the cache (at the
// qwen3-8b decode shapes, B 4, S 1024, Hkv 8, d 128, bf16: 16.8 MB, 5 us at
// 3.35 TB/s).  Operations are 2 G (dk + dv) per row read.
//
// Design.  One launch for the batch.  The live masks are computed in the
// kernel from bucket_of, refined, counts and valid_len[b]: no bias vector
// exists, and a masked token's K/V row is never read.  Grid (part, KV head,
// sequence), one warp a block: parts 0 .. n_tok_parts - 1 take consecutive
// runs of `chunk` tokens, part n_tok_parts takes the K centroids with bias
// log(max(count, 1)).  Each warp folds its rows into a partial softmax for
// the G query heads of its KV head (query head h uses KV head h / G); a
// second kernel merges the parts of each (sequence, KV head) in part order,
// centroids last, and writes acc / max(l, 1e-30), so the result is the same
// bits on every run.  A masked logit never enters a sum, and the all-empty
// cache gives exact zeros (decode_attn.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

template <typename T, int DVL>
__global__ void __launch_bounds__(32)
aggregated_attention_part_kernel(
    const float* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ bucket_of,
    const float* __restrict__ mean_k, const float* __restrict__ mean_v,
    const int* __restrict__ counts, const unsigned char* __restrict__ refined,
    const int* __restrict__ valid_len, int s, int kb, int hkv, int g, int dk,
    int dv, int chunk, int n_tok_parts, float scale,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc) {
  extern __shared__ float q_s[];  // [g][dk]
  const int part = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x;
  stage_queries(q + static_cast<size_t>(b * hkv + kvh) * g * dk, q_s, g * dk);

  const size_t kstride = static_cast<size_t>(hkv) * dk;
  const size_t vstride = static_cast<size_t>(hkv) * dv;
  const unsigned char* ref_b = refined + static_cast<size_t>(b) * kb;
  const int* cnt_b = counts + static_cast<size_t>(b) * kb;
  Partial<DVL> st;
  st.init();
  float logit[kMaxG];
  if (part < n_tok_parts) {
    // token pass: the refined buckets' tokens below valid_len
    const int vl = min(valid_len[b], s);
    const int t_end = min(part * chunk + chunk, vl);
    const size_t seq = static_cast<size_t>(b) * s;
    const T* kbase = k_cache + seq * kstride + static_cast<size_t>(kvh) * dk;
    const T* vbase = v_cache + seq * vstride + static_cast<size_t>(kvh) * dv;
    for (int t0 = part * chunk; t0 < t_end; t0 += 32) {
      const int t = t0 + lane;
      bool live = false;
      if (t < t_end) {
        const int bk = min(max(bucket_of[seq + t], 0), kb - 1);
        live = ref_b[bk] != 0;
      }
      if (live) {
        row_dots(kbase + t * kstride, q_s, dk, g, logit);
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) logit[gi] *= scale;
      }
      st.absorb(live, logit, g, vbase + t0 * vstride, vstride, dv, lane);
    }
  } else {
    // centroid pass: the unrefined non-empty buckets, weighted by count
    const size_t seq = static_cast<size_t>(b) * kb;
    const float* kbase =
        mean_k + seq * kstride + static_cast<size_t>(kvh) * dk;
    const float* vbase =
        mean_v + seq * vstride + static_cast<size_t>(kvh) * dv;
    for (int c0 = 0; c0 < kb; c0 += 32) {
      const int c = c0 + lane;
      bool live = false;
      int cnt = 0;
      if (c < kb) {
        cnt = cnt_b[c];
        live = ref_b[c] == 0 && cnt > 0;
      }
      if (live) {
        row_dots(kbase + c * kstride, q_s, dk, g, logit);
        const float bias = logf(fmaxf(static_cast<float>(cnt), 1.f));
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          logit[gi] = logit[gi] * scale + bias;
        }
      }
      st.absorb(live, logit, g, vbase + c0 * vstride, vstride, dv, lane);
    }
  }
  st.store(part_m, part_l, part_acc,
           (static_cast<size_t>(b * hkv + kvh) * (n_tok_parts + 1) + part) * g,
           g, dv, lane);
}

struct Args {
  const void *q, *k_cache, *v_cache, *bucket_of, *mean_k, *mean_v, *counts,
      *refined, *valid_len;
  int b, s, kb, hkv, g, dk, dv, chunk, n_tok_parts;
  float scale;
  void *part_m, *part_l, *part_acc, *out;
};

template <typename T, int DVL>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_tok_parts + 1, a.hkv, a.b);
  const size_t smem = static_cast<size_t>(a.g) * a.dk * sizeof(float);
  aggregated_attention_part_kernel<T, DVL><<<grid, 32, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k_cache),
      static_cast<const T*>(a.v_cache), static_cast<const int*>(a.bucket_of),
      static_cast<const float*>(a.mean_k), static_cast<const float*>(a.mean_v),
      static_cast<const int*>(a.counts),
      static_cast<const unsigned char*>(a.refined),
      static_cast<const int*>(a.valid_len), a.s, a.kb, a.hkv, a.g, a.dk, a.dv,
      a.chunk, a.n_tok_parts, a.scale, static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc));
  merge_parts_kernel<DVL><<<a.b * a.hkv * a.g, 32, 0, stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), a.n_tok_parts + 1, a.g, a.dv,
      true, nullptr, nullptr, static_cast<float*>(a.out));
}

template <typename T>
void dispatch(const Args& a, cudaStream_t stream) {
  switch (dv_per_lane(a.dv)) {
    case 1: launch<T, 1>(a, stream); break;
    case 2: launch<T, 2>(a, stream); break;
    case 4: launch<T, 4>(a, stream); break;
    default: launch<T, 8>(a, stream); break;
  }
}

}  // namespace

// q: [b, hkv * g, dk] f32; k_cache/v_cache: [b, s, hkv, dk|dv] of bf16
// (bf16 != 0) or f32; bucket_of: [b, s] int32 (clipped to [0, kb));
// mean_k/mean_v: [b, kb, hkv, dk|dv] f32; counts: [b, kb] int32; refined:
// [b, kb] bytes; valid_len: [b] int32.  part_*: [b, hkv, n_tok_parts + 1, g]
// (acc: x dv) f32 scratch; out: [b, hkv * g, dv] f32.  chunk is a multiple
// of 32 and n_tok_parts * chunk >= s.  g <= 8, dv <= 256, dk a multiple of
// 16 bytes' worth of the cache type, every pointer 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int aggregated_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* bucket_of, const void* mean_k, const void* mean_v,
    const void* counts, const void* refined, const void* valid_len, int bf16,
    int b, int s, int kb, int hkv, int g, int dk, int dv, int chunk,
    int n_tok_parts, float scale, void* part_m, void* part_l, void* part_acc,
    void* out, void* stream) {
  const Args a{q, k_cache, v_cache, bucket_of, mean_k, mean_v, counts,
               refined, valid_len, b, s, kb, hkv, g, dk, dv, chunk,
               n_tok_parts, scale, part_m, part_l, part_acc, out};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dispatch<__nv_bfloat16>(a, st);
  } else {
    dispatch<float>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
