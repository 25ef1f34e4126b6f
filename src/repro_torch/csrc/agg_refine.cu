// agg_refine_attention: stage-2 exact re-attention over the selected KV
// buckets of a bucket-major cache, as a partial-softmax triple.
//
// Replaces the TPU kernel src/repro/kernels/agg_refine.py:
// agg_refine_attention_pallas (pallas_call at line 132, body _kernel at 29).
// There the grid (B, R) walks each sequence's R selected buckets in order on
// one core: scalar prefetch brings top_idx, the index map DMAs the selected
// bucket's [C, Hkv, dk] slot rows into VMEM, and the (m, l, acc) triple
// carries across the R steps in VMEM scratch.
//
// What bounds it here: bytes.  It reads the live rows of the selected
// buckets, at most B R C Hkv (dk + dv) values of the cache type; at the
// qwen3-8b decode shapes (B 4, R 16, C 32, Hkv 8, d 128, bf16) 8.4 MB, 2.5
// us at 3.35 TB/s, and does 2 G (dk + dv) operations per row read.  With so
// little work the launch and the latency of one block's loads set its time.
//
// Design.  One warp per (selection slot r, KV head, sequence): the B Hkv
// (sequence, KV head) pairs alone would leave most of the 132 SMs idle, so R
// is split across blocks.  The warp loads its own top_idx[b, r], use[b, r]
// and counts[b, idx], and streams that bucket's live rows (row c < min(count,
// C), count > 0, use != 0; row c of a bucket lies at stride Hkv dk in its
// slot tensor) straight from the [B, K, C, Hkv, d] slot tensor: no [B, R, C,
// ...] gather exists.  The G query heads of the KV head are done together,
// so each K/V row is read once for the group (decode_attn.cuh).  Every
// selection slot counts on its own, duplicates included, as in the
// reference.  A second kernel merges the R partial triples of each
// (sequence, KV head) in slot order, so the result is the same bits on
// every run.  A fully masked selection gives (NEG, 0, 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

template <typename T, int DVL>
__global__ void __launch_bounds__(32)
agg_refine_part_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_slots,
                       const T* __restrict__ v_slots,
                       const int* __restrict__ counts,
                       const int* __restrict__ top_idx,
                       const unsigned char* __restrict__ use, int kb, int cap,
                       int hkv, int g, int dk, int dv, int r_sel, float scale,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc) {
  extern __shared__ float q_s[];  // [g][dk]
  const int r = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x;
  stage_queries(q + static_cast<size_t>(b * hkv + kvh) * g * dk, q_s, g * dk);

  const int sel = b * r_sel + r;
  const int idx = min(max(top_idx[sel], 0), kb - 1);
  const int cnt = counts[static_cast<size_t>(b) * kb + idx];
  const int n_live = (use[sel] != 0 && cnt > 0) ? min(cnt, cap) : 0;

  const size_t bucket = (static_cast<size_t>(b) * kb + idx) * cap;
  const size_t kstride = static_cast<size_t>(hkv) * dk;
  const size_t vstride = static_cast<size_t>(hkv) * dv;
  const T* kbase = k_slots + bucket * kstride + static_cast<size_t>(kvh) * dk;
  const T* vbase = v_slots + bucket * vstride + static_cast<size_t>(kvh) * dv;

  Partial<DVL> st;
  st.init();
  for (int c0 = 0; c0 < n_live; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < n_live;
    float logit[kMaxG];
    if (live) {
      row_dots(kbase + c * kstride, q_s, dk, g, logit);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) logit[gi] *= scale;
    } else {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) logit[gi] = kNeg;
    }
    st.absorb(live, logit, g, vbase + c0 * vstride, vstride, dv, lane);
  }
  st.store(part_m, part_l, part_acc,
           (static_cast<size_t>(b * hkv + kvh) * r_sel + r) * g, g, dv, lane);
}

struct Args {
  const void *q, *k_slots, *v_slots, *counts, *top_idx, *use;
  int b, kb, cap, hkv, g, dk, dv, r_sel;
  float scale;
  void *part_m, *part_l, *part_acc, *out_m, *out_l, *out_acc;
};

template <typename T, int DVL>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.r_sel, a.hkv, a.b);
  const size_t smem = static_cast<size_t>(a.g) * a.dk * sizeof(float);
  agg_refine_part_kernel<T, DVL><<<grid, 32, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k_slots),
      static_cast<const T*>(a.v_slots), static_cast<const int*>(a.counts),
      static_cast<const int*>(a.top_idx),
      static_cast<const unsigned char*>(a.use), a.kb, a.cap, a.hkv, a.g,
      a.dk, a.dv, a.r_sel, a.scale, static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc));
  merge_parts_kernel<DVL><<<a.b * a.hkv * a.g, 32, 0, stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), a.r_sel, a.g, a.dv, false,
      static_cast<float*>(a.out_m), static_cast<float*>(a.out_l),
      static_cast<float*>(a.out_acc));
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

// q: [b, hkv, g, dk] f32; k_slots/v_slots: [b, kb, cap, hkv, dk|dv] of bf16
// (bf16 != 0) or f32; counts: [b, kb] int32; top_idx: [b, r_sel] int32
// (clipped to [0, kb)); use: [b, r_sel] bytes.  part_*: [b, hkv, r_sel, g]
// (acc: x dv) f32 scratch; out_m, out_l: [b, hkv, g], out_acc: [b, hkv, g,
// dv] f32.  g <= 8, dv <= 256, dk a multiple of 16 bytes' worth of the cache
// type, every pointer 16-byte aligned.  Returns cudaGetLastError().
extern "C" int agg_refine_attention(const void* q, const void* k_slots,
                                    const void* v_slots, const void* counts,
                                    const void* top_idx, const void* use,
                                    int bf16, int b, int kb, int cap, int hkv,
                                    int g, int dk, int dv, int r_sel,
                                    float scale, void* part_m, void* part_l,
                                    void* part_acc, void* out_m, void* out_l,
                                    void* out_acc, void* stream) {
  const Args a{q, k_slots, v_slots, counts, top_idx, use, b, kb, cap, hkv,
               g, dk, dv, r_sel, scale, part_m, part_l, part_acc, out_m,
               out_l, out_acc};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dispatch<__nv_bfloat16>(a, st);
  } else {
    dispatch<float>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
