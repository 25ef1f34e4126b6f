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
// What bounds it here: latency.  The flat layout keeps tokens in insertion
// order, so the refined tokens lie anywhere below valid_len.  It must read
// bucket_of below valid_len, the centroid tables and the K/V rows of the
// refined tokens: at the qwen3-8b decode shapes (B 4, S 1024, Hkv 8, d 128,
// bf16, 160 tokens written) under 2.8 MB, under 0.9 us at 3.35 TB/s, at
// 2 G (dk + dv) operations per row.  The launch and the chain of dependent
// steps (valid_len, bucket_of, the rows, the reductions, the merges) set
// its time.
//
// Design (decode_attn.cuh).  One launch for the batch: a cluster of eight
// blocks of four warps per (sequence, KV head, head tile, value tile).  The
// live masks are computed in the kernel from bucket_of, refined, counts and
// valid_len[b]: no bias vector exists, and a masked token's K/V row is
// never read.  The first
// three warps of every block split the written tokens [0, valid_len[b])
// into equal spans on the card (24 a cluster), the last warp of every
// block the K centroids (8 a cluster), so the two passes run side by side.
// A token warp loads the buckets of its first 32 tokens while the block
// stages q and the sequence's counts and refined flags in shared memory;
// each warp then lists its live rows (a token whose bucket is refined; an
// unrefined, non-empty centroid, with bias log(max(count, 1))), copies them
// with cp.async in chunks, all of a chunk's copies in flight together, and
// folds them into its partial.  The partials meet in warp order in the
// block (token warps first, then the centroid warp) and in rank order
// across the cluster, one eighth of the values in each block, which writes
// acc / max(l, 1e-30): the same bits on every run.  A masked logit never
// enters a sum, and the all-empty cache gives exact zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

// The cluster's warps by role: the last warp of every block takes
// centroids (unit: the block's rank), the others tokens.
constexpr int kTokUnits = kCluster * (kWarps - 1);
constexpr int kCenUnits = kCluster;

// Where the parts of a block's shared memory start, in bytes: the g query
// rows; each warp's region (its chunk of token or centroid rows, which
// holds its partial slot once it is done; the live rows' ids and biases of
// its current window); the gather area; the merge weights; the
// sequence's bucket counts and refined flags.
template <typename T>
struct FlatLayout {
  int q_bytes, warp_bytes, ids_at, gather, wts, cnt, ref, total;
  __host__ __device__ FlatLayout(const Rows<T>& rt, const Rows<float>& rc,
                                 int g, int gm, int dk, int dv, int tok_rows,
                                 int cen_rows, int kb) {
    q_bytes = align16(gm * dk * 4);
    int rows = align16(tok_rows * rt.bytes());
    const int cen = align16(cen_rows * rc.bytes());
    rows = rows > cen ? rows : cen;
    ids_at = rows > slot_bytes(g, dv) ? rows : slot_bytes(g, dv);
    warp_bytes = ids_at + kRows * (8 + 4);
    gather = q_bytes + kWarps * warp_bytes;
    wts = gather + gather_bytes(g, dv);
    cnt = wts + weight_bytes(g);
    ref = cnt + align16(kb * 4);
    total = ref + align16(kb);
  }
};

// The bucket of lane i's token t0 + i of a warp's span [.., t_hi), or -1.
__device__ __forceinline__ int token_bucket(const int* __restrict__ bucket_of,
                                            int b, int s, int kb, int t0,
                                            int t_hi, int lane) {
  const int t = t0 + lane;
  return t < t_hi
             ? min(max(bucket_of[static_cast<size_t>(b) * s + t], 0), kb - 1)
             : -1;
}

// Lane i's token t0 + i, in bucket bk (-1: none), is live when its bucket
// is refined (ref_s: the sequence's flags in shared memory).  Writes the
// live tokens' row ids to rid_s in token order and returns how many there
// are.
__device__ __forceinline__ int token_window(int bk, const unsigned char* ref_s,
                                            int b, int s, int hkv, int kvh,
                                            int t0, long long* rid_s,
                                            int lane) {
  const int t = t0 + lane;
  const bool live = bk >= 0 && ref_s[bk] != 0;
  const unsigned mask = __ballot_sync(kFull, live);
  if (live) {
    rid_s[__popc(mask & ((1u << lane) - 1))] =
        (static_cast<long long>(b) * s + t) * hkv + kvh;
  }
  __syncwarp();
  return __popc(mask);
}

// Lane i's centroid c0 + i of a warp's span [.., c_hi): live when its bucket
// is not refined and not empty (cnt_s, ref_s: the sequence's counts and
// flags in shared memory).  Writes the live centroids' row ids and biases
// log(max(count, 1)) in bucket order and returns how many there are.
__device__ __forceinline__ int centroid_window(
    const int* cnt_s, const unsigned char* ref_s, int b, int kb, int hkv,
    int kvh, int c0, int c_hi, long long* rid_s, float* bias_s, int lane) {
  const int c = c0 + lane;
  bool live = false;
  int cnt = 0;
  if (c < c_hi) {
    cnt = cnt_s[c];
    live = ref_s[c] == 0 && cnt > 0;
  }
  const unsigned mask = __ballot_sync(kFull, live);
  if (live) {
    const int at = __popc(mask & ((1u << lane) - 1));
    rid_s[at] = (static_cast<long long>(b) * kb + c) * hkv + kvh;
    bias_s[at] = logf(fmaxf(static_cast<float>(cnt), 1.f));
  }
  __syncwarp();
  return __popc(mask);
}

// Fold a warp's span [lo, hi) into st, window by window (32 candidates,
// a lane each; window(w0) loads the window at w0, writes its live rows'
// ids (and biases) and returns how many are live), `rows` live rows at a
// time; the caller has resolved the first window (n_live of it live), and
// each chunk's row copies are all in flight before its first FMA.
template <typename T, int P, int GM, typename Window>
__device__ __forceinline__ void fold_span(
    Partial<T, P, GM>& st, int n_live, int lo, int hi, Window window,
    int rows, T* ks, T* vs, const Rows<T>& rs, const T* __restrict__ kg,
    const T* __restrict__ vg, const long long* rid_s, const float* bias_s,
    const float* q_s, int dk, int dv, float scale, int lane) {
  for (int w0 = lo;;) {
    for (int done = 0; done < n_live; done += rows) {
      const int n = min(rows, n_live - done);
      stage_rows(ks, vs, rs, kg, vg, dk, dv, rid_s + done, n, lane);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      st.absorb(ks, vs, rs, n, bias_s != nullptr ? bias_s + done : nullptr,
                q_s, dk, scale, lane);
      __syncwarp();
    }
    w0 += 32;
    if (w0 >= hi) break;
    n_live = window(w0);
  }
}

template <typename T, int PT, int PC, int GM>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, min_blocks<GM, (PT > PC ? PT : PC)>())
aggregated_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ bucket_of,
    const float* __restrict__ mean_k, const float* __restrict__ mean_v,
    const int* __restrict__ counts, const unsigned char* __restrict__ refined,
    const int* __restrict__ valid_len, int s, int kb, int hkv, int g, int dk,
    int dv, int tok_rows, int cen_rows, float scale,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Tile tl(blockIdx.y, g, dv);
  const int kvh = tl.kvh;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Rows<T> rt(dk, tl.dv);
  const Rows<float> rc(dk, tl.dv);
  const FlatLayout<T> lay(rt, rc, tl.g, GM, dk, tl.dv, tok_rows, cen_rows,
                          kb);
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* mine = smem + lay.q_bytes + warp * lay.warp_bytes;
  long long* rid_s = reinterpret_cast<long long*>(mine + lay.ids_at);
  float* bias_s = reinterpret_cast<float*>(rid_s + kRows);
  float* gather = reinterpret_cast<float*>(smem + lay.gather);
  float* wts = reinterpret_cast<float*>(smem + lay.wts);
  int* cnt_s = reinterpret_cast<int*>(smem + lay.cnt);
  unsigned char* ref_s = smem + lay.ref;
  const size_t bh = static_cast<size_t>(b) * hkv + kvh;

  cluster_arrive();
  // the queries, the sequence's counts and refined flags by the whole block,
  // while each token warp loads the buckets of its first window: the last
  // warp of a block takes centroids (the unrefined, non-empty buckets), the
  // others tokens below valid_len in the refined buckets
  stage_queries(q + (bh * g + tl.g0) * dk, q_s, tl.g, GM, dk);
  for (int i = threadIdx.x; i < kb; i += kThreads) {
    cnt_s[i] = counts[static_cast<size_t>(b) * kb + i];
    ref_s[i] = refined[static_cast<size_t>(b) * kb + i];
  }
  const bool cen = warp == kWarps - 1;
  int lo, hi;
  if (cen) {
    const int span = (kb + kCenUnits - 1) / kCenUnits;
    lo = min(rank * span, kb);
    hi = min(lo + span, kb);
  } else {
    const int vl = min(max(valid_len[b], 0), s);
    const int span = (vl + kTokUnits - 1) / kTokUnits;
    lo = min((warp * kCluster + rank) * span, vl);
    hi = min(lo + span, vl);
  }
  auto cen_window = [=](int c0) {
    return centroid_window(cnt_s, ref_s, b, kb, hkv, kvh, c0, hi, rid_s,
                           bias_s, lane);
  };
  auto tok_window = [=](int t0) {
    return token_window(token_bucket(bucket_of, b, s, kb, t0, hi, lane), ref_s,
                        b, s, hkv, kvh, t0, rid_s, lane);
  };
  const int bk = cen ? -1 : token_bucket(bucket_of, b, s, kb, lo, hi, lane);
  cp_async_wait_all();
  __syncthreads();
  const int n_live = cen ? cen_window(lo)
                         : token_window(bk, ref_s, b, s, hkv, kvh, lo, rid_s,
                                        lane);

  if (cen) {
    Partial<float, PC, GM> st;
    st.init();
    float* ks = reinterpret_cast<float*>(mine);
    fold_span(st, n_live, lo, hi, cen_window, cen_rows, ks,
              ks + cen_rows * rc.kst, rc, mean_k, mean_v + tl.v0, rid_s,
              static_cast<const float*>(bias_s), q_s, dk, dv, scale, lane);
    st.store(reinterpret_cast<float*>(mine), rc, tl.g, tl.dv, lane);
  } else {
    Partial<T, PT, GM> st;
    st.init();
    T* ks = reinterpret_cast<T*>(mine);
    fold_span(st, n_live, lo, hi, tok_window, tok_rows, ks,
              ks + tok_rows * rt.kst, rt, k_cache, v_cache + tl.v0, rid_s,
              static_cast<const float*>(nullptr), q_s, dk, dv, scale, lane);
    st.store(reinterpret_cast<float*>(mine), rt, tl.g, tl.dv, lane);
  }
  __syncthreads();
  cluster_wait();
  merge_block(cluster, rank,
              reinterpret_cast<const float*>(smem + lay.q_bytes),
              lay.warp_bytes / 4, gather, wts, tl.g, tl.dv);
  cluster.sync();
  float* o = out + (bh * g + tl.g0) * dv + tl.v0;
  merge_cluster(
      rank, gather, wts + kWarps * tl.g, wts + (kWarps + kCluster) * tl.g,
      tl.g, tl.dv, [](int, float, float) {},
      [=](int e4, float4 a, float l) {
        const float den = fmaxf(l, 1e-30f);
        const int gi = e4 * 4 / tl.dv;
        const int c = e4 * 4 - gi * tl.dv;
        *reinterpret_cast<float4*>(o + gi * dv + c) =
            make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
      });
}

struct Args {
  const void *q, *k_cache, *v_cache, *bucket_of, *mean_k, *mean_v, *counts,
      *refined, *valid_len;
  int b, s, kb, hkv, g, dk, dv, tok_rows, cen_rows;
  float scale;
  void* out;
};

template <typename T, int PT, int PC, int GM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static size_t smem_set = 0;
  // the first tile is the largest: its layout sizes every block's
  const int gt = a.g < kMaxG ? a.g : kMaxG;
  const int dvt = a.dv < kValueTile ? a.dv : kValueTile;
  const Rows<T> rt(a.dk, dvt);
  const Rows<float> rc(a.dk, dvt);
  const FlatLayout<T> lay(rt, rc, gt, GM, a.dk, dvt, a.tok_rows,
                          a.cen_rows, a.kb);
  const cudaError_t err = allow_smem(
      aggregated_attention_kernel<T, PT, PC, GM>, lay.total, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(kCluster, grid_y(a.hkv, a.g, a.dv), a.b);
  aggregated_attention_kernel<T, PT, PC, GM><<<grid, kThreads, lay.total,
                                               stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k_cache),
      static_cast<const T*>(a.v_cache), static_cast<const int*>(a.bucket_of),
      static_cast<const float*>(a.mean_k), static_cast<const float*>(a.mean_v),
      static_cast<const int*>(a.counts),
      static_cast<const unsigned char*>(a.refined),
      static_cast<const int*>(a.valid_len), a.s, a.kb, a.hkv, a.g, a.dk, a.dv,
      a.tok_rows, a.cen_rows, a.scale, static_cast<float*>(a.out));
  return cudaGetLastError();
}

template <typename T, int PT, int PC>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  return a.g <= 4 ? launch<T, PT, PC, 4>(a, stream)
                  : launch<T, PT, PC, kMaxG>(a, stream);
}

}  // namespace

// q: [b, hkv * g, dk] f32; k_cache/v_cache: [b, s, hkv, dk|dv] of bf16
// (bf16 != 0) or f32; bucket_of: [b, s] int32 (clipped to [0, kb));
// mean_k/mean_v: [b, kb, hkv, dk|dv] f32; counts: [b, kb] int32; refined:
// [b, kb] bytes; valid_len: [b] int32.  out: [b, hkv * g, dv] f32.
// tok_rows, cen_rows: rows of a warp's token and centroid chunks, 1 to 32.
// Any g and dv (tiles of kMaxG heads and kValueTile columns, Tile); dk and
// dv multiples of 16 bytes' worth of the cache type, every pointer 16-byte
// aligned, the shared memory of a tile within a block's.  One launch;
// returns its error.
extern "C" int aggregated_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* bucket_of, const void* mean_k, const void* mean_v,
    const void* counts, const void* refined, const void* valid_len, int bf16,
    int b, int s, int kb, int hkv, int g, int dk, int dv, int tok_rows,
    int cen_rows, float scale, void* out, void* stream) {
  const Args a{q,  k_cache, v_cache, bucket_of, mean_k,   mean_v,
               counts, refined, valid_len, b,   s,        kb,
               hkv, g,  dk,      dv,        tok_rows, cen_rows,
               scale, out};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // a lane's 16-byte pieces of a value tile's row: two for an f32 row
  // past 128 values
  if (bf16) {
    err = dv > 128 ? dispatch<__nv_bfloat16, 1, 2>(a, st)
                   : dispatch<__nv_bfloat16, 1, 1>(a, st);
  } else {
    err = dv > 128 ? dispatch<float, 2, 2>(a, st)
                   : dispatch<float, 1, 1>(a, st);
  }
  return static_cast<int>(err);
}
