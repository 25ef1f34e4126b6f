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
// What bounds it here: latency.  It reads the live rows of the selected
// buckets, at most B R C Hkv (dk + dv) values of the cache type, and does
// 2 G (dk + dv) operations per row; at the qwen3-8b decode shapes (B 4, R
// up to 64, C 32, Hkv 8, d 128, bf16, 160 tokens written) the live rows
// are at most 2.7 MB, under 0.9 us at 3.35 TB/s.  The launch and the chain
// of dependent steps (top_idx, the counts, the rows, the reductions, the
// merges) set its time.
//
// Design (decode_attn.cuh).  One launch: a cluster of eight blocks of four
// warps per (sequence, KV head, head tile, value tile), so the batch's few
// pairs still spread over the SMs; MLA's 128 heads of 512 values take 32
// tiles.  Selection slot u goes to the cluster's warp unit u mod 32, so a
// warp owns slots unit, unit + 32, ...; it loads their top_idx and use (a
// lane a slot) while the block stages q and the sequence's counts in
// shared memory, then lists the slots' live rows (row c < min(count, C),
// count > 0, use != 0) end to end: chunks of them, whatever slot they come
// from, are copied with cp.async straight from the [B, K, C, Hkv, d] slot
// tensor (no [B, R, C, ...] gather exists) and folded for the G query heads
// together, so each K/V row is read once for the group.  Every selection
// slot counts on its own, duplicates included, as in the reference.  The
// warps' partials meet in warp order in the block and in rank order across
// the cluster, one eighth of the values in each block: the same bits on
// every run, and no partial in device memory.  A fully masked selection
// gives (NEG, 0, 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

// Where the parts of a block's shared memory start, in bytes: the g query
// rows; each warp's region (its chunk of rows, which holds the warp's
// partial slot once it is done; the chunk's row ids); the gather area;
// the merge weights; the sequence's bucket counts.
template <typename T>
struct RefineLayout {
  int q_bytes, warp_bytes, ids_at, gather, wts, cnt, total;
  __host__ __device__ RefineLayout(const Rows<T>& rs, int g, int gm, int dk,
                                   int dv, int rows, int kb) {
    q_bytes = align16(gm * dk * 4);
    const int chunk = align16(rows * rs.bytes());
    ids_at = chunk > slot_bytes(g, dv) ? chunk : slot_bytes(g, dv);
    warp_bytes = ids_at + kRows * 8;
    gather = q_bytes + kWarps * warp_bytes;
    wts = gather + gather_bytes(g, dv);
    cnt = wts + weight_bytes(g);
    total = cnt + align16(kb * 4);
  }
};

// A warp's group of up to 32 selection slots, one per lane: the clipped
// bucket index and whether the slot is used (loaded from device memory),
// then the slot's live rows, the live rows before the slot's in the group
// and the group's live rows in all (from the counts in shared memory).
struct SlotGroup {
  int idx;
  bool on;
  int n_live;
  int excl;
  int total;
};

__device__ __forceinline__ SlotGroup load_slots(
    const int* __restrict__ top_idx, const unsigned char* __restrict__ use,
    int b, int kb, int r_sel, int unit, int n_mine, int j0, int lane) {
  const int j = j0 + lane;
  SlotGroup sg{0, false, 0, 0, 0};
  if (j < n_mine) {
    const size_t sel = static_cast<size_t>(b) * r_sel + j * kUnits + unit;
    sg.idx = min(max(top_idx[sel], 0), kb - 1);
    sg.on = use[sel] != 0;
  }
  return sg;
}

__device__ __forceinline__ void count_slots(SlotGroup& sg, const int* cnt_s,
                                            int cap, int lane) {
  const int cnt = sg.on ? cnt_s[sg.idx] : 0;
  const int n_live = cnt > 0 ? min(cnt, cap) : 0;
  int incl = n_live;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  sg.n_live = n_live;
  sg.excl = incl - n_live;
  sg.total = __shfl_sync(kFull, incl, 31);
}

template <typename T, int P, int GM>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, min_blocks<GM, P>())
agg_refine_kernel(const float* __restrict__ q, const T* __restrict__ k_slots,
                  const T* __restrict__ v_slots,
                  const int* __restrict__ counts,
                  const int* __restrict__ top_idx,
                  const unsigned char* __restrict__ use, int kb, int cap,
                  int hkv, int g, int dk, int dv, int r_sel, int rows,
                  float scale, float* __restrict__ out_m,
                  float* __restrict__ out_l, float* __restrict__ out_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Tile tl(blockIdx.y, g, dv);
  const int kvh = tl.kvh;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Rows<T> rs(dk, tl.dv);
  const RefineLayout<T> lay(rs, tl.g, GM, dk, tl.dv, rows, kb);
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* mine = smem + lay.q_bytes + warp * lay.warp_bytes;
  T* ks = reinterpret_cast<T*>(mine);
  T* vs = ks + rows * rs.kst;
  long long* rid_s = reinterpret_cast<long long*>(mine + lay.ids_at);
  float* gather = reinterpret_cast<float*>(smem + lay.gather);
  float* wts = reinterpret_cast<float*>(smem + lay.wts);
  int* cnt_s = reinterpret_cast<int*>(smem + lay.cnt);
  const size_t bh = static_cast<size_t>(b) * hkv + kvh;

  cluster_arrive();
  // the queries and the sequence's counts by the whole block, while each
  // warp loads its first slots' indices
  stage_queries(q + (bh * g + tl.g0) * dk, q_s, tl.g, GM, dk);
  for (int i = threadIdx.x; i < kb; i += kThreads) {
    cnt_s[i] = counts[static_cast<size_t>(b) * kb + i];
  }
  const int unit = warp * kCluster + rank;
  const int n_mine = unit < r_sel ? (r_sel - unit + kUnits - 1) / kUnits : 0;
  SlotGroup sg = load_slots(top_idx, use, b, kb, r_sel, unit, n_mine, 0, lane);
  cp_async_wait_all();
  __syncthreads();
  count_slots(sg, cnt_s, cap, lane);

  Partial<T, P, GM> st;
  st.init();
  for (int j0 = 0;;) {
    for (int c0 = 0; c0 < sg.total; c0 += rows) {
      const int n = min(rows, sg.total - c0);
      // each lane lists its slot's rows that fall in the chunk
      const long long base =
          ((static_cast<long long>(b) * kb + sg.idx) * cap) * hkv + kvh;
      const int c_hi = min(sg.n_live, c0 + n - sg.excl);
      for (int c = max(c0 - sg.excl, 0); c < c_hi; ++c) {
        rid_s[sg.excl + c - c0] = base + static_cast<long long>(c) * hkv;
      }
      __syncwarp();
      stage_rows(ks, vs, rs, k_slots, v_slots + tl.v0, dk, dv, rid_s, n,
                 lane);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      st.absorb(ks, vs, rs, n, nullptr, q_s, dk, scale, lane);
      __syncwarp();
    }
    j0 += 32;
    if (j0 >= n_mine) break;
    sg = load_slots(top_idx, use, b, kb, r_sel, unit, n_mine, j0, lane);
    count_slots(sg, cnt_s, cap, lane);
  }
  st.store(reinterpret_cast<float*>(mine), rs, tl.g, tl.dv, lane);
  __syncthreads();
  cluster_wait();
  merge_block(cluster, rank,
              reinterpret_cast<const float*>(smem + lay.q_bytes),
              lay.warp_bytes / 4, gather, wts, tl.g, tl.dv);
  cluster.sync();
  const size_t o = bh * g + tl.g0;
  merge_cluster(
      rank, gather, wts + kWarps * tl.g, wts + (kWarps + kCluster) * tl.g,
      tl.g, tl.dv,
      [=](int gi, float m, float l) {
        if (tl.v0 == 0) {
          out_m[o + gi] = m;
          out_l[o + gi] = l;
        }
      },
      [=](int e4, float4 a, float) {
        const int gi = e4 * 4 / tl.dv;
        const int c = e4 * 4 - gi * tl.dv;
        *reinterpret_cast<float4*>(out_acc + (o + gi) * dv + tl.v0 + c) = a;
      });
}

struct Args {
  const void *q, *k_slots, *v_slots, *counts, *top_idx, *use;
  int b, kb, cap, hkv, g, dk, dv, r_sel, rows;
  float scale;
  void *out_m, *out_l, *out_acc;
};

template <typename T, int P, int GM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static size_t smem_set = 0;
  // the first tile is the largest: its layout sizes every block's
  const int gt = a.g < kMaxG ? a.g : kMaxG;
  const int dvt = a.dv < kValueTile ? a.dv : kValueTile;
  const Rows<T> rs(a.dk, dvt);
  const RefineLayout<T> lay(rs, gt, GM, a.dk, dvt, a.rows, a.kb);
  const cudaError_t err =
      allow_smem(agg_refine_kernel<T, P, GM>, lay.total, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(kCluster, grid_y(a.hkv, a.g, a.dv), a.b);
  agg_refine_kernel<T, P, GM><<<grid, kThreads, lay.total, stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k_slots),
      static_cast<const T*>(a.v_slots), static_cast<const int*>(a.counts),
      static_cast<const int*>(a.top_idx),
      static_cast<const unsigned char*>(a.use), a.kb, a.cap, a.hkv, a.g,
      a.dk, a.dv, a.r_sel, a.rows, a.scale, static_cast<float*>(a.out_m),
      static_cast<float*>(a.out_l), static_cast<float*>(a.out_acc));
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  return a.g <= 4 ? launch<T, P, 4>(a, stream)
                  : launch<T, P, kMaxG>(a, stream);
}

}  // namespace

// q: [b, hkv, g, dk] f32; k_slots/v_slots: [b, kb, cap, hkv, dk|dv] of bf16
// (bf16 != 0) or f32; counts: [b, kb] int32; top_idx: [b, r_sel] int32
// (clipped to [0, kb)); use: [b, r_sel] bytes.  out_m, out_l: [b, hkv, g],
// out_acc: [b, hkv, g, dv] f32.  rows: rows of a warp's chunk, 1 to 32.
// Any g and dv (tiles of kMaxG heads and kValueTile columns, Tile); dk and
// dv multiples of 16 bytes' worth of the cache type, every pointer 16-byte
// aligned, the shared memory of a tile within a block's.  One launch;
// returns its error.
extern "C" int agg_refine_attention(const void* q, const void* k_slots,
                                    const void* v_slots, const void* counts,
                                    const void* top_idx, const void* use,
                                    int bf16, int b, int kb, int cap, int hkv,
                                    int g, int dk, int dv, int r_sel,
                                    int rows, float scale, void* out_m,
                                    void* out_l, void* out_acc,
                                    void* stream) {
  const Args a{q,  k_slots, v_slots, counts, top_idx, use,   b,     kb,
               cap, hkv,    g,       dk,     dv,      r_sel, rows,  scale,
               out_m, out_l, out_acc};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = dispatch<__nv_bfloat16, 1>(a, st);
  } else if (dv > 128) {
    err = dispatch<float, 2>(a, st);
  } else {
    err = dispatch<float, 1>(a, st);
  }
  return static_cast<int>(err);
}
