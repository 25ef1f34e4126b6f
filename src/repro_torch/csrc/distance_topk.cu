// distance_topk: fused squared-L2 (or negated dot) scoring + k-best, in two
// regimes.
//
// Replaces the TPU kernel src/repro/kernels/distance_topk.py:
// distance_topk_pallas (pallas_call at line 84).  There the point axis runs
// in order on one core and a [TQ, k] running best is carried in VMEM scratch
// from grid step to grid step; the [Q, N] score matrix never reaches HBM.
// Invalid points never enter a selection; empty slots are (BIG, label 0),
// as the Pallas kernel's padding is; ties go to the lowest column, as
// jax.lax.top_k breaks them.
//
// Batched regime (N <= kSmallMaxN): B independent selections of [Q, D]
// queries against [N, D] points, as jax.vmap of the reference gives them
// (the LM's stage-1 bucket selection: B sequences, Q 1, N = K = 64
// buckets, D 1024, k up to 64).  What bounds it: latency and launches, not
// FLOPs (0.5 MFLOP on 1 MB).  One launch for all B: a cluster of eight
// blocks per (batch item, query row), so that B = 4 sequences read their
// centroids through 32 SMs and not 4; a warp per point, lanes over D with
// 16-byte loads where rows allow it, a shuffle tree per dot product.  The
// (score, column) keys go to the first block's shared memory (Hopper's
// distributed shared memory), and after a cluster barrier that block sorts
// up to N keys (bitonic), so any k <= N comes out of one launch.
//
// Wide regime (N > kSmallMaxN): what bounds it is operations: 2 Q N D FMAs
// on O((Q + N) D) bytes; at the kNN shapes (Q = 1024, N = 287,500,
// D = 217) 128 GFLOP on 250 MB.  Blocks run in parallel and in no order,
// so the TPU's carry across grid steps becomes a loop inside the block, and
// the grid is split over (128-query tile) x (point chunk) so that 1024
// queries fill the 132 SMs.  Each block walks its chunk in 128-point tiles
// (fp32_tile.cuh: cp.async stages, 8 x 8 outputs a thread).  The 64 sums
// of a thread leave no room for per-row lists in registers, so each row's
// k-best sits in shared memory and its k-th entry is the threshold: a
// tile's scores are compared with it, and only a row with survivors is
// updated, by its half warp: one survivor at a time when there are at most
// k of them, which is the rule after the first tiles, else in k rounds of
// a 16-lane argmin over [list | survivors].  A second pass
// (the candidate_topk row merge) folds the chunks' partial lists; chunks
// are laid out in column order, so the lowest-index tie rule survives.
#include <climits>
#include <math.h>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fp32_tile.cuh"
#include "kbest.cuh"

namespace cg = cooperative_groups;

constexpr int kSmallMaxN = 1024;
constexpr int kCluster = 8;        // blocks scoring one query row together
constexpr int kSmallThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One cluster of kCluster blocks per (batch item, query row): each warp
// scores points rank * 8 + warp, + 64, ... into the keys of the cluster's
// first block (distributed shared memory), and that block sorts them.
template <bool DOT, bool VEC>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kSmallThreads)
distance_topk_small_kernel(const float* __restrict__ q,
                           const float* __restrict__ p,
                           const int* __restrict__ labels,
                           const unsigned char* __restrict__ valid, int nq,
                           int n, int dim, int k, int label_stride,
                           int valid_stride, int pow2,
                           float* __restrict__ out_d,
                           int* __restrict__ out_l) {
  __shared__ float sd[kSmallMaxN];
  __shared__ int sc[kSmallMaxN];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / kCluster;  // batch item * nq + query
  const int b = row / nq;
  const float* qr = q + static_cast<size_t>(row) * dim;
  const float* pb = p + static_cast<size_t>(b) * n * dim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kWarps = kSmallThreads / 32;
  float* keys_d = cluster.map_shared_rank(&sd[0], 0);
  int* keys_c = cluster.map_shared_rank(&sc[0], 0);

  float qq = 0.f;
  if (!DOT) {
    if (VEC) {
      const float4* q4 = reinterpret_cast<const float4*>(qr);
      for (int c = lane; c < dim / 4; c += 32) {
        const float4 v = q4[c];
        qq = fmaf(v.x, v.x, qq);
        qq = fmaf(v.y, v.y, qq);
        qq = fmaf(v.z, v.z, qq);
        qq = fmaf(v.w, v.w, qq);
      }
    } else {
      for (int c = lane; c < dim; c += 32) qq = fmaf(qr[c], qr[c], qq);
    }
    qq = warp_sum(qq);
  }

  for (int col = rank * kWarps + warp; col < n; col += kCluster * kWarps) {
    const float* pr = pb + static_cast<size_t>(col) * dim;
    float qp = 0.f;
    float pp = 0.f;
    if (VEC) {
      const float4* q4 = reinterpret_cast<const float4*>(qr);
      const float4* p4 = reinterpret_cast<const float4*>(pr);
#pragma unroll 8
      for (int c = lane; c < dim / 4; c += 32) {
        const float4 a = q4[c];
        const float4 v = p4[c];
        qp = fmaf(a.x, v.x, qp);
        qp = fmaf(a.y, v.y, qp);
        qp = fmaf(a.z, v.z, qp);
        qp = fmaf(a.w, v.w, qp);
        if (!DOT) {
          pp = fmaf(v.x, v.x, pp);
          pp = fmaf(v.y, v.y, pp);
          pp = fmaf(v.z, v.z, pp);
          pp = fmaf(v.w, v.w, pp);
        }
      }
    } else {
#pragma unroll 8
      for (int c = lane; c < dim; c += 32) {
        const float v = pr[c];
        qp = fmaf(qr[c], v, qp);
        if (!DOT) pp = fmaf(v, v, pp);
      }
    }
    qp = warp_sum(qp);
    if (!DOT) pp = warp_sum(pp);
    if (lane == 0) {
      const bool ok = valid == nullptr ||
                      valid[static_cast<size_t>(b) * valid_stride + col] != 0;
      // a masked point is (inf, INT_MAX): after every point
      keys_d[col] = !ok ? INFINITY
                        : (DOT ? -qp : fmaxf(qq - 2.f * qp + pp, 0.f));
      keys_c[col] = ok ? col : INT_MAX;
    }
  }
  cluster.sync();  // every key is in the first block
  if (rank != 0) return;
  for (int i = n + threadIdx.x; i < pow2; i += kSmallThreads) {
    sd[i] = INFINITY;
    sc[i] = INT_MAX;
  }
  __syncthreads();

  // Bitonic sort of the pow2 keys, ascending by (score, column).
  for (int size = 2; size <= pow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < pow2 / 2; t += kSmallThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const float di = sd[i], dj = sd[j];
        const int ci = sc[i], cj = sc[j];
        if (up ? kb_less(dj, cj, di, ci) : kb_less(di, ci, dj, cj)) {
          sd[i] = dj;
          sc[i] = cj;
          sd[j] = di;
          sc[j] = ci;
        }
      }
      __syncthreads();
    }
  }

  const size_t out0 = static_cast<size_t>(row) * k;
  for (int t = threadIdx.x; t < k; t += kSmallThreads) {
    float d = REPRO_BIG;
    int l = 0;
    if (t < n && sc[t] != INT_MAX) {
      d = sd[t];
      l = labels[static_cast<size_t>(b) * label_stride + sc[t]];
    }
    out_d[out0 + t] = d;
    out_l[out0 + t] = l;
  }
}

// A tile's score of a point, from its product and the norms.
template <bool DOT>
__device__ __forceinline__ float tile_score(float prod, float qn, float pn) {
  return DOT ? -prod : fmaxf(qn - 2.f * prod + pn, 0.f);
}

// A row's k-best list in shared memory holds its real entries first,
// sorted by (score, column), then its padding entries (BIG, -1 - slot),
// which are not in (score, column) order among themselves.  Every real
// score is below BIG, so every real entry precedes the padding, and entry
// k - 1 is the row's threshold: its largest entry once k real ones are in,
// before that a padding entry that every real score beats.  Both updates
// below keep this.

// Merge a row's k-best list (shared memory) with the survivors of a
// tile, by the 16 lanes of the half warp that holds the row: k rounds, each
// a 16-lane argmin over what is left of [list | survivors].  Lane l offers
// list entries l and l + 16 and its scores at columns p0 + col(j) flagged
// in `bits` (recomputed from the products, so that no register holds
// them).  Keys are unique within a row (real columns, and the padding
// entries' columns -1, -2, ...), so exactly one lane owns each round's
// winner.
template <int CAP, bool DOT>
__device__ __forceinline__ void merge_row(float* rd, int* rc, int k,
                                          const float (&prod)[8], float qn,
                                          const float* pn, int p0,
                                          unsigned bits, int l16) {
  using T = Fp32Tile<128>;
  bool t0 = l16 >= k;
  bool t1 = CAP <= 16 || l16 + 16 >= k;
  float o0d = REPRO_BIG, o1d = REPRO_BIG;
  int o0c = -1, o1c = -1;
  for (int r = 0; r < k; ++r) {
    float bd = INFINITY;
    int bc = INT_MAX;
    int src = -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((bits >> j) & 1u) {
        const float sj = tile_score<DOT>(prod[j], qn, pn[T::col(j)]);
        const int c = p0 + T::col(j);
        if (kb_less(sj, c, bd, bc)) {
          bd = sj;
          bc = c;
          src = j;
        }
      }
    }
    if (!t0 && kb_less(rd[l16], rc[l16], bd, bc)) {
      bd = rd[l16];
      bc = rc[l16];
      src = 8;
    }
    if (!t1 && kb_less(rd[l16 + 16], rc[l16 + 16], bd, bc)) {
      bd = rd[l16 + 16];
      bc = rc[l16 + 16];
      src = 9;
    }
    float wd = bd;
    int wc = bc;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, wd, off);
      const int oc = __shfl_xor_sync(kFull, wc, off);
      if (kb_less(od, oc, wd, wc)) {
        wd = od;
        wc = oc;
      }
    }
    if (src >= 0 && wc == bc && wd == bd) {
      if (src < 8) {
        bits &= ~(1u << src);
      } else if (src == 8) {
        t0 = true;
      } else {
        t1 = true;
      }
    }
    if ((r & 15) == l16) {
      if (r < 16) {
        o0d = wd;
        o0c = wc;
      } else {
        o1d = wd;
        o1c = wc;
      }
    }
  }
  __syncwarp();
  if (l16 < k) {
    rd[l16] = o0d;
    rc[l16] = o0c;
  }
  if (CAP > 16 && l16 + 16 < k) {
    rd[l16 + 16] = o1d;
    rc[l16 + 16] = o1c;
  }
  __syncwarp();
}

// Insert a row's few survivors into its k-best list one at a time, by the
// row's half warp: each candidate is checked against the current k-th
// entry, its place is the count of entries before it (real entries only:
// the padding's scores are BIG), and the entries from there move up one.  Both half warps of the warp run the loop; a half
// with nothing left to insert writes nothing.
template <int CAP, bool DOT>
__device__ __forceinline__ void insert_row(float* rd, int* rc, int k,
                                           const float (&prod)[8], float qn,
                                           const float* pn, int p0,
                                           unsigned bits, int lane) {
  using T = Fp32Tile<128>;
  const int half = lane & 16;
  const int l16 = lane & 15;
  while (__any_sync(kFull, bits != 0)) {
    const unsigned mine =
        (__ballot_sync(kFull, bits != 0) >> half) & 0xffffu;
    const bool act = mine != 0;
    const int src = half + (act ? __ffs(mine) - 1 : 0);
    // this lane's lowest survivor (meaningful on the source lane)
    const int j = bits != 0 ? __ffs(bits) - 1 : 0;
    float pj = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) pj = jj == j ? prod[jj] : pj;
    const int col = (j >> 2) * 64 + (threadIdx.x & 15) * 4 + (j & 3);
    const float cd = __shfl_sync(kFull, tile_score<DOT>(pj, qn, pn[col]),
                                 src);
    const int cc = __shfl_sync(kFull, p0 + col, src);
    if (lane == src && act) bits &= bits - 1;
    const bool go = act && kb_less(cd, cc, rd[k - 1], rc[k - 1]);
    const bool has0 = l16 < k;
    const bool has1 = CAP > 16 && l16 + 16 < k;
    const float e0d = has0 ? rd[l16] : 0.f;
    const int e0c = has0 ? rc[l16] : 0;
    const float e1d = has1 ? rd[l16 + 16] : 0.f;
    const int e1c = has1 ? rc[l16 + 16] : 0;
    const unsigned b0 =
        __ballot_sync(kFull, has0 && kb_less(e0d, e0c, cd, cc));
    const unsigned b1 =
        __ballot_sync(kFull, has1 && kb_less(e1d, e1c, cd, cc));
    const int pos = __popc((b0 >> half) & 0xffffu) +
                    __popc((b1 >> half) & 0xffffu);
    // entries j - 1 move to j for j > pos
    const float p0d = l16 > 0 && has0 ? rd[l16 - 1] : 0.f;
    const int p0c = l16 > 0 && has0 ? rc[l16 - 1] : 0;
    const float p1d = has1 ? rd[l16 + 15] : 0.f;
    const int p1c = has1 ? rc[l16 + 15] : 0;
    __syncwarp();
    if (go && has0 && l16 >= pos) {
      rd[l16] = l16 == pos ? cd : p0d;
      rc[l16] = l16 == pos ? cc : p0c;
    }
    if (go && has1 && l16 + 16 >= pos) {
      rd[l16 + 16] = l16 + 16 == pos ? cd : p1d;
      rc[l16 + 16] = l16 + 16 == pos ? cc : p1c;
    }
    __syncwarp();
  }
}

template <int CAP>
constexpr int chunk_smem_bytes() {
  return (Fp32Tile<128>::kSmemFloats + 2 * kBM * CAP) * 4;
}

template <int CAP, bool DOT>
__global__ void __launch_bounds__(kTileThreads, 2)
distance_topk_chunk_kernel(const float* __restrict__ q,
                           const float* __restrict__ p,
                           const int* __restrict__ labels,
                           const unsigned char* __restrict__ valid, int nq,
                           int n, int dim, int chunk_cols, int n_chunks, int k,
                           float* __restrict__ part_d,
                           int* __restrict__ part_l) {
  using T = Fp32Tile<128>;
  extern __shared__ __align__(16) float smem[];
  float* ld = smem + T::kSmemFloats;              // [128][CAP] scores
  int* lc = reinterpret_cast<int*>(ld + kBM * CAP);  // [128][CAP] columns
  const float* qn = smem + kStages * T::kStageFloats;
  const float* pn = qn + kBM;
  const int q0 = blockIdx.x * kBM;
  const int chunk = blockIdx.y;
  const int n_begin = chunk * chunk_cols;
  const int n_end = min(n, n_begin + chunk_cols);
  const int lane = threadIdx.x & 31;
  const int l16 = lane & 15;
  for (int e = threadIdx.x; e < kBM * CAP; e += kTileThreads) {
    ld[e] = REPRO_BIG;        // padding slot: (BIG, label 0), an incumbent
    lc[e] = -1 - e % CAP;     // that precedes every real column on ties;
                              // unique columns, so one lane owns a winner
  }
  __syncthreads();

  tile_stream<128, !DOT>(q, nq, p, n_end, dim, q0, n_begin, smem,
                         [&](int p0, float (&acc)[8][8]) {
    unsigned ok = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = p0 + T::col(j);
      if (c < n_end && (valid == nullptr || valid[c] != 0)) ok |= 1u << j;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = T::row(i);
      float* rd = ld + r * CAP;
      int* rc = lc + r * CAP;
      const float td = rd[k - 1];   // the row's k-th best: its threshold
      const int tc = rc[k - 1];
      const float qi = DOT ? 0.f : qn[r];
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sj = tile_score<DOT>(acc[i][j], qi, pn[T::col(j)]);
        if (((ok >> j) & 1u) && kb_less(sj, p0 + T::col(j), td, tc)) {
          bits |= 1u << j;
        }
      }
      if (__any_sync(kFull, bits != 0)) {
        // the most survivors either half warp of this warp has for its row
        int most = __popc(bits);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          most += __shfl_xor_sync(kFull, most, off);
        }
        most = max(most, __shfl_xor_sync(kFull, most, 16));
        // a round of the merge costs about as much as one insertion
        if (most <= k) {
          insert_row<CAP, DOT>(rd, rc, k, acc[i], qi, pn, p0, bits, lane);
        } else {
          merge_row<CAP, DOT>(rd, rc, k, acc[i], qi, pn, p0, bits, l16);
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = T::row(i);
    const int gr = q0 + r;
    if (gr >= nq) continue;
    const size_t base = (static_cast<size_t>(gr) * n_chunks + chunk) * k;
    for (int j = l16; j < k; j += 16) {
      const int c = lc[r * CAP + j];
      part_d[base + j] = ld[r * CAP + j];
      part_l[base + j] = c >= 0 ? labels[c] : 0;
    }
  }
}

// Fold the [nq, m = n_chunks * k] partials of each row into its k-best.
template <int CAP>
__global__ void __launch_bounds__(256)
distance_topk_merge_kernel(const float* __restrict__ part_d,
                           const int* __restrict__ part_l, int nq, int m,
                           int k, float* __restrict__ out_d,
                           int* __restrict__ out_l) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= nq) return;
  const size_t off = static_cast<size_t>(row) * m;
  const size_t koff = static_cast<size_t>(row) * k;
  warp_row_topk<CAP>(part_d + off, part_l + off, m, nullptr, nullptr, k,
                     out_d + koff, out_l + koff, lane);
}

template <int CAP, bool DOT>
static void launch_chunks(const float* q, const float* p, const int* labels,
                          const unsigned char* valid, int nq, int n, int dim,
                          int k, int chunk_cols, int n_chunks, float* part_d,
                          int* part_l, cudaStream_t stream) {
  constexpr int bytes = chunk_smem_bytes<CAP>();
  cudaFuncSetAttribute(distance_topk_chunk_kernel<CAP, DOT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((nq + kBM - 1) / kBM, n_chunks);
  distance_topk_chunk_kernel<CAP, DOT><<<grid, kTileThreads, bytes, stream>>>(
      q, p, labels, valid, nq, n, dim, chunk_cols, n_chunks, k, part_d,
      part_l);
}

template <int CAP>
static void launch(const float* q, const float* p, const int* labels,
                   const unsigned char* valid, int nq, int n, int dim, int k,
                   bool dot, int chunk_cols, int n_chunks, float* part_d,
                   int* part_l, float* out_d, int* out_l,
                   cudaStream_t stream) {
  if (dot) {
    launch_chunks<CAP, true>(q, p, labels, valid, nq, n, dim, k, chunk_cols,
                             n_chunks, part_d, part_l, stream);
  } else {
    launch_chunks<CAP, false>(q, p, labels, valid, nq, n, dim, k, chunk_cols,
                              n_chunks, part_d, part_l, stream);
  }
  if (n_chunks > 1) {
    const int rows_per_block = 256 / 32;
    const int blocks = (nq + rows_per_block - 1) / rows_per_block;
    distance_topk_merge_kernel<CAP><<<blocks, 256, 0, stream>>>(
        part_d, part_l, nq, n_chunks * k, k, out_d, out_l);
  }
}

// Wide regime.  q: [nq, dim], p: [n, dim] fp32; labels: [n] int32; valid:
// [n] bytes or null.  part: [nq, n_chunks, k] scratch (the outputs
// themselves when n_chunks == 1); out: [nq, k].  chunk_cols is a multiple
// of 128 and n_chunks * chunk_cols >= n.  1 <= k <= 32, dim >= 1.  Returns
// cudaGetLastError().
extern "C" int distance_topk_f32(const void* q, const void* p,
                                 const void* labels, const void* valid,
                                 int nq, int n, int dim, int k, int dot,
                                 int chunk_cols, int n_chunks, void* part_d,
                                 void* part_l, void* out_d, void* out_l,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto pp = static_cast<const float*>(p);
  auto lp = static_cast<const int*>(labels);
  auto vp = static_cast<const unsigned char*>(valid);
  auto pdp = static_cast<float*>(part_d);
  auto plp = static_cast<int*>(part_l);
  auto odp = static_cast<float*>(out_d);
  auto olp = static_cast<int*>(out_l);
  if (k <= 8) {
    launch<8>(qp, pp, lp, vp, nq, n, dim, k, dot != 0, chunk_cols, n_chunks,
              pdp, plp, odp, olp, s);
  } else if (k <= 16) {
    launch<16>(qp, pp, lp, vp, nq, n, dim, k, dot != 0, chunk_cols, n_chunks,
               pdp, plp, odp, olp, s);
  } else {
    launch<32>(qp, pp, lp, vp, nq, n, dim, k, dot != 0, chunk_cols, n_chunks,
               pdp, plp, odp, olp, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Batched regime.  q: [nb, nq, dim], p: [nb, n, dim] fp32; labels: int32,
// item b's at labels + b * label_stride (0: shared); valid: bytes, item
// b's at valid + b * valid_stride, or null; out: [nb, nq, k].  n <=
// kSmallMaxN, k >= 1, nb * nq >= 1.  vec: dim % 4 == 0 and q, p 16-byte
// aligned.  Returns cudaGetLastError().
extern "C" int distance_topk_small_f32(const void* q, const void* p,
                                       const void* labels, const void* valid,
                                       int nb, int nq, int n, int dim, int k,
                                       int dot, int label_stride,
                                       int valid_stride, int vec,
                                       void* out_d, void* out_l,
                                       void* stream) {
  if (n > kSmallMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int pow2 = 1;
  while (pow2 < n) pow2 <<= 1;
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = nb * nq * kCluster;
  auto qp = static_cast<const float*>(q);
  auto pp = static_cast<const float*>(p);
  auto lp = static_cast<const int*>(labels);
  auto vp = static_cast<const unsigned char*>(valid);
  auto odp = static_cast<float*>(out_d);
  auto olp = static_cast<int*>(out_l);
#define REPRO_SMALL(D, V)                                                     \
  distance_topk_small_kernel<D, V><<<blocks, kSmallThreads, 0, s>>>(          \
      qp, pp, lp, vp, nq, n, dim, k, label_stride, valid_stride, pow2, odp,  \
      olp)
  if (dot && vec) {
    REPRO_SMALL(true, true);
  } else if (dot) {
    REPRO_SMALL(true, false);
  } else if (vec) {
    REPRO_SMALL(false, true);
  } else {
    REPRO_SMALL(false, false);
  }
#undef REPRO_SMALL
  return static_cast<int>(cudaGetLastError());
}
