// The fp32 cross-product tiles of knn_distance and the wide regime of
// distance_topk.
//
// A block of 256 threads computes the products of a 128-query by BN-point
// tile (BN 128 or 64): thread (ty, tx) of a 16 x 16 grid keeps the 8 x
// (BN / 16) sums of rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3} and
// columns tx * 4 + {0..3} (and 64 + tx * 4 + {0..3} when BN is 128) in
// registers, so each feature column costs 4 (or 3) 16-byte shared loads
// for 64 (or 32) FMAs: the inner loop is bound by the FMA pipes, not by
// shared-memory issue.
//
// Feature columns are staged kBK at a time, kStages deep, by 4-byte
// cp.async: rows of D = 217 floats are 868 bytes, not a multiple of 16, so
// neither 16-byte cp.async nor TMA can address them, and no padded copy is
// made.  Neighbouring threads copy neighbouring columns of a row; each
// thread's rows and their bounds are worked out once per tile.  A block
// walks a run of point tiles as one stream of stages, so the loads of the
// next tile's first columns are in flight while this tile's last columns
// are computed and its epilogue runs.  The stage is stored transposed,
// s[column][row], with a pitch of BN + 4 floats: the transposing writes hit
// 32 distinct banks and every fragment read is one aligned 16-byte load.
//
// With NORMS, |q|^2 and |p|^2 are summed from the same staged values, one
// row per thread (threads 0..127 the queries, 128..128+BN-1 the points),
// in column order, and left in shared memory for the epilogue.
//
// fp32 FMAs throughout, no TF32: the reference is fp32.  No atomics: the
// same inputs give the same bits on every run.
#pragma once

#include <cuda_runtime.h>

constexpr int kBM = 128;       // queries per tile
constexpr int kBK = 8;         // feature columns per stage
constexpr int kStages = 4;     // stages in flight
constexpr int kTileThreads = 256;

template <int BN>
struct Fp32Tile {
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static constexpr int kAPitch = kBM + 4;
  static constexpr int kBPitch = BN + 4;
  static constexpr int kCols = BN / 16;   // columns a thread keeps
  static constexpr int kARows = kBM * kBK / kTileThreads;  // copied a stage
  static constexpr int kBRows = BN * kBK / kTileThreads;
  // floats of shared memory: the stages, then |q|^2 [128] and |p|^2 [BN]
  static constexpr int kStageFloats = kBK * (kAPitch + kBPitch);
  static constexpr int kSmemFloats = kStages * kStageFloats + kBM + BN;

  // Row of the tile held in accumulator row i, column in accumulator col j.
  __device__ static __forceinline__ int row(int i) {
    return (i >> 2) * 64 + (threadIdx.x >> 4) * 4 + (i & 3);
  }
  __device__ static __forceinline__ int col(int j) {
    return (j >> 2) * 64 + (threadIdx.x & 15) * 4 + (j & 3);
  }
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// What one thread copies of a [rows, dim] operand for a tile: ROWS rows,
// 32 apart, at column threadIdx.x % kBK of each stage, into s[column][row]
// (pitch PITCH).  Rows past the end are zero-filled; zero features are
// neutral for the cross term and the norms.  It keeps one pointer and the
// count of its rows that exist, so that it costs few registers.
template <int ROWS, int PITCH>
struct RowCopier {
  static constexpr int kGap = kTileThreads / kBK;  // rows between copies
  const float* first;  // this thread's first row, at its column
  int live;            // how many of its rows exist

  __device__ __forceinline__ void start(const float* __restrict__ a,
                                        int rows, int dim, int r0) {
    const int r = r0 + threadIdx.x / kBK;
    live = r < rows ? min(ROWS, (rows - r + kGap - 1) / kGap) : 0;
    first = live > 0 ? a + static_cast<size_t>(r) * dim + threadIdx.x % kBK
                     : a;
  }

  __device__ __forceinline__ void copy(float* s, int c0, int dim) const {
    const bool in_col = c0 + static_cast<int>(threadIdx.x % kBK) < dim;
    float* d = s + (threadIdx.x % kBK) * PITCH + threadIdx.x / kBK;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const bool in = in_col && u < live;
      cp_async4(d + u * kGap,
                in ? first + static_cast<size_t>(u) * kGap * dim + c0 : first,
                in);
    }
  }
};

// Walk the point tiles p0 = p_begin, p_begin + BN, ... < p_end against the
// 128 queries from q0, as one stream of kStages-deep stages.  After each
// tile, with acc[i][j] = q[q0 + row(i)] . p[p0 + col(j)] (rows at or past
// nq / p_end read as zero) and, with NORMS, qn[r] = |q[q0 + r]|^2 and
// pn[c] = |p[p0 + c]|^2 in shared memory, it calls epilogue(p0, acc) with
// every thread of the block.  The next tile's first loads are in flight
// during an epilogue, so only the last tile's epilogue may write the
// stages (knn_distance's, whose block has one tile).
template <int BN, bool NORMS, typename Epilogue>
__device__ __forceinline__ void tile_stream(
    const float* __restrict__ q, int nq, const float* __restrict__ p,
    int p_end, int dim, int q0, int p_begin, float* smem, Epilogue epilogue) {
  using T = Fp32Tile<BN>;
  constexpr int NC = T::kCols;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  float* qn = smem + kStages * T::kStageFloats;
  float* pn = qn + kBM;
  const int nk = max(1, (dim + kBK - 1) / kBK);
  const int n_tiles = (p_end - p_begin + BN - 1) / BN;
  const int total = n_tiles * nk;

  RowCopier<T::kARows, T::kAPitch> qa;
  RowCopier<T::kBRows, T::kBPitch> pb;
  qa.start(q, nq, dim, q0);
  int load_tile = 0;  // the tile and column step the next load is for
  int load_kt = 0;
  pb.start(p, p_end, dim, p_begin);
  auto load = [&](int g) {
    float* s = smem + (g % kStages) * T::kStageFloats;
    if (load_kt == 0 && load_tile > 0) {
      pb.start(p, p_end, dim, p_begin + load_tile * BN);
    }
    qa.copy(s, load_kt * kBK, dim);
    pb.copy(s + kBK * T::kAPitch, load_kt * kBK, dim);
    if (++load_kt == nk) {
      load_kt = 0;
      ++load_tile;
    }
  };
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < total) load(g);
    cp_async_commit();
  }

  // the row whose norm this thread sums, in the A (query) or B (point) part
  const bool norm_a = threadIdx.x < kBM;
  const bool norm_b = !norm_a && threadIdx.x - kBM < BN;
  const int norm_off = norm_a ? threadIdx.x
                              : kBK * T::kAPitch + (threadIdx.x - kBM);
  const int norm_pitch = norm_a ? T::kAPitch : T::kBPitch;

  int g = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float acc[8][NC];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
    }
    float nrm = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (g + kStages - 1 < total) load(g + kStages - 1);
      cp_async_commit();
      const float* s = smem + (g % kStages) * T::kStageFloats;
      const float* sa = s;
      const float* sb = s + kBK * T::kAPitch;
#pragma unroll
      for (int c = 0; c < kBK; ++c) {
        float a[8];
        float b[NC];
        const float4 a0 =
            *reinterpret_cast<const float4*>(sa + c * T::kAPitch + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(
            sa + c * T::kAPitch + 64 + ty * 4);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
        for (int h = 0; h < NC / 4; ++h) {
          const float4 bv = *reinterpret_cast<const float4*>(
              sb + c * T::kBPitch + h * 64 + tx * 4);
          b[4 * h] = bv.x; b[4 * h + 1] = bv.y;
          b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
      if (NORMS && (norm_a || norm_b)) {
#pragma unroll
        for (int c = 0; c < kBK; ++c) {
          const float x = s[norm_off + c * norm_pitch];
          nrm = fmaf(x, x, nrm);
        }
      }
    }
    // (every thread is past the last tile's epilogue: nk >= 1 barriers ago)
    if (NORMS) {
      if (norm_a) qn[threadIdx.x] = nrm;
      if (norm_b) pn[threadIdx.x - kBM] = nrm;
    }
    __syncthreads();
    epilogue(p_begin + t * BN, acc);
  }
  cp_async_wait<0>();
}
