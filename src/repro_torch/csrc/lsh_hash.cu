// lsh_hash: the p-stable hashes floor((X @ A + b) / w) of every row, as
// [N, H] int32 hashes (raw) or as [N] int32 bucket ids (ids):
// ((sum_j uint32(h_j) * p_j) mod 2^32) % base / factor, in native uint32
// arithmetic, the expression of src/repro/core/lsh.py:bucket_ids.
//
// Replaces the TPU kernel src/repro/kernels/lsh_hash.py:lsh_hash_pallas
// (pallas_call at line 50), which holds the whole [D, H] projection in VMEM
// and runs one [TN, D] x [D, H] product on the MXU per grid step, so that
// the fp32 projection never reaches HBM.
//
// What bounds it here: bytes.  2 H = 8 operations per 4-byte input at
// H = 4, far below the balance point: X is read once, and nothing but the
// hashes (4 H bytes a row) or the id (4 bytes a row) is written.
//
// Design: one streaming pass over X.
//   - Persistent blocks of 8 warps walk tiles of at most kTile = 64 rows,
//     dealt in turn, so that at any time the blocks read neighbouring rows.
//     A tile's rows come through two shared-memory stages (double
//     buffering) whose fill completes on an mbarrier, so that one stage
//     loads while the other is summed.
//   - Narrow rows (flat mode, the kNN shard): a stage is a tile's whole
//     rows, one contiguous span, filled by one cp.async.bulk copy issued by
//     one thread.  A bulk copy needs 16-byte aligned ends, which an 868-byte
//     row (D = 217) or a shard that starts at any row does not have: the
//     copy takes the aligned span around the rows (the bytes it adds lie
//     in the same 16-byte words, so never past the tensor's allocation) and
//     the warps skip the 0-3 leading floats.
//   - Wide rows (row mode, the CF shard: D = 17,700, A 283 KB): a cluster
//     of P <= 8 blocks splits D into P slices and each block walks its
//     slice in chunks of 256 columns (128 or 64 where two stages and the
//     slice of A would not fit), every thread copying its share of the
//     chunk's 16-byte words with cp.async (a bulk copy a row read 1.5x
//     slower).  After every tile the cluster's first block sums the P
//     partial sums in rank order from distributed shared memory: no float
//     atomics, so the same inputs give the same bits on every run.
//   - Each block stages its slice of A once, padded to 4 kQ hashes a
//     column, so that one float4 load gives four hashes' weights.
//   - Lanes walk the columns (conflict-free for any row start or pitch) and
//     each lane keeps the sums of its warp's 8 rows, so one load of A feeds
//     8 rows.  At the end of a tile the 32 lanes' 8 x 4 kQ partial sums
//     are reduced by a transposing butterfly (31 kQ shuffles, not 5 a sum),
//     after which lane l holds row l / 4's hashes kQ (l % 4) ..
//     kQ (l % 4) + kQ - 1.
//   - The epilogue, a thread a hash, adds b, divides by w in IEEE fp32 (no
//     fast math) and takes the floor; the ids epilogue then combines each
//     row's hashes into its signature.  Both write coalesced.
// The product is computed here, never by a library GEMM.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                    // rows a warp
constexpr int kTile = kWarps * kRows;       // rows a tile
constexpr int kMaxH = 12;                   // the signature primes' count
constexpr int kMaxCluster = 8;              // blocks splitting D
constexpr int kChunks[] = {256, 128, 64};   // row-mode chunk widths: the
                                            // widest that fits is taken
constexpr int kStages = 2;                  // 3 or 4 read 1-3 % slower at
                                            // the kNN shard
constexpr int kHeader = 64;                 // bytes of the mbarriers
constexpr int kTooWide = -1;                // returned for a D that no
                                            // shared memory holds

__constant__ unsigned kPrimes[kMaxH] = {
    2654435761u, 2246822519u, 3266489917u, 668265263u, 374761393u,
    2654435789u, 1103515245u, 2971215073u, 433494437u, 1540483477u,
    2166136261u, 16777619u};

struct Params {
  const float* x;
  const float* a;
  const float* b;
  void* out;
  int n, d, h;
  float width;
  int ids;            // 1: bucket ids, 0: raw hashes
  unsigned base, factor;
  int cluster;        // P blocks share a tile, each a slice of D
  int slice;          // columns a block owns (a multiple of 4)
  int flat;           // 1: a stage is whole rows (P = 1)
  int stage_floats;
  int tile_rows;      // rows a tile, at most kTile
  int chunk;          // columns a row-mode stage; its rows are chunk + 4
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from 16-byte aligned global src to 16-byte
// aligned shared dst, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, uintptr_t src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// The 16-byte aligned span [lo, lo + bytes) around n floats at p (no
// bytes for n = 0); the floats start shift_of(p) floats into it.
struct Span {
  uintptr_t lo;
  unsigned bytes;
};

__device__ __forceinline__ Span span_of(const float* p, size_t n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = s & ~uintptr_t(15);
  const uintptr_t hi = (s + 4 * n + 15) & ~uintptr_t(15);
  return {lo, n ? static_cast<unsigned>(hi - lo) : 0u};
}

__device__ __forceinline__ int shift_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Item i of a block: chunk i % n_chunks of tile cid + (i / n_chunks) n_cl,
// the tiles of p.tile_rows rows dealt to the n_cl clusters (or flat
// blocks) in turn, so that at any time they read neighbouring rows.
struct Item {
  int r0, nr;         // the tile's first row and its row count
  int c0, cw;         // the chunk's first column (in the slice) and width
};

__device__ __forceinline__ Item item_of(const Params& p, int i, int n_chunks,
                                        int cid, int n_cl, int width) {
  Item it;
  it.r0 = (cid + (i / n_chunks) * n_cl) * p.tile_rows;
  it.nr = min(p.tile_rows, p.n - it.r0);
  if (p.flat) {
    it.c0 = 0;
    it.cw = p.d;
  } else {
    it.c0 = (i % n_chunks) * p.chunk;
    it.cw = max(0, min(p.chunk, width - it.c0));
  }
  return it;
}

__device__ __forceinline__ void cp_async16(float* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// The barrier's arrival once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Fills a stage with an item's rows.  Flat: thread 0 copies the whole
// rows with one bulk copy (the mbarrier counts its bytes).  Row mode: every
// thread copies its share of the rows' 16-byte words with cp.async and
// arrives on the mbarrier when they have landed.
__device__ __forceinline__ void issue(const Params& p, const Item& it,
                                      int c_lo, float* dst, uint64_t* bar) {
  if (p.flat) {
    if (threadIdx.x == 0) {
      const Span sp = span_of(p.x + static_cast<size_t>(it.r0) * p.d,
                              static_cast<size_t>(it.nr) * p.d);
      mbar_arrive_expect(bar, sp.bytes);
      if (sp.bytes) bulk_copy(dst, sp.lo, sp.bytes, bar);
    }
    return;
  }
  const int pitch = p.chunk + 4, words = pitch / 4;
  for (int e = threadIdx.x; e < kTile * words; e += kThreads) {
    const int r = e / words, k = e - r * words;
    if (r >= it.nr) break;
    const Span sp = span_of(
        p.x + static_cast<size_t>(it.r0 + r) * p.d + c_lo + it.c0, it.cw);
    if (16u * k < sp.bytes)
      cp_async16(dst + r * pitch + 4 * k, sp.lo + 16 * k);
  }
  cp_async_arrive(bar);
}

// One halving step of transpose_sum: lanes with bit `off` set keep the
// upper half of their first 2 kHalf values and add the partner's upper
// half; the others keep and add the lower half.
template <int kHalf, int M>
__device__ __forceinline__ void halve(float (&v)[M], int lane, int off) {
  const bool upper = lane & off;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Sum M = 32 kQ values a lane over the warp: after five halving steps lane
// l holds the sums of values kQ l .. kQ l + kQ - 1 in v[0 .. kQ - 1].
// Fixed order: the same bits on every run.
template <int M>
__device__ __forceinline__ void transpose_sum(float (&v)[M], int lane) {
  halve<M / 2>(v, lane, 16);
  halve<M / 4>(v, lane, 8);
  halve<M / 8>(v, lane, 4);
  halve<M / 16>(v, lane, 2);
  halve<M / 32>(v, lane, 1);
}

template <int kQ>
__global__ void __launch_bounds__(kThreads, 1)
lsh_kernel(const Params p) {
  constexpr int kH4 = 4 * kQ;                 // hashes padded to float4s
  constexpr int kAcc = kRows * kH4;           // sums a lane
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* sb = reinterpret_cast<float*>(smem + kHeader);   // [kH4]
  float* part = sb + kH4;                     // [2][kTile][kH4]
  float* sa = part + 2 * kTile * kH4;         // [slice][kH4]
  float* stage0 = sa + static_cast<size_t>(p.slice) * kH4;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = p.cluster > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int cid = blockIdx.x / p.cluster, n_cl = gridDim.x / p.cluster;
  const int c_lo = rank * p.slice;
  const int width = max(0, min(p.slice, p.d - c_lo));
  const int n_chunks =
      p.flat ? 1 : max(1, (width + p.chunk - 1) / p.chunk);
  const int n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  const int total = (n_tiles - cid + n_cl - 1) / n_cl * n_chunks;

  if (threadIdx.x == 0) {
    // flat: thread 0's arrival and the bytes; row mode: every thread's
    for (int s = 0; s < kStages; ++s)
      mbar_init(&full[s], p.flat ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < kStages && i < total; ++i)
    issue(p, item_of(p, i, n_chunks, cid, n_cl, width), c_lo,
          stage0 + static_cast<size_t>(i) * p.stage_floats, &full[i]);
  // A's slice, padded to kH4 weights a column (zeros past H and past D)
  for (int e = threadIdx.x; e < p.slice * kH4; e += kThreads) {
    const int c = e / kH4, j = e % kH4;
    sa[e] = (j < p.h && c < width)
                ? p.a[static_cast<size_t>(c_lo + c) * p.h + j] : 0.f;
  }
  if (threadIdx.x < kH4)
    sb[threadIdx.x] = threadIdx.x < p.h ? p.b[threadIdx.x] : 0.f;
  __syncthreads();

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  int buf = 0;
  for (int i = 0; i < total; ++i) {
    const int s = i % kStages;
    const Item it = item_of(p, i, n_chunks, cid, n_cl, width);
    float* st = stage0 + static_cast<size_t>(s) * p.stage_floats;
    // where each of this warp's rows starts in the stage
    int off[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = warp * kRows + k;
      off[k] = p.flat
          ? shift_of(p.x + static_cast<size_t>(it.r0) * p.d) + r * p.d
          : r * (p.chunk + 4) +
                shift_of(p.x + static_cast<size_t>(it.r0 + r) * p.d + c_lo +
                         it.c0);
    }
    mbar_wait(&full[s], (i / kStages) & 1);
    const float4* a4 = reinterpret_cast<const float4*>(sa) + it.c0 * kQ;
#pragma unroll 2
    for (int c = lane; c < it.cw; c += 32) {
      float4 w[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) w[q] = a4[c * kQ + q];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float v = st[off[k] + c];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int j = k * kH4 + 4 * q;
          acc[j] = fmaf(v, w[q].x, acc[j]);
          acc[j + 1] = fmaf(v, w[q].y, acc[j + 1]);
          acc[j + 2] = fmaf(v, w[q].z, acc[j + 2]);
          acc[j + 3] = fmaf(v, w[q].w, acc[j + 3]);
        }
      }
    }
    __syncthreads();                          // every warp is done with s
    if (i + kStages < total)
      issue(p, item_of(p, i + kStages, n_chunks, cid, n_cl, width), c_lo,
            st, &full[s]);
    if ((i + 1) % n_chunks) continue;         // the tile goes on

    // the tile's partial sums: lane l has row warp * 8 + l / 4's weights
    // kQ (l % 4) .. + kQ - 1
    transpose_sum<kAcc>(acc, lane);
    float* mine = part + buf * kTile * kH4;
#pragma unroll
    for (int q = 0; q < kQ; ++q) mine[warp * kAcc + kQ * lane + q] = acc[q];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
    if (p.cluster > 1) {
      cluster.sync();                         // every rank's partials are in
    } else {
      __syncthreads();
    }
    if (rank == 0) {
      // a thread a hash: the cluster's sum in rank order, then
      // floor((sum + b) / w), written out (raw) or kept in place of the sum
      // (ids; no other thread reads it), so that all threads share the
      // remote reads whichever the epilogue
      int* out = static_cast<int*>(p.out);
      for (int e = threadIdx.x; e < it.nr * p.h; e += kThreads) {
        const int row = e / p.h, j = e - row * p.h, k = row * kH4 + j;
        float sum = mine[k];
        for (int r = 1; r < p.cluster; ++r)
          sum += cluster.map_shared_rank(mine, r)[k];
        const int hash = static_cast<int>(floorf((sum + sb[j]) / p.width));
        if (p.ids) {
          reinterpret_cast<int*>(mine)[k] = hash;
        } else {
          out[static_cast<size_t>(it.r0) * p.h + e] = hash;
        }
      }
      if (p.ids) {
        __syncthreads();
        const int* hashes = reinterpret_cast<const int*>(mine);
        for (int row = threadIdx.x; row < it.nr; row += kThreads) {
          unsigned sig = 0;
          for (int j = 0; j < p.h; ++j)
            sig += static_cast<unsigned>(hashes[row * kH4 + j]) * kPrimes[j];
          out[it.r0 + row] = static_cast<int>(sig % p.base / p.factor);
        }
      }
    }
    buf ^= 1;
  }
  // no block leaves while the first one may still read its partials
  if (p.cluster > 1) cluster.sync();
}

template <int kQ>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&lsh_kernel<kQ>);
}

const void* kernel_for(int kq) {
  return kq == 1 ? kernel_of<1>() : kq == 2 ? kernel_of<2>()
                                            : kernel_of<3>();
}

size_t round4(size_t v) { return (v + 3) & ~size_t(3); }

// Shared memory besides A and the stages: the mbarriers, b and the two
// partial-sum buffers.
size_t fixed_bytes(int kq) {
  return kHeader + sizeof(float) * (4 * kq + 2 * kTile * 4 * kq);
}

// Whether the stages fit beside A.
bool fits(size_t a_bytes, size_t stage_bytes, int kq, int smem_max) {
  return fixed_bytes(kq) + a_bytes + kStages * stage_bytes <=
         static_cast<size_t>(smem_max);
}

struct Plan {
  int cluster, slice, flat, stage_floats, chunk;
  size_t smem;
};

// Flat mode when two stages of whole rows fit beside all of A and either
// the tiles fill the card or the rows are no wider than a chunk.  Row mode
// otherwise: the widest chunk for which two stages fit beside a slice of
// A, with ceil(D / chunk) (at most 8) blocks splitting D.  cluster = 0: no
// shared memory holds D.
Plan plan_for(int n, int d, int kq, int sms, int smem_max) {
  Plan pl{};
  const int n_tiles = (n + kTile - 1) / kTile;
  const size_t a_full = round4(d) * 16 * kq;
  const size_t flat_floats = round4(static_cast<size_t>(kTile) * d) + 8;
  if (fits(a_full, 4 * flat_floats, kq, smem_max) &&
      (n_tiles >= sms || d <= kChunks[0])) {
    pl = {1, static_cast<int>(round4(d)), 1, static_cast<int>(flat_floats), 0,
          0};
  } else {
    for (const int chunk : kChunks) {
      const int cl = std::min(kMaxCluster, (d + chunk - 1) / chunk);
      const int slice = static_cast<int>(round4((d + cl - 1) / cl));
      const int row_floats = kTile * (chunk + 4);
      if (fits(static_cast<size_t>(slice) * 16 * kq,
               4 * static_cast<size_t>(row_floats), kq, smem_max)) {
        pl = {cl, slice, 0, row_floats, chunk, 0};
        break;
      }
    }
    if (pl.cluster == 0) return pl;
  }
  pl.smem = fixed_bytes(kq) + static_cast<size_t>(pl.slice) * 16 * kq +
            static_cast<size_t>(kStages) * pl.stage_floats * 4;
  return pl;
}

int device_attr(cudaDeviceAttr attr, int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, attr, device);
  return v;
}

// Blocks (flat) or clusters (row mode) the card holds at once, asked once
// per device, kernel, cluster size and shared-memory size.
int resident(const void* fn, int cluster, size_t smem, int device, int sms) {
  struct Known {
    const void* fn;
    int cluster, device;
    size_t smem;
    int value;
  };
  static Known known[16];
  static int n_known = 0;
  for (int i = 0; i < n_known; ++i) {
    const Known& k = known[i];
    if (k.fn == fn && k.cluster == cluster && k.device == device &&
        k.smem == smem)
      return k.value;
  }
  // the opt-in maximum, so that no later, smaller call can lower it
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   device));
  int value = 0;
  if (cluster == 1) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    value = per_sm * sms;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaOccupancyMaxActiveClusters(&value, fn, &cfg);
  }
  if (n_known < 16) known[n_known++] = {fn, cluster, device, smem, value};
  return value;
}

}  // namespace

// x: [n, d] fp32 (any 4-byte aligned start), a: [d, h], b: [h] fp32.
// ids = 0: out [n, h] int32 hashes; ids = 1: out [n] int32 bucket ids,
// base >= 1, factor >= 1.  n, d >= 1, 1 <= h <= kMaxH.  Returns
// cudaGetLastError(), or kTooWide when no shared memory holds a slice of A.
extern "C" int lsh_hash_f32(const void* x, const void* a, const void* b,
                            int n, int d, int h, float width, int ids,
                            unsigned base, unsigned factor, void* out,
                            void* stream) {
  if (h < 1 || h > kMaxH || n < 1 || d < 1 ||
      (ids && (base == 0 || factor == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaGetDevice(&device);
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, device);
  const int smem_max =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int kq = (h + 3) / 4;
  const Plan pl = plan_for(n, d, kq, sms, smem_max);
  if (pl.cluster == 0) return kTooWide;
  const void* fn = kernel_for(kq);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int fit = resident(fn, pl.cluster, pl.smem, device, sms);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = n_tiles < fit ? n_tiles : fit;
  // every group the same number of rounds, in tiles of equal size
  const int rounds = (n_tiles + groups - 1) / groups;
  const int tile_rows = static_cast<int>(
      (static_cast<long long>(n) + rounds * groups - 1) / (rounds * groups));

  Params p{static_cast<const float*>(x), static_cast<const float*>(a),
           static_cast<const float*>(b), out, n, d, h, width, ids, base,
           factor, pl.cluster, pl.slice, pl.flat, pl.stage_floats, tile_rows,
           pl.chunk};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(groups * pl.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = pl.cluster > 1 ? 1 : 0;
  void* args[] = {&p};
  cudaLaunchKernelExC(&cfg, fn, args);
  return static_cast<int>(cudaGetLastError());
}
