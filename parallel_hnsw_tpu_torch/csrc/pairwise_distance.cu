// Tiled pairwise distances [Q, D] x [C, D] -> [Q, C] f32, for Hopper (sm_90a).
//
// Replaces parallel_hnsw_tpu/ops/pallas_distance.py::_dist_kernel.  Same
// semantics: one contraction over D per (query, corpus) pair and a fused
// epilogue per metric -- cosine 1-dot, normalized cosine (1-dot)/2, dot -dot,
// and the L2 family max(|x|^2 + |y|^2 - 2 dot, 0) (square root for L2).  Like
// the TPU kernel it has two modes, here two kernels.
//
// Exact mode (pairwise_distance_f32): full fp32 on the FFMA pipes -- no
// tensor cores, no TF32: the 1e-5 self-match epsilon rests on it.
//   What bounds it on an H100: at the main-path block [2048 x 65536 x 100] it
//   does 2 * 2048 * 65536 * 100 ~ 27 GFLOP of FFMA (0.40 ms at the 67 TFLOP/s
//   peak) against a 512 MiB output (0.16 ms at 3.35 TB/s): operations.  So
//   the design spends as few instruction slots as it can on anything but FFMAs:
//   * a block of 256 threads owns a 128 x 128 output tile, a thread an 8 x 8
//     register micro-tile (16 FFMAs per 16-byte shared-memory read);
//   * operands arrive by 16-byte cp.async, row-major with 32 values (128
//     bytes) of D per row and stage, in a ring of four stages of dynamic
//     shared memory, so the loads of chunk k + 3 are in flight while chunk k
//     is multiplied, with one barrier per chunk.  The 16-byte pieces of a row
//     are XOR-swizzled by (row / 4) % 8, which keeps both the copies and the
//     float4 reads of a quarter-warp on eight different bank groups;
//   * a block walks several column tiles with one flat pipeline, so the loads
//     of the next tile run under this tile's products and stores;
//   * a thread's columns are two runs of four, 64 apart, so a half-warp
//     stores 256 contiguous bytes of a row with 16-byte stores;
//   * only ceil(valid / 8) of the last chunk's partials are multiplied (D =
//     100 costs 104 columns of work, not 128).
//   The dot accumulates in partial sums of 8 FFMAs that then join the running
//   sum: measured on an H100, that order reproduces the plain version's
//   (cuBLAS's) dots at D = 32, where one 32-term chain carried twice their
//   rounding error.  For the L2 family the threads also sum |x|^2 and |y|^2
//   of the tile's rows from the staged chunks, in fp64 (1/64 of the FFMA
//   count, four chains a thread), so the norms carry no chain-length error.
//   Rows that are not a multiple of 16 bytes, or unaligned bases, take 4-byte
//   cp.async into the same layout (D = 7 works); ragged edges are zero-filled
//   by the copies.
//   What is left (NVIDIA H100 80GB HBM3, 700 W): the time is linear in D with
//   the output write as intercept, and the slope is half the FFMA peak.  The
//   row-major staging that 16-byte copies force brings four values of D per
//   shared-memory read, so a thread's operand fragments are 64 registers and
//   cannot be double-buffered beside 64 + 64 accumulators: reads and FFMAs
//   take turns.  Tried and measured without effect: no 8-FFMA partials,
//   three stages, an 8 x 4 micro-tile at 512 threads, column runs multiplied
//   one after the other, the finished tile stored by the copy engine.
//
// Fast mode (pairwise_distance_bf16): the dots of the operands rounded to
// bf16, accumulated in f32 on the tensor cores, as the TPU kernel's
// exact=False is one bf16 pass of the MXU; |x|^2 and |y|^2 of the L2 family
// come from the UNROUNDED f32 operands, like _dist_kernel's.
//   What bounds it: the 512 MiB output (0.16 ms); the product is 0.03 ms of
//   the bf16 peak.  It is the mainloop of bf16_tile.cuh (resident 128-row
//   query tile, TMA ring, two consumer warpgroups of m64n128k16 wgmma) with a
//   store epilogue: while one warpgroup maps and stores its 64 x 128 tile the
//   other's product runs, and a block walks a range of corpus groups so the
//   stores of one group overlap the loads of the next.  The epilogue is most
//   of what the kernel executes, so it is one FFMA per value for the dot
//   metrics and carries no bounds checks inside the matrix.
//   A bf16 row of D = 100 is 200 bytes, which neither a tensor map nor a
//   16-byte copy can address, so this kernel takes bf16 copies of the
//   operands, zero-padded to a multiple of 8 columns (zero columns change no
//   dot), and the f32 norms as inputs.  A kernel of its own makes them
//   (bf16_operand_f32: one pass over the f32 rows writes the rounded, padded
//   rows and, for the L2 family, |row|^2 of the unrounded values summed in
//   fp64), once per operand and not once per block: the callers' loops walk
//   blocks of one corpus (ops/cuda_distance.py::prepare_operand).  It moves
//   1.5 x the operand's bytes: 0.012 ms of memory time for a 65536 x 100 block.
//
// The later win for both is to fuse the caller's top-k into the epilogue so
// the [Q, C] matrix never reaches HBM, as _scan_kernel does on the TPU.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, returns a cudaError_t value (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "bf16_tile.cuh"

namespace {

// Metric codes; parallel_hnsw_tpu_torch/ops/cuda_distance.py passes the same.
constexpr int COSINE = 0;
constexpr int NORMALIZED_COSINE = 1;
constexpr int EUCLIDEAN = 2;
constexpr int SQUARED_EUCLIDEAN = 3;
constexpr int DOT = 4;

__host__ __device__ __forceinline__ bool is_l2(int metric) {
  return metric == EUCLIDEAN || metric == SQUARED_EUCLIDEAN;
}

__device__ __forceinline__ float finish(float dot, float xx, float yy, int metric) {
  switch (metric) {
    case COSINE:
      return 1.0f - dot;
    case NORMALIZED_COSINE:
      return (1.0f - dot) / 2.0f;
    case DOT:
      return -dot;
    default: {
      // same evaluation order as the plain version: (x2 + y2) - 2 dot
      const float sq = fmaxf(__fsub_rn(__fadd_rn(xx, yy), 2.0f * dot), 0.0f);
      return metric == SQUARED_EUCLIDEAN ? sq : sqrtf(sq);
    }
  }
}

// ---------------------------------------------------------------------------
// Exact mode: f32 operands, fp32 FFMA.

namespace exact {

constexpr int BM = 128;   // output rows (queries) per tile
constexpr int BN = 128;   // output columns (corpus rows) per tile
constexpr int BK = 32;    // values of D per row and stage: 128 bytes
constexpr int TM = 8;     // micro-tile rows per thread
constexpr int TN = 8;     // micro-tile columns per thread: two runs of four, BN / 2 apart
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int KPART = 8;  // FFMA chain length before a partial joins the running sum
constexpr int STAGES = 4;
constexpr int ROW_BYTES = BK * 4;
constexpr int PIECES = ROW_BYTES / 16;  // 16-byte pieces per staged row
constexpr int TILE_BYTES = BM * ROW_BYTES;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // the x tile, then the y tile
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + (BM + BN) * 4;
static_assert(BM == BN, "one loader serves both operands");
static_assert(THREADS == BM + BN, "one thread sums the norm of each staged row");

// Byte offset of 16-byte piece `piece` of staged row `row`.
__device__ __forceinline__ int piece_offset(int row, int piece) {
  return row * ROW_BYTES + ((piece ^ ((row >> 2) & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// Rows [first_row, first_row + 128) x columns [k0, k0 + 32) of m [n_rows, d]
// into a staged tile; what lies past the matrix is filled with zeros (a copy
// of zero source bytes).
template <bool VEC>
__device__ __forceinline__ void load_tile(uint32_t tile, const float* __restrict__ m,
                                          int first_row, int n_rows, int d, int k0, int tid) {
#pragma unroll
  for (int v = 0; v < BM * PIECES / THREADS; ++v) {
    const int id = tid + v * THREADS;  // consecutive threads: consecutive pieces of a row
    const int row = id / PIECES, piece = id % PIECES;
    const int grow = first_row + row;
    const int k = k0 + piece * 4;
    const bool in_row = grow < n_rows;
    const float* src_row = m + (size_t)(in_row ? grow : 0) * d;
    const uint32_t dst = tile + piece_offset(row, piece);
    if (VEC) {  // d % 4 == 0: a piece is whole or absent
      const bool ok = in_row && k < d;
      cp_async16(dst, src_row + (ok ? k : 0), ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in_row && k + e < d;
        cp_async4(dst + 4 * e, src_row + (ok ? k + e : 0), ok ? 4 : 0);
      }
    }
  }
}

// blockIdx.x = row tile + n_row_tiles * (range of `tiles_per_block` column tiles).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
                int q, int c, int d, int metric, int n_row_tiles, int tiles_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xn = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* yn = xn + BM;
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const int row0 = static_cast<int>(blockIdx.x % n_row_tiles) * BM;
  const int n_col_tiles = (c + BN - 1) / BN;
  const int ct0 = static_cast<int>(blockIdx.x / n_row_tiles) * tiles_per_block;
  const int ct1 = min(ct0 + tiles_per_block, n_col_tiles);
  const int nk = (d + BK - 1) / BK;
  const int total = (ct1 - ct0) * nk;  // (tile, chunk) pairs, one flat pipeline
  const bool l2 = is_l2(metric);
  const bool vec_store = c % 4 == 0;

  // the loader's cursor runs STAGES - 1 chunks ahead of the multiplier's
  int l_n = 0, l_tile = ct0, l_kc = 0, l_stage = 0;
  auto load_next = [&]() {
    if (l_n < total) {
      const uint32_t stage = smem_addr + l_stage * STAGE_BYTES;
      load_tile<VEC>(stage, x, row0, q, d, l_kc * BK, tid);
      load_tile<VEC>(stage + TILE_BYTES, y, l_tile * BN, c, d, l_kc * BK, tid);
      ++l_n;
      if (++l_kc == nk) {
        l_kc = 0;
        ++l_tile;
      }
      if (++l_stage == STAGES) l_stage = 0;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group keeps the count
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();

  // staged offsets of this thread's operands (without the piece)
  const int a_base = ty * TM * ROW_BYTES;  // rows ty * TM + i: swizzle (row / 4) % 8
  auto a_swz = [&](int i) { return ((ty * TM + i) >> 2) & 7; };
  const int b_base = TILE_BYTES + tx * 4 * ROW_BYTES;  // rows tx * 4 + j % 4 (+ 64): swizzle tx
  const int b_swz = tx & 7;
  // norms: threads [0, 128) sum an x row each, [128, 256) a y row
  const int n_row = tid % BM;
  const int n_base = (tid / BM) * TILE_BYTES + n_row * ROW_BYTES;

  float acc[TM][TN];
  double norm[4] = {0.0, 0.0, 0.0, 0.0};  // four chains: the fp64 pipe is slow to turn around
  int tile = ct0, kc = 0, stage_i = 0;
  for (int n = 0; n < total; ++n) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // chunk n has landed for all; the stage of chunk n - 1 is free
    load_next();
    const unsigned char* stage = smem + stage_i * STAGE_BYTES;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
      norm[0] = norm[1] = norm[2] = norm[3] = 0.0;
    }

    if (l2) {
      // pieces in an order that keeps a quarter-warp on eight bank groups;
      // pieces past D are zeros
#pragma unroll
      for (int s = 0; s < PIECES; ++s) {
        const float4 v =
            *reinterpret_cast<const float4*>(stage + n_base + ((s ^ (n_row & 7)) << 4));
        norm[0] = fma((double)v.x, (double)v.x, norm[0]);
        norm[1] = fma((double)v.y, (double)v.y, norm[1]);
        norm[2] = fma((double)v.z, (double)v.z, norm[2]);
        norm[3] = fma((double)v.w, (double)v.w, norm[3]);
      }
    }

    const int parts = min(BK / KPART, (d - kc * BK + KPART - 1) / KPART);
    for (int k8 = 0; k8 < parts; ++k8) {
      float part[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
#pragma unroll
      for (int half = 0; half < KPART / 4; ++half) {
        const int piece = k8 * (KPART / 4) + half;
        float4 b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              stage + b_base + (j / 4) * (BN / 2) * ROW_BYTES + (j % 4) * ROW_BYTES +
              ((piece ^ b_swz) << 4));
        // k ascending per (i, j); consecutive FFMAs are independent (j varies fastest)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              stage + a_base + i * ROW_BYTES + ((piece ^ a_swz(i)) << 4));
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a.x, b[j].x, part[i][j]);
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a.y, b[j].y, part[i][j]);
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a.z, b[j].z, part[i][j]);
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a.w, b[j].w, part[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    }

    if (++stage_i == STAGES) stage_i = 0;
    if (++kc < nk) continue;
    kc = 0;

    // the tile's dots are complete: epilogue and store
    if (l2) {
      // the previous tile's epilogue read xn / yn before this tile's barriers
      (tid < BM ? xn : yn)[n_row] = (float)((norm[0] + norm[1]) + (norm[2] + norm[3]));
      __syncthreads();
    }
    const int col0 = tile * BN + tx * 4;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty * TM + i;
      if (row >= q) break;
      const float xx = l2 ? xn[ty * TM + i] : 0.0f;
#pragma unroll
      for (int run = 0; run < 2; ++run) {
        const int col = col0 + run * (BN / 2);
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = finish(acc[i][run * 4 + jj], xx, l2 ? yn[run * (BN / 2) + tx * 4 + jj] : 0.0f,
                         metric);
        float* o = out + (size_t)row * c + col;
        if (vec_store && col + 4 <= c) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (col + jj < c) o[jj] = v[jj];
        }
      }
    }
    ++tile;
  }
}

int launch(const float* x, const float* y, float* out, int q, int c, int d, int metric,
           void* stream) {
  const int n_row_tiles = (q + BM - 1) / BM;
  const int n_col_tiles = (c + BN - 1) / BN;
  int tiles_per_block = 1;
  int err = bf16_tile::per_block(n_row_tiles, n_col_tiles, &tiles_per_block);
  if (err != 0) return err;
  const long long blocks =
      (long long)n_row_tiles * ((n_col_tiles + tiles_per_block - 1) / tiles_per_block);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need rows that start on 16-byte boundaries
  const bool vec = d % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0;
  const auto kernel = vec ? pairwise_kernel<true> : pairwise_kernel<false>;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, q, c, d, metric, n_row_tiles, tiles_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace exact

// ---------------------------------------------------------------------------
// Fast mode: bf16 operands on the tensor cores.

namespace fast {

using namespace bf16_tile;

// One thread of a consumer warpgroup.  The epilogue is what the kernel executes
// most of, so it is kept short: the dot metrics are one FFMA, alpha * dot +
// beta with (alpha, beta) = (-1, 1), (-1/2, 1/2), (-1, 0) -- the same single
// rounding as 1 - dot, (1 - dot) / 2 and -dot -- and a group that lies inside
// the matrix is stored without per-element bounds checks.  (A second
// accumulator set, so that a warpgroup's next product runs under its own
// stores, was tried: ptxas serializes the wgmmas of such a loop.)
template <bool L2>
struct Consumer {
  Ring* ring;
  Walk walk;
  Cursor cur;
  uint32_t ring_addr, x_addr, wg_off;
  int lane, tig, row_lo, q, c;
  bool root;  // L2: the square root (euclidean) or not (squared euclidean)
  float alpha, beta;
  const float* yn;
  float* out;
  float xx[2];

  // The next group of the ring: product, map, store.
  __device__ __forceinline__ void step(float (&acc)[64], int g) {
    const int held = group_start(acc, x_addr, wg_off, ring_addr, ring, cur, walk, lane);
    const int col0 = g * TILE_ROWS + 2 * tig;
    // |y|^2 of this thread's 32 columns, on their way while the product ends
    float yy[32];
    if (L2) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + 8 * j;
        yy[2 * j] = col < c ? yn[col] : 0.0f;
        yy[2 * j + 1] = col + 1 < c ? yn[col + 1] : 0.0f;
      }
    }
    group_finish(acc, ring, held, lane);
    // dots -> distances, in place (one copy of the arithmetic for both stores)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (L2) {
        // same evaluation order as the plain version: (x2 + y2) - 2 dot
        const float sq = fmaxf(
            __fsub_rn(__fadd_rn(xx[(i / 2) % 2], yy[2 * (i / 4) + i % 2]), 2.0f * acc[i]), 0.0f);
        acc[i] = root ? sqrtf(sq) : sq;
      } else {
        acc[i] = fmaf(alpha, acc[i], beta);
      }
    }
    const bool pairs = g * TILE_ROWS + TILE_ROWS <= c && c % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row >= q) continue;
      float* o = out + (size_t)row * c + col0;
      if (pairs) {  // inside the matrix, an even column of an even-width row: 8-byte aligned
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (col0 + 8 * j < c) o[8 * j] = acc[4 * j + 2 * h];
          if (col0 + 8 * j + 1 < c) o[8 * j + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
};

// blockIdx.x = query tile + n_q_tiles * (range of `groups_per_block` groups of
// 128 corpus rows).  xn / yn: f32 squared norms of the unrounded rows, read
// for the L2 metrics only.
template <bool L2>
__global__ void __launch_bounds__(bf16_tile::THREADS, 1)
pairwise_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_y,
                const float* __restrict__ xn, const float* __restrict__ yn,
                float* __restrict__ out, int q, int c, int metric, int n_q_tiles,
                int groups_per_block, Walk walk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + ALIGN - 1) / ALIGN * ALIGN);
  unsigned char* ring_tiles = tiles + query_tile_bytes(walk);
  Ring* ring = reinterpret_cast<Ring*>(ring_tiles + walk.stages * stage_bytes(walk));
  const uint32_t x_addr = smem_u32(tiles);
  const uint32_t ring_addr = smem_u32(ring_tiles);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = static_cast<int>(blockIdx.x % n_q_tiles) * TILE_ROWS;
  const int n_groups = (c + TILE_ROWS - 1) / TILE_ROWS;
  const int g0 = static_cast<int>(blockIdx.x / n_q_tiles) * groups_per_block;
  const int g1 = min(g0 + groups_per_block, n_groups);

  if (tid == 0) {
    init_ring(ring, walk.stages, CONSUMER_WARPS);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    give_registers<40>();
    if (tid == CONSUMER_WARPS * 32) {
      load_query_tile(&map_x, ring, x_addr, walk, row0);
      Cursor cur;
      for (int g = g0; g < g1; ++g)
        for (int kc = 0; kc < walk.nk; ++kc)
          load_chunk(&map_x, &map_y, ring, ring_addr, cur, walk, kc, row0, g * TILE_ROWS, 0);
    }
  } else {
    take_registers<232>();
    Consumer<L2> me;
    me.ring = ring;
    me.walk = walk;
    me.ring_addr = ring_addr;
    me.lane = lane;
    me.x_addr = x_addr;
    me.wg_off = (warp / 4) * WG_BYTES;
    me.row_lo = row0 + (warp / 4) * WG_ROWS + (warp % 4) * 16 + lane / 4;
    me.tig = lane % 4;
    me.q = q;
    me.c = c;
    me.root = metric == EUCLIDEAN;
    me.alpha = metric == NORMALIZED_COSINE ? -0.5f : -1.0f;
    me.beta = metric == NORMALIZED_COSINE ? 0.5f : (metric == COSINE ? 1.0f : 0.0f);
    me.yn = yn;
    me.out = out;
    me.xx[0] = me.xx[1] = 0.0f;
    if (L2) {
      if (me.row_lo < q) me.xx[0] = xn[me.row_lo];
      if (me.row_lo + 8 < q) me.xx[1] = xn[me.row_lo + 8];
    }
    float acc[64];
    wait_query_tile(ring, walk);
    for (int g = g0; g < g1; ++g) me.step(acc, g);
  }
}

int launch(const void* x, const void* y, const float* xn, const float* yn, float* out, int q,
           int c, int d, int metric, void* stream) {
  const Walk walk = plan_walk(d, sizeof(Ring));
  CUtensorMap map_x, map_y;
  int err = encode_map(&map_x, x, q, d);
  if (err == 0) err = encode_map(&map_y, y, c, d);
  if (err != 0) return err;
  const int n_q_tiles = (q + TILE_ROWS - 1) / TILE_ROWS;
  const int n_groups = (c + TILE_ROWS - 1) / TILE_ROWS;
  int groups_per_block = 1;
  err = per_block(n_q_tiles, n_groups, &groups_per_block);
  if (err != 0) return err;
  const long long blocks =
      (long long)n_q_tiles * ((n_groups + groups_per_block - 1) / groups_per_block);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(walk, sizeof(Ring));
  const auto kernel = is_l2(metric) ? pairwise_kernel<true> : pairwise_kernel<false>;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, bf16_tile::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_y, xn, yn, out, q, c, metric, n_q_tiles, groups_per_block, walk);
  return static_cast<int>(cudaGetLastError());
}

// rows [n, d_pad] bf16 = m [n, d] f32 rounded to nearest even, zero from
// column d on (d_pad: d rounded up to 8); NORMS: norms[r] = |m[r]|^2 of the
// UNROUNDED values, summed in fp64 and rounded once.  Eight lanes share a row;
// a lane turns pieces of 8 values (32 bytes in, 16 bytes out), so a row's reads
// and writes are contiguous.  VEC: rows start on 16-byte boundaries.
constexpr int PREP_LANES = 8;
constexpr int PREP_THREADS = 256;

template <bool VEC, bool NORMS>
__global__ void __launch_bounds__(PREP_THREADS)
operand_kernel(const float* __restrict__ m, uint4* __restrict__ rows, float* __restrict__ norms,
               long long n, int d, int d_pad) {
  const long long id = (long long)blockIdx.x * PREP_THREADS + threadIdx.x;
  const long long row = id / PREP_LANES;
  const int lane = static_cast<int>(id % PREP_LANES);
  const int pieces = d_pad / 8;
  double sum = 0.0;
  if (row < n) {
    const float* src = m + (size_t)row * d;
    uint4* dst = rows + (size_t)row * pieces;
    for (int piece = lane; piece < pieces; piece += PREP_LANES) {
      const int k = piece * 8;
      float v[8];
      if (VEC && k + 8 <= d) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(src + k));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(src + k) + 1);
        v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
        v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = k + e < d ? __ldg(src + k + e) : 0.0f;
      }
      unsigned words[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (NORMS) {
          sum = fma((double)v[2 * e], (double)v[2 * e], sum);
          sum = fma((double)v[2 * e + 1], (double)v[2 * e + 1], sum);
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        words[e] = *reinterpret_cast<const unsigned*>(&pair);
      }
      dst[piece] = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
  if (NORMS) {
#pragma unroll
    for (int step = PREP_LANES / 2; step > 0; step /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, step);
    if (lane == 0 && row < n) norms[row] = (float)sum;
  }
}

int prepare(const float* m, void* rows, float* norms, long long n, int d, int d_pad,
            void* stream) {
  if (d_pad != (d + 7) / 8 * 8 || reinterpret_cast<size_t>(rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n * PREP_LANES + PREP_THREADS - 1) / PREP_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && reinterpret_cast<size_t>(m) % 16 == 0;
  const auto kernel = vec ? (norms ? operand_kernel<true, true> : operand_kernel<true, false>)
                          : (norms ? operand_kernel<false, true> : operand_kernel<false, false>);
  kernel<<<(unsigned)blocks, PREP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<uint4*>(rows), norms, n, d, d_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fast

}  // namespace

// x [Q, D], y [C, D], out [Q, C], all f32.
extern "C" int pairwise_distance_f32(const float* x, const float* y, float* out, int q, int c,
                                     int d, int metric, void* stream) {
  return exact::launch(x, y, out, q, c, d, metric, stream);
}

// x [Q, D], y [C, D] bf16 with D a multiple of 8, 16-byte aligned; xn [Q], yn [C] f32 squared norms of the unrounded rows (read for
// the L2 metrics only; may be null otherwise); out [Q, C] f32.
extern "C" int pairwise_distance_bf16(const void* x, const void* y, const float* xn,
                                      const float* yn, float* out, int q, int c, int d,
                                      int metric, void* stream) {
  return fast::launch(x, y, xn, yn, out, q, c, d, metric, stream);
}

// m [n, d] f32 -> rows [n, d_pad] bf16 (d_pad = d rounded up to 8, 16-byte
// aligned) and, where norms is not null, norms [n] f32 = |m[r]|^2.
extern "C" int bf16_operand_f32(const float* m, void* rows, float* norms, long long n, int d,
                                int d_pad, void* stream) {
  return fast::prepare(m, rows, norms, n, d, d_pad, stream);
}
