// Fused distance scans with the bin-min reduction inside the kernel, for
// Hopper (sm_90a): [Q, D] x [C, D] -> (bin distance f32, bin column int32).
//
// The binned scan replaces parallel_hnsw_tpu/ops/pallas_scan.py::_scan_kernel:
// for corpus tile j (tile_c rows) and class l = column % 128, the minimum over
// the tile's tile_c / 128 groups of the surrogate t[q, c] = w[c] - s * dot(x[q],
// y[c]) and the first column that attains it; the metric's epilogue runs on
// the 128 minima only.  Output [Q, ceil(C / tile_c) * 128].
//
// The folded scan replaces pallas_scan.py::_folded_kernel: corpus tile
// s * n_jj + jj min-folds into slot s with a strict <, so the earliest tile
// wins a tie.  Output [Q, n_slots * 128] in surrogate space; the wrapper
// applies the epilogue.  On the TPU the fold relies on the grid running in
// order with the output block resident.  Here blocks run in any order, so one
// block owns (query tile, slot) and walks the slot's tiles in a loop with the
// running minima in registers.  No atomics: nothing depends on order.
//
// Both are one walk.  A block's *unit* is a contiguous span of corpus rows
// [unit * span, (unit + 1) * span): one tile for the binned scan, the n_jj
// consecutive tiles of a slot for the folded scan.  tile_c is a multiple of
// 128, so a class keeps its meaning across the span, and a strict < over the
// span's groups of 128 rows in order is exactly "first group within a tile,
// then earliest tile".  The two scans differ in the span and in whether the
// epilogue runs here (binned) or the surrogate is written raw (folded).
//
// s = 2 and w[c] = |y[c]|^2 for the L2 metrics, else s = 1 and w = 0; columns
// c >= C count as +inf (masked here, no padded copy of the corpus is made).
// Neither norm is an input: the f32 kernel sums |y[c]|^2 of each group of 128
// corpus rows, and |x|^2 of its query rows for the binned epilogue, from the
// chunks it has staged in shared memory for the product anyway; the bf16
// entries sum them in a pre-pass of the same launch (the L2 metrics are an
// instantiation of their own; the others carry none of it).
// Strict < from (+inf, first column of the class) keeps the first index on
// ties and reports that column for a class that is all padding.
//
// What bounds it on an H100: at the main shape (Q = 4096, C = 1,048,576,
// D = 128, tile_c = 4096) a scan reads 2 + 256 MiB of bf16 (twice that in
// f32) and writes 2 x 512 MiB of bins (~0.4 ms at 3.35 TB/s) but does
// 2 * Q * C * D = 1.1 TFLOP: it is bound by operations, 16.4 ms at the 67
// TFLOP/s fp32 peak in exact mode and 1.1 ms at the 989 TFLOP/s bf16
// tensor-core peak in fast mode.  The [Q, C] matrix (16 GiB at that shape)
// never exists: that is the point of the kernel.  In fast mode the second
// limit is the fold: about 4 ALU operations per (query, column) pair on top
// of a product that needs 1/8 of an issue slot per pair, so the fold has to
// run UNDER the tensor cores.  Every 128-row query tile pulls the corpus
// through L2 once (3.7 TB/s at the main shape, which L2 sustains).
//
// Two kernels, by operand type:
//
// * exact mode, f32 in (namespace simt): the shared-memory-tiled fp32 FFMA
//   product (64 x 64 tile, 256 threads, 4 x 4 micro-tile, D walked in chunks
//   of 16, dots summed as 8-FFMA partials like the plain version's matmul).
//   A block owns 64 query rows and one half (64) of the 128 classes of a
//   unit.  No path launches it yet (the flat scan is fast mode only).
// * fast mode, bf16 in (namespace wg): the mainloop of bf16_tile.cuh.  A
//   block of three warpgroups owns 128 query rows, loaded once by TMA and
//   resident in shared memory for the whole walk, and a range of consecutive
//   units.  The producer warpgroup streams the corpus through a ring of up to
//   eight 16 KB stages (TMA, an mbarrier pair per stage; rows past the corpus
//   arrive as zeros).  Two consumer warpgroups of 64 query rows each multiply
//   a group of 128 corpus rows with m64n128k16 wgmma (64 accumulator
//   registers a thread), hand the stages back and fold the group into running
//   (minimum, group index) pairs in registers while the OTHER warpgroup's
//   products occupy the tensor cores.  The fold is one FFMA (w - 2 dot), one
//   compare and two selects per pair for the L2 metrics; the other metrics
//   compare the dot itself (the surrogate is -dot) and negate at the end.
//   |y|^2 of the corpus rows (+inf past the corpus, so the L2 fold needs no
//   mask) and |x|^2 of the query rows are summed once per launch by a small
//   pre-pass kernel into scratch that the wrapper allocates; a group's 128
//   norms then ride into shared memory on the barrier of its last chunk.
//   Rows must be a multiple of 16 bytes for the tensor maps: the wrapper
//   zero-pads D to a multiple of 8.  Rows too wide for the query tile to stay
//   resident beside three stages (D > 640) stream it through the stages
//   beside the corpus chunks (bf16_tile.cuh), so any D is taken.
//
// In both, a thread meets the same (row, class) pairs in every group of 128
// corpus rows, so the reduction never leaves the thread.  Query tiles vary
// fastest across the grid, so the blocks resident together read the same
// corpus rows and share them in L2.
//
// What is left in the fast mode (NVIDIA H100 80GB HBM3, 700 W): the tensor
// cores are 47% busy, because a warpgroup waits for its 8 wgmmas and then
// folds.  Tried and measured without gain: named-barrier turns between the
// warpgroups, two m64n64 halves in flight per warpgroup (ptxas serializes
// the wgmmas of such a loop and spills), clusters of two blocks sharing each
// corpus chunk by TMA multicast (so L2 traffic is not the limit).  Untried:
// the query fragments in registers, and the survivor cut fused behind the
// fold.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

#include "bf16_tile.cuh"

namespace {

constexpr int LANES = 128;  // congruence classes per corpus tile (semantic, not a hardware width)
constexpr int THREADS = 256;

// Metric codes; parallel_hnsw_tpu_torch/ops/cuda_scan.py passes the same.
constexpr int COSINE = 0;
constexpr int NORMALIZED_COSINE = 1;
constexpr int EUCLIDEAN = 2;
constexpr int SQUARED_EUCLIDEAN = 3;
constexpr int DOT = 4;

__host__ __device__ __forceinline__ bool is_l2(int metric) {
  return metric == EUCLIDEAN || metric == SQUARED_EUCLIDEAN;
}

// Monotone map from a surrogate minimum to the distance (xx = |x|^2, L2 only).
__device__ __forceinline__ float finish_bin(float t, float xx, int metric) {
  switch (metric) {
    case COSINE:
      return 1.0f + t;
    case NORMALIZED_COSINE:
      return 0.5f + 0.5f * t;
    case DOT:
      return t;
    default: {
      const float sq = fmaxf(__fadd_rn(xx, t), 0.0f);
      return metric == SQUARED_EUCLIDEAN ? sq : sqrtf(sq);
    }
  }
}

// The surrogate of one (query, corpus column) pair folded into a running
// minimum.  scale is 1 or 2, so the product is exact and w - s * dot rounds once.
__device__ __forceinline__ void fold(float dot, float wc, float scale, bool real, int col,
                                     float& best_t, int& best_col) {
  const float t = real ? __fsub_rn(wc, scale * dot) : CUDART_INF_F;
  if (t < best_t) {
    best_t = t;
    best_col = col;
  }
}

// Rows of the unit's span that exist, in groups of LANES.
__device__ __forceinline__ int groups_in_span(int base, int span, int c) {
  const int end = min(base + span, c);
  return end > base ? (end - base + LANES - 1) / LANES : 0;
}

// ---------------------------------------------------------------------------
// Exact mode: f32 operands, fp32 FFMA.

namespace simt {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // classes per block: one half of LANES
constexpr int BK = 16;    // D-chunk per shared-memory stage
constexpr int TM = 4;     // micro-tile rows per thread
constexpr int TN = 4;     // micro-tile classes per thread
constexpr int KPART = 8;  // FFMA chain length before a partial joins the running sum
constexpr int PAD = 4;    // keeps float4 alignment, halves bank conflicts on the stores
constexpr int HALVES = LANES / BN;
static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile per thread");

// RAW: write surrogate minima (folded scan; the wrapper maps them); else
// apply the metric's epilogue here (binned scan).  L2: the metric is one of
// the L2 family, so the surrogate needs |y|^2 and the epilogue |x|^2.
// blockIdx.x = query tile + n_q_tiles * (HALVES * unit + half).
// Three blocks per SM: capped at 80 registers the kernel spills a few bytes
// but runs faster on an H100 than at the 117 registers it takes unbounded
// (two blocks per SM).
template <bool RAW, bool L2>
__global__ void __launch_bounds__(THREADS, 3)
scan_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ outd,
            int* __restrict__ outi, int q, int c, int d, int span, int n_q_tiles, int out_width,
            int metric) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float ys[BK][BN + PAD];
  __shared__ float wsm[BN];   // |y|^2 of the group's rows (L2)
  __shared__ float x2sm[BM];  // |x|^2 of the block's rows (L2, binned)

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // micro-tile class group
  const int ty = tid / (BN / TN);  // micro-tile row group
  const int row0 = static_cast<int>(blockIdx.x % n_q_tiles) * BM;
  const int rest = blockIdx.x / n_q_tiles;
  const int lane0 = (rest % HALVES) * BN;
  const int unit = rest / HALVES;
  const int base = unit * span;  // < C rounded up to units: fits an int (the wrapper checks)
  const int n_groups = groups_in_span(base, span, c);
  const float scale = L2 ? 2.0f : 1.0f;
  // loader mapping: consecutive threads read consecutive elements of a row
  const int lk = tid % BK;
  const int lr = tid / BK;
  constexpr int ROW_STEP = THREADS / BK;  // 16 rows per load pass

  float best_t[TM][TN];
  int best_col[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      best_t[i][j] = CUDART_INF_F;
      best_col[i][j] = base + lane0 + tx * TN + j;
    }

  for (int g = 0; g < n_groups; ++g) {
    // corpus row of this block's first class; at most C rounded up to units
    const int col0 = base + g * LANES + lane0;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    // L2: threads 0..BN-1 sum |y|^2 of one staged corpus row each; in the
    // first group the next BM threads sum |x|^2 of one query row each
    // (rows and chunks past the matrix are staged as zeros)
    float norm = 0.0f;
    const bool sums_x = !RAW && g == 0 && tid >= BN && tid < BN + BM;

    for (int k0 = 0; k0 < d; k0 += BK) {
      const int k = k0 + lk;
#pragma unroll
      for (int r = lr; r < BM; r += ROW_STEP) {
        const int gx = row0 + r;
        xs[lk][r] = (gx < q && k < d) ? x[(size_t)gx * d + k] : 0.0f;
      }
#pragma unroll
      for (int r = lr; r < BN; r += ROW_STEP) {
        const long long gy = (long long)col0 + r;
        ys[lk][r] = (gy < c && k < d) ? y[(size_t)gy * d + k] : 0.0f;
      }
      __syncthreads();

      if (L2) {
        if (tid < BN) {
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) norm = fmaf(ys[kk][tid], ys[kk][tid], norm);
        } else if (sums_x) {
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) norm = fmaf(xs[kk][tid - BN], xs[kk][tid - BN], norm);
        }
      }

#pragma unroll
      for (int k8 = 0; k8 < BK; k8 += KPART) {
        float part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
#pragma unroll
        for (int kk = k8; kk < k8 + KPART; ++kk) {
          const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
          const float4 b4 = *reinterpret_cast<const float4*>(&ys[kk][tx * TN]);
          const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
          const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
      }
      __syncthreads();
    }

    if (L2) {
      // the previous group's fold read wsm before the barriers of this
      // group's chunks
      if (tid < BN) wsm[tid] = norm;
      else if (sums_x) x2sm[tid - BN] = norm;
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long col = (long long)col0 + tx * TN + j;
      const bool real = col < c;
      const float wc = L2 ? wsm[tx * TN + j] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        fold(acc[i][j], wc, scale, real, static_cast<int>(col), best_t[i][j], best_col[i][j]);
    }
  }

  const size_t out_col = (size_t)unit * LANES + lane0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= q) break;
    const float xx = (!RAW && L2 && n_groups > 0) ? x2sm[ty * TM + i] : 0.0f;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = RAW ? best_t[i][j] : finish_bin(best_t[i][j], xx, metric);
    const size_t o = (size_t)row * out_width + out_col;  // a multiple of 4: 16-byte aligned
    *reinterpret_cast<float4*>(outd + o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(outi + o) =
        make_int4(best_col[i][0], best_col[i][1], best_col[i][2], best_col[i][3]);
  }
}

template <bool RAW>
int launch(const void* x, const void* y, float* outd, int* outi, int q, int c, int d, int span,
           int n_units, int metric, void* stream) {
  const int n_q_tiles = (q + BM - 1) / BM;
  const unsigned blocks = (unsigned)n_q_tiles * n_units * HALVES;
  const auto kernel = is_l2(metric) ? scan_kernel<RAW, true> : scan_kernel<RAW, false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), outd, outi, q, c, d, span,
      n_q_tiles, n_units * LANES, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// Fast mode: bf16 operands on the tensor cores (wgmma), fed by TMA.

namespace wg {

using namespace bf16_tile;

constexpr int THREADS = bf16_tile::THREADS;  // 384, not the f32 kernel's 256
constexpr int NORM_SLOTS = MAX_STAGES + 1;  // see the producer: one more than groups in flight
constexpr int NORM_LANES = 8;               // lanes that share a row in row_sq_norms

// Shared memory beside the tiles.
struct Ctrl {
  Ring ring;
  alignas(16) float w[NORM_SLOTS][LANES];  // |y|^2 per corpus row of a group (L2)
};

// out[r] = sum of squares of row r of m [rows, d] (bf16, d a multiple of 8,
// rows 16-byte aligned) in f32, and +inf for r in [rows, padded_rows): a row
// past the matrix never wins a minimum.  Eight lanes share a row and read
// consecutive 16-byte pieces.
__global__ void row_sq_norms(const uint4* __restrict__ m, int rows, int d, int padded_rows,
                             float* __restrict__ out) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = id / NORM_LANES;
  const int piece0 = static_cast<int>(id % NORM_LANES);
  const int pieces = d / 8;
  float sum[2] = {0.0f, 0.0f};
  if (row < rows) {
    const uint4* src = m + (size_t)row * pieces;
    for (int piece = piece0; piece < pieces; piece += NORM_LANES) {
      const uint4 v = __ldg(src + piece);
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = __uint_as_float(words[i] << 16);
        const float hi = __uint_as_float(words[i] & 0xffff0000u);
        sum[0] = fmaf(lo, lo, sum[0]);
        sum[1] = fmaf(hi, hi, sum[1]);
      }
    }
  }
  float total = sum[0] + sum[1];
#pragma unroll
  for (int step = NORM_LANES / 2; step > 0; step /= 2)
    total += __shfl_xor_sync(0xffffffffu, total, step);
  if (piece0 == 0 && row < padded_rows) out[row] = row < rows ? total : CUDART_INF_F;
}

// RAW and L2 as in simt::scan_kernel.  blockIdx.x = query tile + n_q_tiles *
// (range of `units_per_block` consecutive units).  The units of a block are
// contiguous corpus rows, so the producer streams groups of 128 rows from the
// first unit's base to the end of the last (or of the corpus) without regard
// to unit borders; the consumers reset their running minima at each border.
// w [C rounded up to 128] and x2 [Q]: row_sq_norms of y and x (L2 only).
template <bool RAW, bool L2>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_y,
            const float* __restrict__ w, const float* __restrict__ x2,
            float* __restrict__ outd, int* __restrict__ outi, int q, int c, int span,
            int n_q_tiles, int n_units, int units_per_block, int metric, Walk walk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + ALIGN - 1) / ALIGN * ALIGN);
  unsigned char* ring_tiles = tiles + query_tile_bytes(walk);
  Ctrl* ctrl = reinterpret_cast<Ctrl*>(ring_tiles + walk.stages * stage_bytes(walk));
  const uint32_t x_addr = smem_u32(tiles);
  const uint32_t ring_addr = smem_u32(ring_tiles);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = static_cast<int>(blockIdx.x % n_q_tiles) * TILE_ROWS;
  const int u0 = static_cast<int>(blockIdx.x / n_q_tiles) * units_per_block;
  const int u1 = min(u0 + units_per_block, n_units);
  const int norm_slots = walk.stages + 1;

  if (tid == 0) {
    init_ring(&ctrl->ring, walk.stages, CONSUMER_WARPS);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer warpgroup: its first thread keeps the ring full
    give_registers<40>();
    if (tid == CONSUMER_WARPS * 32) {
      load_query_tile(&map_x, &ctrl->ring, x_addr, walk, row0);
      // the block's groups: rows [u0 * span, min(u1 * span, c)) in steps of 128
      // (u1 * span fits an int: the wrapper checks C rounded up to units)
      const int end_row = min(u1 * span, c);
      Ring* ring = &ctrl->ring;
      Cursor cur;
      int slot = 0;
      for (int row = u0 * span; row < end_row; row += LANES) {
        for (int kc = 0; kc < walk.nk; ++kc) {
          // L2: the group's |y|^2 ride on the barrier of its last chunk.  A
          // slot is rewritten stages + 1 groups later; by then the consumers
          // have handed back a chunk of a later group than that slot's, so
          // they are past its fold.
          const bool with_w = L2 && kc == walk.nk - 1;
          uint64_t* full = load_chunk(&map_x, &map_y, ring, ring_addr, cur, walk, kc, row0, row,
                                      with_w ? LANES * 4 : 0);
          if (with_w) {
            bulk_load(smem_u32(ctrl->w[slot]), w + row, LANES * 4, full);
            if (++slot == norm_slots) slot = 0;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    take_registers<232>();
    const int wgi = warp / 4, wiw = warp % 4;
    const int grp = lane / 4, tig = lane % 4;
    const int lrow = wgi * WG_ROWS + wiw * 16 + grp;  // and lrow + 8
    const uint32_t wg_off = wgi * WG_BYTES;
    Cursor cur;
    int slot = 0;
    float acc[64];
    wait_query_tile(&ctrl->ring, walk);

    for (int unit = u0; unit < u1; ++unit) {
      const int base = unit * span;
      const int n_groups = groups_in_span(base, span, c);
      // L2: running minimum of w - 2 dot; else running MAXIMUM of the dot,
      // negated at the end (-dot is the surrogate: same order, same ties)
      float best[64];
      int best_g[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        best[i] = L2 ? CUDART_INF_F : -CUDART_INF_F;
        best_g[i] = 0;
      }
      for (int g = 0; g < n_groups; ++g) {
        const int held =
            group_start(acc, x_addr, wg_off, ring_addr, &ctrl->ring, cur, walk, lane);
        group_finish(acc, &ctrl->ring, held, lane);
        if (L2) {
          const float* ws = ctrl->w[slot];  // arrived with the group's last chunk
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 wv = *reinterpret_cast<const float2*>(ws + 8 * j + 2 * tig);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h;
              const float t0 = fmaf(-2.0f, acc[i], wv.x);  // w - 2 dot, rounded once
              const float t1 = fmaf(-2.0f, acc[i + 1], wv.y);
              if (t0 < best[i]) {
                best[i] = t0;
                best_g[i] = g;
              }
              if (t1 < best[i + 1]) {
                best[i + 1] = t1;
                best_g[i + 1] = g;
              }
            }
          }
          if (++slot == norm_slots) slot = 0;
        } else {
          const int col0 = base + g * LANES;
          if (col0 + LANES > c) {  // the corpus ends inside this group
#pragma unroll
            for (int i = 0; i < 64; ++i)
              if (col0 + 8 * (i / 4) + 2 * tig + i % 2 >= c) acc[i] = -CUDART_INF_F;
          }
#pragma unroll
          for (int i = 0; i < 64; ++i)
            if (acc[i] > best[i]) {
              best[i] = acc[i];
              best_g[i] = g;
            }
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + lrow + 8 * h;
        if (row >= q) continue;
        const float xx = (!RAW && L2) ? x2[row] : 0.0f;
        const size_t o = (size_t)row * n_units * LANES + (size_t)unit * LANES + 2 * tig;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = 4 * j + 2 * h;
          float t0 = L2 ? best[i] : -best[i];
          float t1 = L2 ? best[i + 1] : -best[i + 1];
          if (!RAW) {
            t0 = finish_bin(t0, xx, metric);
            t1 = finish_bin(t1, xx, metric);
          }
          const int col = base + 8 * j + 2 * tig;
          // an even column of a row whose width is a multiple of 128: 8-byte aligned
          *reinterpret_cast<float2*>(outd + o + 8 * j) = make_float2(t0, t1);
          *reinterpret_cast<int2*>(outi + o + 8 * j) =
              make_int2(col + best_g[i] * LANES, col + 1 + best_g[i + 1] * LANES);
        }
      }
    }
  }
}

// x [Q, D], y [C, D] bf16 with D a multiple of 8, both 16-byte aligned; else
// an error code.  scratch: room for C rounded up to 128, plus Q,
// floats, written and read for the L2 metrics only.
template <bool RAW>
int launch(const void* x, const void* y, float* outd, int* outi, float* scratch, int q, int c,
           int d, int span, int n_units, int metric, void* stream) {
  const Walk walk = plan_walk(d, sizeof(Ctrl));
  CUtensorMap map_x, map_y;
  int err = encode_map(&map_x, x, q, d);
  // an empty corpus (folded scan: every slot is padding) is never loaded
  if (err == 0) err = encode_map(&map_y, c > 0 ? y : x, c > 0 ? c : 1, d);
  if (err != 0) return err;
  const int n_q_tiles = (q + TILE_ROWS - 1) / TILE_ROWS;
  int units_per_block = 1;
  err = per_block(n_q_tiles, n_units, &units_per_block);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)n_q_tiles * ((n_units + units_per_block - 1) / units_per_block);
  const int smem = smem_bytes(walk, sizeof(Ctrl));
  const auto kernel = is_l2(metric) ? scan_kernel<RAW, true> : scan_kernel<RAW, false>;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int padded_c = (c + LANES - 1) / LANES * LANES;
  if (is_l2(metric)) {
    // the norms, once per launch: one pass over the operands as stored
    const auto norm_blocks = [](long long rows) {
      return (unsigned)((rows * NORM_LANES + 255) / 256);
    };
    if (c > 0)
      row_sq_norms<<<norm_blocks(padded_c), 256, 0, s>>>(static_cast<const uint4*>(y), c, d,
                                                          padded_c, scratch);
    if (!RAW)
      row_sq_norms<<<norm_blocks(q), 256, 0, s>>>(static_cast<const uint4*>(x), q, d, q,
                                                   scratch + padded_c);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  kernel<<<blocks, THREADS, smem, s>>>(map_x, map_y, scratch, scratch + padded_c, outd, outi, q, c,
                                       span, n_q_tiles, n_units, units_per_block, metric, walk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// x [Q, D], y [C, D]: f32 (_f32) or bf16 (_bf16).
// outd / outi: [Q, ceil(C / tile_c) * 128].
extern "C" int binned_scan_f32(const void* x, const void* y, float* outd, int* outi, int q, int c,
                               int d, int tile_c, int metric, void* stream) {
  return simt::launch<false>(x, y, outd, outi, q, c, d, tile_c, (c + tile_c - 1) / tile_c, metric,
                             stream);
}

// scratch: C rounded up to 128, plus Q, floats for the norms of the L2 metrics
// (null for the others).
extern "C" int binned_scan_bf16(const void* x, const void* y, float* outd, int* outi,
                                float* scratch, int q, int c, int d, int tile_c, int metric,
                                void* stream) {
  return wg::launch<false>(x, y, outd, outi, scratch, q, c, d, tile_c, (c + tile_c - 1) / tile_c,
                           metric, stream);
}

// outt / outi: [Q, n_slots * 128]; outt holds surrogate minima (no epilogue).
// Slot s covers the n_jj corpus tiles from s * n_jj on.
extern "C" int folded_scan_f32(const void* x, const void* y, float* outt, int* outi, int q, int c,
                               int d, int tile_c, int n_slots, int n_jj, int metric,
                               void* stream) {
  return simt::launch<true>(x, y, outt, outi, q, c, d, n_jj * tile_c, n_slots, metric, stream);
}

extern "C" int folded_scan_bf16(const void* x, const void* y, float* outt, int* outi,
                                float* scratch, int q, int c, int d, int tile_c, int n_slots,
                                int n_jj, int metric, void* stream) {
  return wg::launch<true>(x, y, outt, outi, scratch, q, c, d, n_jj * tile_c, n_slots, metric,
                          stream);
}
