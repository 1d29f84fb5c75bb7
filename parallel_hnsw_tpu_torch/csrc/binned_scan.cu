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
// * exact mode, f32 in (namespace simt): the fp32 FFMA mainloop of
//   pairwise_distance.cu's exact kernel (128 x 128 tile, 256 threads, 8 x 8
//   micro-tile, a three-stage ring of 16-byte cp.async, XOR-swizzled
//   row-major staging, dots summed as 8-FFMA partials like the plain
//   version's matmul; the L2 norms summed in fp64 from the staged chunks).  A
//   block owns 128 query rows and all 128 classes of one unit, and runs its
//   ring flat over the unit's groups.  A thread's 64 running (minimum,
//   column) pairs live in its own slots of shared memory (128 KB a block):
//   64 accumulators, 64 partials and 36 fragment registers leave no room for
//   them in registers, and the fold that reads them is one load and one
//   compare per pair and group, a few percent of the group's FFMAs.  No
//   caller in either package passes exact=True yet.
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
// fold.  The exact mode runs at half the FFMA peak, like the pairwise kernel
// whose loop it shares the design of (32.5 ms binned at the main shape).
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

// Rows of the unit's span that exist, in groups of LANES.
__device__ __forceinline__ int groups_in_span(int base, int span, int c) {
  const int end = min(base + span, c);
  return end > base ? (end - base + LANES - 1) / LANES : 0;
}

// ---------------------------------------------------------------------------
// Exact mode: f32 operands, fp32 FFMA.

namespace simt {

// The fp32 mainloop of pairwise_distance.cu's exact kernel, with the fold in
// place of the store: a block owns 128 query rows and all 128 classes of one
// unit; a thread an 8 x 8 micro-tile (rows ty * 8 + i, classes tx * 4 + j and
// 64 + tx * 4 + j); operands staged row-major by 16-byte cp.async (4-byte
// copies for rows that are not 16-byte multiples or unaligned), 32 values of D
// per row and stage, XOR-swizzled, in a ring of three stages that runs flat
// over the unit's groups of 128 corpus rows.
constexpr int BM = 128;   // query rows per block
constexpr int BK = 32;    // values of D per row and stage: 128 bytes
constexpr int TM = 8;     // micro-tile rows per thread
constexpr int TN = 8;     // micro-tile classes per thread: two runs of four, 64 apart
constexpr int KPART = 8;  // FFMA chain length before a partial joins the running sum
constexpr int STAGES = 3;
constexpr int ROW_BYTES = BK * 4;
constexpr int PIECES = ROW_BYTES / 16;  // 16-byte pieces per staged row
constexpr int TILE_BYTES = BM * ROW_BYTES;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // the query tile, then the group's corpus rows
// running (minimum, column) of every (row, class) pair, thread-major
constexpr int BEST_BYTES = TM * TN * THREADS * 8;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + BEST_BYTES + (BM + LANES) * 4;
static_assert((BM / TM) * (LANES / TN) == THREADS, "one micro-tile per thread");
static_assert(THREADS == BM + LANES, "one thread sums the norm of each staged row");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");

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

// RAW: write surrogate minima (folded scan; the wrapper maps them); else
// apply the metric's epilogue here (binned scan).  L2: the metric is one of
// the L2 family, so the surrogate needs |y|^2 and the epilogue |x|^2.
// blockIdx.x = query tile + n_q_tiles * unit.
template <bool RAW, bool L2, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ outd,
            int* __restrict__ outi, int q, int c, int d, int span, int n_q_tiles, int out_width,
            int metric) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the running pairs stay in shared memory, each thread's own: beside 64
  // accumulators, 64 partials and 36 fragment registers, 128 more would spill
  float* best_t = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);  // [TM * TN][THREADS]
  int* best_col = reinterpret_cast<int*>(best_t + TM * TN * THREADS);
  float* xn = reinterpret_cast<float*>(best_col + TM * TN * THREADS);  // |x|^2 (L2, binned)
  float* yn = xn + BM;                                                 // |y|^2 of the group (L2)
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int tx = tid % (LANES / TN);  // class group
  const int ty = tid / (LANES / TN);  // row group
  const int row0 = static_cast<int>(blockIdx.x % n_q_tiles) * BM;
  const int unit = static_cast<int>(blockIdx.x / n_q_tiles);
  const int base = unit * span;  // < C rounded up to units: fits an int (the wrapper checks)
  const int n_groups = groups_in_span(base, span, c);
  const int nk = (d + BK - 1) / BK;
  const int total = n_groups * nk;  // (group, chunk) pairs, one flat pipeline
  const float scale = L2 ? 2.0f : 1.0f;
  auto cls = [&](int j) { return (j / 4) * (LANES / 2) + tx * 4 + j % 4; };

#pragma unroll
  for (int e = 0; e < TM * TN; ++e) {
    best_t[e * THREADS + tid] = CUDART_INF_F;
    best_col[e * THREADS + tid] = base + cls(e % TN);
  }

  // the loader's cursor runs STAGES - 1 chunks ahead of the multiplier's
  int l_n = 0, l_group = 0, l_kc = 0, l_stage = 0;
  auto load_next = [&]() {
    if (l_n < total) {
      const uint32_t stage = smem_addr + l_stage * STAGE_BYTES;
      load_tile<VEC>(stage, x, row0, q, d, l_kc * BK, tid);
      load_tile<VEC>(stage + TILE_BYTES, y, base + l_group * LANES, c, d, l_kc * BK, tid);
      ++l_n;
      if (++l_kc == nk) {
        l_kc = 0;
        ++l_group;
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
  // norms: threads [0, 128) sum a query row each (the first group, binned
  // only), [128, 256) a corpus row
  const int n_row = tid % BM;
  const int n_base = (tid / BM) * TILE_BYTES + n_row * ROW_BYTES;

  float acc[TM][TN];
  double norm[4] = {0.0, 0.0, 0.0, 0.0};  // four chains: the fp64 pipe is slow to turn around
  int g = 0, kc = 0, stage_i = 0;
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
    const bool sums = L2 && (tid >= BM || (!RAW && g == 0));

    if (sums) {
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
              stage + b_base + (j / 4) * (LANES / 2) * ROW_BYTES + (j % 4) * ROW_BYTES +
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

    // the group's dots are complete: fold them into the running pairs
    if (L2) {
      // the previous group's fold read yn before this group's barriers
      if (sums) (tid < BM ? xn : yn)[n_row] = (float)((norm[0] + norm[1]) + (norm[2] + norm[3]));
      __syncthreads();
    }
    const int col0 = base + g * LANES;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + cls(j);  // at most C rounded up to units: fits an int
      const bool real = col < c;
      const float wc = L2 ? yn[cls(j)] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        // the surrogate w - s * dot (s is 1 or 2: the product is exact, one
        // rounding) folded in with a strict <; a store only where it improves
        const int e = (i * TN + j) * THREADS + tid;
        const float t = real ? __fsub_rn(wc, scale * acc[i][j]) : CUDART_INF_F;
        if (t < best_t[e]) {
          best_t[e] = t;
          best_col[e] = col;
        }
      }
    }
    ++g;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= q) break;
    const float xx = (!RAW && L2 && n_groups > 0) ? xn[ty * TM + i] : 0.0f;
#pragma unroll
    for (int run = 0; run < 2; ++run) {
      float v[4];
      int col[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = (i * TN + run * 4 + jj) * THREADS + tid;
        v[jj] = RAW ? best_t[e] : finish_bin(best_t[e], xx, metric);
        col[jj] = best_col[e];
      }
      // a multiple of 4: 16-byte aligned
      const size_t o = (size_t)row * out_width + (size_t)unit * LANES + run * (LANES / 2) + tx * 4;
      *reinterpret_cast<float4*>(outd + o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(outi + o) = make_int4(col[0], col[1], col[2], col[3]);
    }
  }
}

template <bool RAW, bool L2>
int launch_as(bool vec, const float* x, const float* y, float* outd, int* outi, int q, int c,
              int d, int span, int n_units, int metric, cudaStream_t stream) {
  const auto kernel = vec ? scan_kernel<RAW, L2, true> : scan_kernel<RAW, L2, false>;
  const int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (err != 0) return err;
  const int n_q_tiles = (q + BM - 1) / BM;
  const long long blocks = (long long)n_q_tiles * n_units;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(x, y, outd, outi, q, c, d, span,
                                                           n_q_tiles, n_units * LANES, metric);
  return static_cast<int>(cudaGetLastError());
}

template <bool RAW>
int launch(const void* x, const void* y, float* outd, int* outi, int q, int c, int d, int span,
           int n_units, int metric, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  // 16-byte copies need rows that start on 16-byte boundaries
  const bool vec = d % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_l2(metric) ? launch_as<RAW, true>(vec, xf, yf, outd, outi, q, c, d, span, n_units, metric, s)
                       : launch_as<RAW, false>(vec, xf, yf, outd, outi, q, c, d, span, n_units, metric, s);
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
