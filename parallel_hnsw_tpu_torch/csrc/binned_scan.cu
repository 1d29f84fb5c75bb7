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
// Neither norm is an input: a block sums |y[c]|^2 of each group of 128 corpus
// rows, and |x|^2 of its query rows for the binned epilogue, in f32 from the
// chunks it has staged in shared memory for the product anyway (the L2
// metrics are an instantiation of their own; the others carry none of it).
// Strict < from (+inf, first column of the class) keeps the first index on
// ties and reports that column for a class that is all padding.
//
// What bounds it on an H100: at the main shape (Q = 4096, C = 1,048,576,
// D = 128, tile_c = 4096) a scan reads 2 + 256 MiB of bf16 (twice that in
// f32) and writes 2 x 512 MiB of bins (~0.4 ms at 3.35 TB/s) but does
// 2 * Q * C * D = 1.1 TFLOP: it is bound by operations, 16.4 ms at the 67
// TFLOP/s fp32 peak in exact mode and 1.1 ms at the 989 TFLOP/s bf16
// tensor-core peak in fast mode.  The [Q, C] matrix (16 GiB at that shape)
// never exists: that is the point of the kernel.
//
// Two kernels, by operand type:
//
// * exact mode, f32 in: the shared-memory-tiled fp32 FFMA product of
//   pairwise_distance.cu (64 x 64 tile, 256 threads, 4 x 4 micro-tile, D
//   walked in chunks of 16, dots summed as 8-FFMA partials like the plain
//   version's matmul).  A block owns 64 query rows and one half (64) of the
//   128 classes of a unit.
// * fast mode, bf16 in: the tensor cores (mma.sync m16n8k16, f32 accumulate;
//   products of bf16 values are exact in f32).  A block owns 64 query rows
//   and all 128 classes of a unit; 8 warps as 2 x 4, each a 32 x 32 warp tile
//   = 2 x 4 mma tiles.  Operands go global -> registers -> shared memory in
//   chunks of 32 along D, two buffers: the next chunk's loads are in flight
//   while the tensor cores work on this one, one barrier per chunk.  Rows are
//   40 bf16 (80 bytes) apart in shared memory, so the eight 16-byte rows of
//   an ldmatrix phase fall into eight different bank groups.
//
// In both, a thread meets the same (row, class) pairs in every group of 128
// corpus rows, so it compares its fresh surrogates with running (minimum,
// column) pairs in its own registers: the reduction never leaves the thread.
// Query tiles vary fastest across the grid, so the blocks resident together
// read the same corpus rows and share them in L2.
//
// Later work for the fast mode: cp.async or TMA in place of the register
// staging, more stages, and wgmma (mma.sync cannot reach the full rate).
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

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
// Fast mode: bf16 operands on the tensor cores.

namespace mma {

constexpr int BM = 64;                    // query rows per block
constexpr int BN = LANES;                 // all classes of the unit
constexpr int BK = 32;                    // D-chunk per shared-memory stage
constexpr int SKEW = 8;                   // row stride 40 bf16: conflict-free ldmatrix
constexpr int WM = 32, WN = 32;           // warp tile
constexpr int MI = WM / 16, NI = WN / 8;  // mma tiles per warp tile
constexpr int SEGS = BK / 8;              // 16-byte segments per staged row
constexpr int XV = BM * SEGS / THREADS;   // 16-byte loads per thread and chunk: 1
constexpr int YV = BN * SEGS / THREADS;   // 2
static_assert((BM / WM) * (BN / WN) * 32 == THREADS, "one warp tile per warp");

// Eight consecutive bf16 of row `row` from column k, zero beyond the matrix.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ m, long long row,
                                       int n_rows, int k, int d, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= n_rows || k >= d) return v;
  const __nv_bfloat16* p = m + (size_t)row * d + k;
  if (vec && k + 8 <= d) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = (k + e < d) ? __bfloat16_as_ushort(p[e]) : 0u;
  v.x = h[0] | (h[1] << 16);
  v.y = h[2] | (h[3] << 16);
  v.z = h[4] | (h[5] << 16);
  v.w = h[6] | (h[7] << 16);
  return v;
}

// Four 8 x 8 bf16 matrices from shared memory, one 16-byte row per lane:
// matrices 0..3 from the rows that lanes 0-7, 8-15, 16-23, 24-31 hand in.
__device__ __forceinline__ void ldmatrix_x4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                            const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// acc + the squares of the eight bf16 packed in v, in f32.
__device__ __forceinline__ float add_squares(uint4 v, float acc) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(words[i] << 16);
    const float hi = __uint_as_float(words[i] & 0xffff0000u);
    acc = fmaf(lo, lo, acc);
    acc = fmaf(hi, hi, acc);
  }
  return acc;
}

// c[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// RAW and L2 as in simt::scan_kernel.  blockIdx.x = query tile + n_q_tiles * unit.
// In the accumulator fragment of an mma tile, lane (grp, tig) holds rows
// grp and grp + 8 at columns 2 * tig and 2 * tig + 1: element e is row
// grp + 8 * (e / 2), column 2 * tig + e % 2.
template <bool RAW, bool L2>
__global__ void __launch_bounds__(THREADS, 2)
scan_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
            float* __restrict__ outd, int* __restrict__ outi, int q, int c, int d, int span,
            int n_q_tiles, int out_width, int metric, int vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][BK + SKEW];
  __shared__ __align__(16) __nv_bfloat16 ys[2][BN][BK + SKEW];
  __shared__ float wsm[BN];   // |y|^2 of the group's rows (L2)
  __shared__ float x2sm[BM];  // |x|^2 of the block's rows (L2, binned)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int grp = lane / 4, tig = lane % 4;
  const int row0 = static_cast<int>(blockIdx.x % n_q_tiles) * BM;
  const int unit = blockIdx.x / n_q_tiles;
  const int base = unit * span;  // < C rounded up to units: fits an int (the wrapper checks)
  const int n_groups = groups_in_span(base, span, c);
  const int nk = (d + BK - 1) / BK;
  const float scale = L2 ? 2.0f : 1.0f;

  float acc[MI][NI][4];
  float best_t[MI][NI][4];
  int best_col[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.0f;
        best_t[mi][ni][e] = CUDART_INF_F;
        best_col[mi][ni][e] = base + wn * WN + ni * 8 + tig * 2 + e % 2;
      }

  // staging: thread -> (row, 16-byte segment) of the x and y chunks
  uint4 sx[XV], sy[YV];
  int pg = 0, pk = 0;  // the next chunk to fetch: group, chunk along D
  auto fetch = [&]() {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * THREADS;
      sx[v] = load8(x, row0 + idx / SEGS, q, pk * BK + (idx % SEGS) * 8, d, vec);
    }
#pragma unroll
    for (int v = 0; v < YV; ++v) {
      const int idx = tid + v * THREADS;
      sy[v] = load8(y, (long long)base + (long long)pg * LANES + idx / SEGS, c,
                    pk * BK + (idx % SEGS) * 8, d, vec);
    }
    if (++pk == nk) {
      pk = 0;
      ++pg;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * THREADS;
      *reinterpret_cast<uint4*>(&xs[buf][idx / SEGS][(idx % SEGS) * 8]) = sx[v];
    }
#pragma unroll
    for (int v = 0; v < YV; ++v) {
      const int idx = tid + v * THREADS;
      *reinterpret_cast<uint4*>(&ys[buf][idx / SEGS][(idx % SEGS) * 8]) = sy[v];
    }
  };

  if (n_groups > 0) {
    fetch();
    put(0);
  }
  __syncthreads();
  int buf = 0;
  for (int g = 0; g < n_groups; ++g) {
    // L2: two threads sum |y|^2 of a staged corpus row, 16 of the chunk's
    // values each; in the first group four threads sum |x|^2 of a query row
    // (rows and values past the matrix are staged as zeros)
    float ynorm = 0.0f, xnorm = 0.0f;
    for (int kc = 0; kc < nk; ++kc) {
      const bool more = pg < n_groups;
      if (more) fetch();  // in flight while the tensor cores work on this chunk

      if (L2) {
        const uint4* yrow = reinterpret_cast<const uint4*>(&ys[buf][tid / 2][(tid % 2) * 16]);
        ynorm = add_squares(yrow[1], add_squares(yrow[0], ynorm));
        if (!RAW && g == 0)
          xnorm = add_squares(
              *reinterpret_cast<const uint4*>(&xs[buf][tid / 4][(tid % 4) * 8]), xnorm);
      }

#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)  // rows 0-7 and 8-15 at k, then both at k + 8
          ldmatrix_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                      &xs[buf][wm * WM + mi * 16 + lane % 16][kk + (lane / 16) * 8]);
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2)  // classes 0-7 at k and k + 8, then classes 8-15
          ldmatrix_x4(b[ni][0], b[ni][1], b[ni + 1][0], b[ni + 1][1],
                      &ys[buf][wn * WN + ni * 8 + lane % 8 + (lane / 16) * 8]
                         [kk + ((lane / 8) % 2) * 8]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
      // the other buffer was last read before the previous barrier
      if (more) put(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }

    if (L2) {
      // the previous group's fold read wsm before the barriers of this
      // group's chunks
      ynorm += __shfl_xor_sync(0xffffffffu, ynorm, 1);
      if (tid % 2 == 0) wsm[tid / 2] = ynorm;
      if (!RAW && g == 0) {
        xnorm += __shfl_xor_sync(0xffffffffu, xnorm, 1);
        xnorm += __shfl_xor_sync(0xffffffffu, xnorm, 2);
        if (tid % 4 == 0) x2sm[tid / 4] = xnorm;
      }
      __syncthreads();
    }
    // the group's dots are complete: fold them into the running minima
    const long long col0 = (long long)base + (long long)g * LANES + wn * WN + tig * 2;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long col = col0 + ni * 8 + e;
        const bool real = col < c;
        const float wc = L2 ? wsm[wn * WN + tig * 2 + ni * 8 + e] : 0.0f;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int el = h * 2 + e;
            fold(acc[mi][ni][el], wc, scale, real, static_cast<int>(col), best_t[mi][ni][el],
                 best_col[mi][ni][el]);
            acc[mi][ni][el] = 0.0f;
          }
      }
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * WM + mi * 16 + grp + h * 8;
      if (row >= q) continue;
      const float xx = (!RAW && L2 && n_groups > 0) ? x2sm[wm * WM + mi * 16 + grp + h * 8] : 0.0f;
      const size_t o = (size_t)row * out_width + (size_t)unit * LANES + wn * WN + tig * 2;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float t0 = best_t[mi][ni][h * 2], t1 = best_t[mi][ni][h * 2 + 1];
        if (!RAW) {
          t0 = finish_bin(t0, xx, metric);
          t1 = finish_bin(t1, xx, metric);
        }
        // an even column of a row whose width is a multiple of 128: 8-byte aligned
        *reinterpret_cast<float2*>(outd + o + ni * 8) = make_float2(t0, t1);
        *reinterpret_cast<int2*>(outi + o + ni * 8) =
            make_int2(best_col[mi][ni][h * 2], best_col[mi][ni][h * 2 + 1]);
      }
    }
}

template <bool RAW>
int launch(const void* x, const void* y, float* outd, int* outi, int q, int c, int d, int span,
           int n_units, int metric, void* stream) {
  const int n_q_tiles = (q + BM - 1) / BM;
  const unsigned blocks = (unsigned)n_q_tiles * n_units;
  // 16-byte loads need rows that start on 16-byte boundaries
  const int vec = d % 8 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                  reinterpret_cast<size_t>(y) % 16 == 0;
  const auto kernel = is_l2(metric) ? scan_kernel<RAW, true> : scan_kernel<RAW, false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y), outd, outi, q,
      c, d, span, n_q_tiles, n_units * LANES, metric, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

}  // namespace

// x [Q, D], y [C, D]: f32 (_f32) or bf16 (_bf16).
// outd / outi: [Q, ceil(C / tile_c) * 128].
extern "C" int binned_scan_f32(const void* x, const void* y, float* outd, int* outi, int q, int c,
                               int d, int tile_c, int metric, void* stream) {
  return simt::launch<false>(x, y, outd, outi, q, c, d, tile_c, (c + tile_c - 1) / tile_c, metric,
                             stream);
}

extern "C" int binned_scan_bf16(const void* x, const void* y, float* outd, int* outi, int q, int c,
                                int d, int tile_c, int metric, void* stream) {
  return mma::launch<false>(x, y, outd, outi, q, c, d, tile_c, (c + tile_c - 1) / tile_c, metric,
                            stream);
}

// outt / outi: [Q, n_slots * 128]; outt holds surrogate minima (no epilogue).
// Slot s covers the n_jj corpus tiles from s * n_jj on.
extern "C" int folded_scan_f32(const void* x, const void* y, float* outt, int* outi, int q, int c,
                               int d, int tile_c, int n_slots, int n_jj, int metric,
                               void* stream) {
  return simt::launch<true>(x, y, outt, outi, q, c, d, n_jj * tile_c, n_slots, metric, stream);
}

extern "C" int folded_scan_bf16(const void* x, const void* y, float* outt, int* outi, int q, int c,
                                int d, int tile_c, int n_slots, int n_jj, int metric,
                                void* stream) {
  return mma::launch<true>(x, y, outt, outi, q, c, d, n_jj * tile_c, n_slots, metric, stream);
}
