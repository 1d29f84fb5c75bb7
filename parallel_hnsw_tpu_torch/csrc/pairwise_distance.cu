// Tiled pairwise distances [Q, D] x [C, D] -> [Q, C] in fp32, for Hopper (sm_90a).
//
// Replaces parallel_hnsw_tpu/ops/pallas_distance.py::_dist_kernel.  Same
// semantics: one contraction over D per (query, corpus) pair and a fused
// epilogue per metric -- cosine 1-dot, normalized cosine (1-dot)/2, dot -dot,
// and the L2 family max(|x|^2 + |y|^2 - 2 dot, 0) (square root for L2), with
// the norms computed inside the tile pass instead of as separate HBM arrays.
//
// What bounds it on an H100: at the main-path block [2048 x 65536 x 100] the
// kernel does 2 * 2048 * 65536 * 100 ~ 27 GFLOP of fp32 FFMA against a 512 MiB
// f32 output write (~0.16 ms at 3.35 TB/s), so it is compute-bound on the
// SIMT fp32 pipes (67 TFLOP/s peak), not on memory.
//
// Design: a classic shared-memory-tiled SGEMM with the NT layout (both
// operands row-major [*, D], contracted over D).  A block of 256 threads owns
// a 64 x 64 output tile and walks D in chunks of 16; each thread keeps a 4 x 4
// register micro-tile and reads its operands from shared memory as float4.
// The dot accumulates in partial sums of 8 FFMAs that are then added to the
// running sum: measured on an H100, that order reproduces the plain version's
// (cuBLAS's) dots at D = 32, where one 32-term FFMA chain carried twice
// their rounding error and put the L2 result 3 ulps away.
// fp32 FFMA only: no tensor cores, no TF32, so both `exact` modes of the
// caller give full fp32 results.  The ragged edges of Q, C and D are masked
// in the loads (zero fill) and in the stores; global loads are scalar, so no
// row alignment is assumed (D = 7 works).  For the L2 family, 128 of the
// threads also accumulate |x|^2 and |y|^2 from the same shared tiles, in fp64
// (1/16 of the tile's work), so they carry no chain-length error either.
//
// The later win is to fuse the caller's top-k into the epilogue so the
// [Q, C] matrix never reaches HBM, as _scan_kernel does on the TPU; a bf16
// wgmma mode for exact=False is the other.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // output rows (queries) per block
constexpr int BN = 64;   // output columns (corpus rows) per block
constexpr int BK = 16;   // D-chunk per shared-memory stage
constexpr int TM = 4;    // micro-tile rows per thread
constexpr int TN = 4;    // micro-tile columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int KPART = 8;  // FFMA chain length before a partial joins the running sum
constexpr int PAD = 4;   // keeps float4 alignment, halves bank conflicts on the stores

// Metric codes; parallel_hnsw_tpu_torch/ops/cuda_distance.py passes the same.
constexpr int COSINE = 0;
constexpr int NORMALIZED_COSINE = 1;
constexpr int EUCLIDEAN = 2;
constexpr int SQUARED_EUCLIDEAN = 3;
constexpr int DOT = 4;

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

__global__ void __launch_bounds__(THREADS)
pairwise_distance_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         float* __restrict__ out, int q, int c, int d, int metric) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float ys[BK][BN + PAD];
  __shared__ float xn[BM];
  __shared__ float yn[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // micro-tile column group
  const int ty = tid / (BN / TN);  // micro-tile row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const bool l2 = metric == EUCLIDEAN || metric == SQUARED_EUCLIDEAN;

  // loader mapping: consecutive threads read consecutive elements of a row
  const int lk = tid % BK;
  const int lr = tid / BK;
  constexpr int ROW_STEP = THREADS / BK;  // 16 rows per load pass

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  double norm = 0.0;  // threads [0, BM): x row norms; [BM, BM + BN): y row norms

  for (int k0 = 0; k0 < d; k0 += BK) {
    const int k = k0 + lk;
#pragma unroll
    for (int r = lr; r < BM; r += ROW_STEP) {
      const int gx = row0 + r;
      xs[lk][r] = (gx < q && k < d) ? x[(size_t)gx * d + k] : 0.0f;
    }
#pragma unroll
    for (int r = lr; r < BN; r += ROW_STEP) {
      const int gy = col0 + r;
      ys[lk][r] = (gy < c && k < d) ? y[(size_t)gy * d + k] : 0.0f;
    }
    __syncthreads();

    if (l2) {
      if (tid < BM) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) norm = fma((double)xs[kk][tid], (double)xs[kk][tid], norm);
      } else if (tid < BM + BN) {
        const int t = tid - BM;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) norm = fma((double)ys[kk][t], (double)ys[kk][t], norm);
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

  if (l2) {
    if (tid < BM) {
      xn[tid] = (float)norm;
    } else if (tid < BM + BN) {
      yn[tid - BM] = (float)norm;
    }
    __syncthreads();
  }

  const int col = col0 + tx * TN;
  const bool vec_store = (c % 4 == 0) && (col + TN <= c);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int lrow = ty * TM + i;
    const int row = row0 + lrow;
    if (row >= q) break;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      v[j] = l2 ? finish(acc[i][j], xn[lrow], yn[tx * TN + j], metric)
                : finish(acc[i][j], 0.0f, 0.0f, metric);
    }
    float* o = out + (size_t)row * c + col;
    if (vec_store) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (col + j < c) o[j] = v[j];
    }
  }
}

}  // namespace

extern "C" int pairwise_distance_f32(const float* x, const float* y, float* out, int q, int c,
                                     int d, int metric, void* stream) {
  const dim3 grid((c + BN - 1) / BN, (q + BM - 1) / BM);
  pairwise_distance_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, q, c, d, metric);
  return static_cast<int>(cudaGetLastError());
}
