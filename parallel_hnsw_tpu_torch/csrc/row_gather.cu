// Gather of whole rows by an int32 index vector, for Hopper (sm_90a):
//   out[i, :] = table[idx[i], :]      table [N, row_bytes], out [R, row_bytes]
//
// Replaces scripts/gather_kernel_study.py::_gather_kernel (wrapper
// dma_gather).  Same semantics: rows are copied as they are stored, indices
// are in range on entry (callers clamp), the output has the table's type.
// Rows are `row_bytes` bytes, not elements of one type, so one kernel serves
// every row gather of the graph hop: f32 feature rows, bf16 routing rows,
// int32 neighbor rows and [M x width] hop-slab rows.
//
// What bounds it on an H100: bytes.  It does no arithmetic; the least time is
// (4 R + R row_bytes read, R row_bytes written) / 3.35 TB/s when every
// gathered row is distinct, and the table's bytes instead of R row_bytes on
// the read side when the table is smaller than what is gathered from it.
//
// Design.  The Pallas kernel starts one DMA per row from the scalar core, 16
// in flight, because a TPU cannot fetch a scattered row another way.  Here a
// group of G neighbouring lanes (a warp, or a fraction of one for rows that
// need fewer than 32 vector loads) copies a row: lane l moves vectors l,
// l + G, ... of the row, so neighbouring lanes touch neighbouring addresses.
// Each group takes ROWS_PER_STEP rows at a time: it reads their indices
// first, then starts all their loads before the first store, so several
// loads per lane are in flight behind each index fetch.  Groups walk the
// index vector in a grid-stride loop.  The vector is 16 bytes where
// row_bytes and both base pointers allow it and 8, 4, 2 or 1 bytes where
// they do not (a 200-byte bf16 row is only 8-byte aligned): the width comes
// from the low bits of row_bytes and the two pointers, and the kernel branches
// on it, uniformly over the launch.  Offsets are 64-bit: R x
// row_bytes passes 2^31 when a hop slab is built.
//
// Later work: cp.async / TMA gather into shared memory for the consumer, and
// the hop's distances fused behind the gather so the rows never reach HBM.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_STEP = 4;  // rows a group has in flight at once
constexpr int MAX_BLOCKS = 132 * 32;  // grid-stride beyond this many blocks

template <typename V>
__device__ __forceinline__ void gather_rows(const char* __restrict__ table,
                                            const int* __restrict__ idx, char* __restrict__ out,
                                            long long rows, long long row_bytes, int log2_group) {
  const int nvec = static_cast<int>(row_bytes / static_cast<long long>(sizeof(V)));
  const int group = 1 << log2_group;
  const int lane = threadIdx.x & (group - 1);
  const long long thread = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long groups = (static_cast<long long>(gridDim.x) * THREADS) >> log2_group;
  for (long long r0 = (thread >> log2_group) * ROWS_PER_STEP; r0 < rows;
       r0 += groups * ROWS_PER_STEP) {
    const V* src[ROWS_PER_STEP];
#pragma unroll
    for (int u = 0; u < ROWS_PER_STEP; ++u) {
      // rows past the end reread the step's first row and store nothing
      const long long r = r0 + u < rows ? r0 + u : r0;
      src[u] = reinterpret_cast<const V*>(table + static_cast<long long>(__ldg(idx + r)) * row_bytes);
    }
    for (int v = lane; v < nvec; v += group) {
      V val[ROWS_PER_STEP];
#pragma unroll
      for (int u = 0; u < ROWS_PER_STEP; ++u) val[u] = __ldg(src[u] + v);
#pragma unroll
      for (int u = 0; u < ROWS_PER_STEP; ++u) {
        if (r0 + u < rows) reinterpret_cast<V*>(out + (r0 + u) * row_bytes)[v] = val[u];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const char* __restrict__ table, const int* __restrict__ idx,
                  char* __restrict__ out, long long rows, long long row_bytes, int vec_bytes,
                  int log2_group) {
  // vec_bytes is uniform over the launch: no divergence
  switch (vec_bytes) {
    case 16: gather_rows<uint4>(table, idx, out, rows, row_bytes, log2_group); break;
    case 8: gather_rows<uint2>(table, idx, out, rows, row_bytes, log2_group); break;
    case 4: gather_rows<unsigned int>(table, idx, out, rows, row_bytes, log2_group); break;
    case 2: gather_rows<unsigned short>(table, idx, out, rows, row_bytes, log2_group); break;
    default: gather_rows<unsigned char>(table, idx, out, rows, row_bytes, log2_group); break;
  }
}

}  // namespace

extern "C" int row_gather(const void* table, const int* idx, void* out, long long rows,
                          long long table_rows, long long row_bytes, void* stream) {
  if (rows < 0 || table_rows <= 0 || row_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  // the widest vector that divides the row and keeps every row of both
  // arrays aligned: the lowest set bit of (row_bytes | table | out), at most 16
  const uintptr_t bits = static_cast<uintptr_t>(row_bytes) | reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out) | 16u;
  const int vec_bytes = static_cast<int>(bits & (~bits + 1));
  // lanes per row: the smallest power of two that covers the row's vectors, up to a warp
  const long long nvec = row_bytes / vec_bytes;
  int log2_group = 0;
  while (log2_group < 5 && (1LL << log2_group) < nvec) ++log2_group;
  const long long steps = (rows + ROWS_PER_STEP - 1) / ROWS_PER_STEP;
  const long long threads = steps << log2_group;
  long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  row_gather_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), idx, static_cast<char*>(out), rows, row_bytes, vec_bytes,
      log2_group);
  return static_cast<int>(cudaGetLastError());
}
