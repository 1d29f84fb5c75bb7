// The graph hop's gather and distances in one kernel, for Hopper (sm_90a):
//   out[q, k * sub + j] = dist(queries[q], table[idx[q, k] * sub + j])
// queries [Q, D] f32, table rows [N * sub, D] f32 or bf16, idx [Q, K] int32,
// out [Q, K * sub] f32.  sub = 1 for a source's feature rows, M for a hop slab
// [N, M, D] (one index brings the M rows of a node's neighbors).
//
// Redesigns kernel 4 (scripts/gather_kernel_study.py::_gather_kernel, ported
// as csrc/row_gather.cu) for its main launch site, the beam-search hop, which
// gathered candidate rows to HBM and read them back for one dot each
// (ops/distance.py::batched_distance).  Here the rows never reach HBM: the
// kernel writes only the distances.  An index outside [0, N) -- the hop's
// EMPTY_ID for a query that is done or a slot with no node -- brings no row:
// nothing is read for it and its distances are +inf, so the lockstep hop's
// converged queries cost next to nothing.  bf16 rows are widened to f32 in
// registers; every
// product and sum is f32.  The distance is the metric's finished value:
// cosine 1 - dot, normalized cosine (1 - dot) / 2, dot -dot, squared
// euclidean sum (c - q)^2 and euclidean its square root, as batched_distance.
//
// What bounds it on an H100: bytes.  At the hop (8192 queries x beam 4 x 48
// neighbors = 1,572,864 rows of 400 B from a 200,000 x 100 f32 table) it reads
// 629 MB of gathered rows and writes 6.3 MB: 0.19 ms if every row comes from
// HBM, 0.03 ms if the 80 MB table were read once.  The arithmetic (two flops a
// byte) is nothing.
//
// Design.  A block owns up to ROWS_PER_BLOCK candidate rows of one query.  It
// stages the query row (f32) and its indices in shared memory once, then
// streams the candidate rows global -> shared with cp.async: 16-byte pieces
// where the row size and the table's base allow, 8 or 4 bytes where not -- a
// 200-byte bf16 row is only 8-byte aligned -- and a plain load for 2-byte
// rows.  The copies allocate in L1, so a row that many queries ask for (the
// upper layers hold a few nodes that every query visits) is fetched from L2
// once per multiprocessor.  A group of G lanes (a power of two up to a warp)
// takes a row: lane l copies pieces l, l + G, ... of it into its OWN slots of
// a ring of STAGES steps, so no lane reads what another wrote and the ring
// needs no barrier, only cp.async.wait_group.  Each lane has STAGES - 1 steps
// of copies in flight while it multiplies the oldest: about 100 KB a
// multiprocessor at the hop's shape, against the ~25 KB that HBM's latency
// needs at 3.35 TB/s.  A lane sums its pieces in one f32 chain (pieces in
// order, values in order), then the group adds its lanes by a shuffle
// butterfly.  G, the pieces and so the whole summation order depend on D,
// the row type and the table's alignment only, never on Q or K: a query's
// distances do not depend on the batch it sits in, unlike a batched product.
// Rows wider than G * PIECES pieces take several steps (chunks) with the sum
// carried.
//
// Why L1 and the skip (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): copies
// that go around L1 (.cg) and read a row for every index (converged queries
// clamped to one row that all their candidates then ask for) take 0.18 ms at
// uniform random indices of the hop's shape but 204.7 ms of device time in
// one search pass of 10,000 queries; this kernel takes 0.225 ms there (85% of
// the bound with every gathered row read from HBM) and 36.2 ms in the pass.
//
// The hop's expand (hop_expand below) is this kernel with its indices made
// in the block instead of read: one launch of a lockstep layer search's hop
// (parallel_hnsw_tpu_torch/search.py) before its queue merge
// (csrc/queue_merge.cu).  Per query row it reads the hop's frontier
// (frontier, frontier_ok, done and the queue's ids at the frontier's
// slots), marks the expanded slots, reads each expanded node's neighbor row
// from the layer's table, maps each neighbor to its vector through the
// layer's nodes (or, over a hop slab [N, M, D], indexes the slab by the
// node), and computes the distances with the loop above, so they are
// gather_distance's bit for bit; it writes the candidates' ids and
// distances (EMPTY_ID and +inf where the hop has no candidate) and adds the
// count of candidates to the evaluation counter (an integer atomic, so the
// order of the blocks does not matter).  In place of the torch operations
// around the gather (gathers, a scatter, masks, a sum) it costs a few
// dependent loads a block before the rows stream in.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PIECES = 4;  // pieces of a row a lane holds per step
constexpr int STAGES = 3;  // ring depth: STAGES - 1 steps of copies in flight
constexpr int ROWS_PER_BLOCK = 512;
constexpr int MAX_SMEM = 232448;  // what a block may take on an H100

// Metric codes; parallel_hnsw_tpu_torch/ops/cuda_gather.py passes the same.
constexpr int COSINE = 0;
constexpr int NORMALIZED_COSINE = 1;
constexpr int EUCLIDEAN = 2;
constexpr int SQUARED_EUCLIDEAN = 3;
constexpr int DOT = 4;
constexpr int EMPTY_ID = 0x7fffffff;

// The hop's state and layer, for the expand (HOP = true); unused otherwise.
// Candidate row r of a query is neighbor r % m of frontier slot r / m.
struct HopArgs {
  const int* ids;                    // [Q, cap] the queues' node ids
  int* expanded;                     // [Q, cap] 0 / 1, set at the expanded slots
  const long long* frontier;         // [Q, b] slots
  const unsigned char* frontier_ok;  // [Q, b] which slots are expanded (with done clear)
  const unsigned char* done;         // [Q]
  const int* nodes;                  // [n_layer] node -> vector id; null over a slab
  const int* neighbors;              // [n_layer, m] node ids, EMPTY_ID-padded
  int* cand_ids;                     // [Q, b * m] out
  unsigned long long* evals;         // the evaluation counter (int64)
  int* counter;                      // a device hop counter to advance, or null
  unsigned char* all_done;           // a flag to set (queue_merge clears it), or null
  int cap, b, m, n_layer;
};

__host__ __device__ constexpr int ring_bytes(int vb) { return STAGES * PIECES * THREADS * vb; }

// One piece of VB bytes, global -> shared.  .ca: the piece is kept in L1
// too, so a row that many candidates of a block or of its neighbours ask for
// (the upper layers' few nodes, hubs) is read from L2 once per multiprocessor,
// not once per request.
template <int VB>
__device__ __forceinline__ void copy_piece(unsigned char* dst, const unsigned char* src) {
  if constexpr (VB >= 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(VB)
                 : "memory");
  } else {  // no cp.async moves 2 bytes
    *reinterpret_cast<unsigned short*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

// A staged piece as f32 values: VB / sizeof(row type) of them.
template <bool BF16, int VB>
__device__ __forceinline__ void widen(const unsigned char* piece, float* v) {
  if constexpr (VB == 2) {
    v[0] = __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(piece)) << 16);
  } else {
    uint32_t w[VB / 4];
    if constexpr (VB == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(piece);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (VB == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(piece);
      w[0] = u.x, w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(piece);
    }
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      if constexpr (BF16) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        v[i] = __uint_as_float(w[i]);
      }
    }
  }
}

__device__ __forceinline__ float finish(float s, int metric) {
  switch (metric) {
    case COSINE:
      return 1.0f - s;
    case NORMALIZED_COSINE:
      return (1.0f - s) / 2.0f;
    case DOT:
      return -s;
    case EUCLIDEAN:
      return sqrtf(s);
    default:
      return s;
  }
}

// The hop's expand for the block's rows [r0, r1) of one query: the table
// indices ks (by k) and the candidates' node ids cs (by row), the expanded
// slots marked (by the query's first block) and the candidates counted.
// Mirrors search.py's unfused hop: a slot expands where frontier_ok is set
// and done is clear; its node's neighbor row is read at the node clamped
// into [0, n_layer); a neighbor that is not EMPTY_ID is a candidate, mapped
// to its vector at the neighbor clamped likewise; over a slab the table
// index is the slot's node as it is (an index outside the slab gives +inf).
__device__ void stage_hop(const HopArgs& h, int query, int r0, int r1, int k0, bool slab,
                          int* ks, int* cs) {
  const bool going = !h.done[query];
  const long long* front = h.frontier + (size_t)query * h.b;
  const unsigned char* ok = h.frontier_ok + (size_t)query * h.b;
  const int* row_ids = h.ids + (size_t)query * h.cap;
  unsigned count = 0;
  for (int base = r0; base < r1; base += THREADS) {  // every thread runs every round
    const int r = base + threadIdx.x;
    bool valid = false;
    if (r < r1) {
      const int slot = r / h.m, j = r % h.m;
      const bool expand = going && ok[slot];
      const int node = row_ids[front[slot]];
      const int safe = min(max(node, 0), h.n_layer - 1);
      const int nb = expand ? __ldg(h.neighbors + (long long)safe * h.m + j) : EMPTY_ID;
      valid = nb != EMPTY_ID;
      cs[r - r0] = nb;
      if (!slab) {
        ks[r - r0] = valid ? __ldg(h.nodes + min(max(nb, 0), h.n_layer - 1)) : EMPTY_ID;
      } else if (j == 0 || r == r0) {
        ks[slot - k0] = expand ? node : EMPTY_ID;
      }
    }
    count += __syncthreads_count(valid);
  }
  if (threadIdx.x == 0 && count > 0) atomicAdd(h.evals, static_cast<unsigned long long>(count));
  if (r0 == 0) {
    for (int i = threadIdx.x; i < h.b; i += THREADS)
      if (going && ok[i]) h.expanded[(size_t)query * h.cap + front[i]] = 1;
  }
  // no block of this launch reads the counter or the flag
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (h.counter != nullptr) ++*h.counter;
    if (h.all_done != nullptr) *h.all_done = 1;
  }
}

// blockIdx.x = query * blocks_per_query + part; the block takes the query's
// candidate rows [part * ROWS_PER_BLOCK, ...).  rows = K * sub.  HOP: the
// hop's expand, indices made by stage_hop (idx unused).
template <bool BF16, int VB, bool L2, bool HOP>
__global__ void __launch_bounds__(THREADS)
gather_distance_kernel(const float* __restrict__ queries, const unsigned char* __restrict__ table,
                       const int* __restrict__ idx, float* __restrict__ out, int n, int k,
                       int sub, int d, long long row_bytes, int rows, int blocks_per_query,
                       int nvec, int log2_group, int n_chunks, int metric, HopArgs hop) {
  constexpr int E = BF16 ? VB / 2 : VB / 4;  // values per piece
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // [STAGES][PIECES][THREADS] pieces
  float* qs = reinterpret_cast<float*>(smem + ring_bytes(VB));  // the query row
  int* ks = reinterpret_cast<int*>(qs + (d + 3) / 4 * 4);        // the block's indices
  int* cs = ks + ROWS_PER_BLOCK;  // HOP: the block's candidates' node ids

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int query = blockIdx.x / blocks_per_query;
  const int r0 = (blockIdx.x % blocks_per_query) * ROWS_PER_BLOCK;
  const int r1 = min(r0 + ROWS_PER_BLOCK, rows);
  const int k0 = r0 / sub, k1 = (r1 - 1) / sub + 1;
  for (int e = tid; e < d; e += THREADS) qs[e] = __ldg(queries + (size_t)query * d + e);
  if constexpr (HOP) {
    stage_hop(hop, query, r0, r1, k0, hop.nodes == nullptr, ks, cs);
  } else {
    for (int i = tid; i < k1 - k0; i += THREADS) ks[i] = __ldg(idx + (size_t)query * k + k0 + i);
  }
  __syncthreads();

  const int group = 1 << log2_group;
  const int l = lane & (group - 1);
  const int rows_per_warp = 32 >> log2_group;
  const int my_row = warp * rows_per_warp + (lane >> log2_group);  // within a block step
  const int chunk_pieces = group * PIECES;
  const int n_steps = (r1 - r0 + WARPS * rows_per_warp - 1) / (WARPS * rows_per_warp) * n_chunks;

  // step t: chunk t % n_chunks of row r0 + (t / n_chunks) * WARPS * rows_per_warp + my_row
  auto row_of = [&](int t) { return r0 + t / n_chunks * (WARPS * rows_per_warp) + my_row; };
  // the table index that brings a row, or -1 for a row past the block's end
  // or an index outside [0, n) (EMPTY_ID): such a row reads nothing
  auto index_of = [&](int row) {
    if (row >= r1) return -1;
    if (HOP && cs[row - r0] == EMPTY_ID) return -1;  // no candidate: nothing to read
    const int i = ks[row / sub - k0];
    return static_cast<unsigned>(i) < static_cast<unsigned>(n) ? i : -1;
  };
  auto slot = [&](int t, int p) { return ring + ((t % STAGES * PIECES + p) * THREADS + tid) * VB; };
  auto prefetch = [&](int t) {
    const int row = row_of(t);
    const int i = t < n_steps ? index_of(row) : -1;
    if (i >= 0) {
      const unsigned char* src = table + ((long long)i * sub + row % sub) * row_bytes;
      const int v0 = t % n_chunks * chunk_pieces + l;
#pragma unroll
      for (int p = 0; p < PIECES; ++p) {
        const int v = v0 + p * group;
        if (v < nvec) copy_piece<VB>(slot(t, p), src + (long long)v * VB);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group keeps the count
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) prefetch(t);
  float acc = 0.0f;
  for (int t = 0; t < n_steps; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    // the slot this refills held step t - 1, which this lane has read already
    prefetch(t + STAGES - 1);
    const int chunk = t % n_chunks;
    const int row = row_of(t);
    const bool live = index_of(row) >= 0;
    const int v0 = chunk * chunk_pieces + l;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      const int v = v0 + p * group;
      if (live && v < nvec) {
        float c[E];
        widen<BF16, VB>(slot(t, p), c);
        float qv[E];
        if constexpr (E % 4 == 0) {
#pragma unroll
          for (int i = 0; i < E / 4; ++i) {
            const float4 f = reinterpret_cast<const float4*>(qs + v * E)[i];
            qv[4 * i] = f.x, qv[4 * i + 1] = f.y, qv[4 * i + 2] = f.z, qv[4 * i + 3] = f.w;
          }
        } else if constexpr (E == 2) {
          const float2 f = reinterpret_cast<const float2*>(qs)[v];
          qv[0] = f.x, qv[1] = f.y;
        } else {
          qv[0] = qs[v];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (L2) {
            const float diff = c[e] - qv[e];
            acc = fmaf(diff, diff, acc);
          } else {
            acc = fmaf(c[e], qv[e], acc);
          }
        }
      }
    }
    if (chunk == n_chunks - 1) {
      // the group's lanes, in one order for every row: a butterfly leaves the
      // same sum in every lane (f32 addition commutes)
      for (int off = group / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (l == 0 && row < r1) {
        out[(size_t)query * rows + row] = live ? finish(acc, metric) : CUDART_INF_F;
        if constexpr (HOP) hop.cand_ids[(size_t)query * rows + row] = cs[row - r0];
      }
      acc = 0.0f;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool BF16, int VB, bool HOP>
int launch(const float* queries, const void* table, const int* idx, float* out, int q, int n,
           int k, int sub, int d, int metric, const HopArgs& hop, cudaStream_t stream) {
  const long long row_bytes = (long long)d * (BF16 ? 2 : 4);
  const int nvec = static_cast<int>(row_bytes / VB);
  // lanes per row: the fewest (a power of two, at most a warp) that hold a row in one step
  int log2_group = 0;
  while (log2_group < 5 && (PIECES << log2_group) < nvec) ++log2_group;
  const int n_chunks = (nvec + (PIECES << log2_group) - 1) / (PIECES << log2_group);
  const long long rows = (long long)k * sub;
  const long long per_query = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long blocks = per_query * q;
  const long long smem =
      ring_bytes(VB) + ((long long)d + 3) / 4 * 16 + ROWS_PER_BLOCK * 4 * (HOP ? 2 : 1);
  if (rows > 0x7fffffffLL || blocks > 0x7fffffffLL || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool l2 = metric == EUCLIDEAN || metric == SQUARED_EUCLIDEAN;
  const auto kernel = l2 ? gather_distance_kernel<BF16, VB, true, HOP>
                         : gather_distance_kernel<BF16, VB, false, HOP>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(unsigned)blocks, THREADS, (size_t)smem, stream>>>(
      queries, static_cast<const unsigned char*>(table), idx, out, n, k, sub, d, row_bytes,
      static_cast<int>(rows), static_cast<int>(per_query), nvec, log2_group, n_chunks, metric,
      hop);
  return static_cast<int>(cudaGetLastError());
}

// The launch for a row type and the table's alignment: the widest piece that
// divides a row and keeps every row of the table aligned, the lowest set bit
// of (row bytes | table | 16).
template <bool HOP>
int dispatch(const float* queries, const void* table, const int* idx, float* out, int q, int n,
             int k, int sub, int d, int elem_bytes, int metric, const HopArgs& hop,
             cudaStream_t s) {
  const uintptr_t bits = static_cast<uintptr_t>(d) * elem_bytes |
                         reinterpret_cast<uintptr_t>(table) | 16u;
  const int vb = static_cast<int>(bits & (~bits + 1));
  if (elem_bytes == 4) {
    switch (vb) {
      case 16: return launch<false, 16, HOP>(queries, table, idx, out, q, n, k, sub, d, metric, hop, s);
      case 8: return launch<false, 8, HOP>(queries, table, idx, out, q, n, k, sub, d, metric, hop, s);
      default: return launch<false, 4, HOP>(queries, table, idx, out, q, n, k, sub, d, metric, hop, s);
    }
  }
  switch (vb) {
    case 16: return launch<true, 16, HOP>(queries, table, idx, out, q, n, k, sub, d, metric, hop, s);
    case 8: return launch<true, 8, HOP>(queries, table, idx, out, q, n, k, sub, d, metric, hop, s);
    case 4: return launch<true, 4, HOP>(queries, table, idx, out, q, n, k, sub, d, metric, hop, s);
    default: return launch<true, 2, HOP>(queries, table, idx, out, q, n, k, sub, d, metric, hop, s);
  }
}

}  // namespace

// queries [Q, D] f32; table: n * sub rows of D values, f32 (elem_bytes 4) or
// bf16 (2), contiguous, index i in [0, n) bringing rows [i * sub, (i + 1) *
// sub); idx [Q, K] int32, an index outside [0, n) giving +inf distances; out
// [Q, K * sub] f32.  queries, idx and out 4-byte aligned.
extern "C" int gather_distance(const float* queries, const void* table, const int* idx,
                               float* out, int q, int n, int k, int sub, int d, int elem_bytes,
                               int metric, void* stream) {
  if (q < 0 || n < 0 || k < 0 || sub <= 0 || d <= 0 || (elem_bytes != 4 && elem_bytes != 2) ||
      metric < COSINE || metric > DOT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || k == 0) return static_cast<int>(cudaSuccess);
  return dispatch<false>(queries, table, idx, out, q, n, k, sub, d, elem_bytes, metric, HopArgs{},
                         static_cast<cudaStream_t>(stream));
}

// The hop's expand.  queries [Q, D] f32; table: a dense source's rows [n, D]
// (nodes [n_layer] given, sub 1) or a hop slab [n_layer, m, D] (nodes null,
// n = n_layer, sub = m), f32 or bf16, contiguous; neighbors [n_layer, m]
// int32; ids, expanded [Q, cap] int32; frontier [Q, b] int64, frontier_ok
// [Q, b] bool; done [Q] bool; out: cand_ids [Q, b * m] int32 and dists
// [Q, b * m] f32; expanded and evals (int64) updated in place; counter
// (int32, advanced by 1) and all_done (bool, set) may be null.
extern "C" int hop_expand(const float* queries, const void* table, const int* nodes,
                          const int* neighbors, const int* ids, int* expanded,
                          const long long* frontier, const unsigned char* frontier_ok,
                          const unsigned char* done, int* cand_ids, float* out, long long* evals,
                          int* counter, unsigned char* all_done, int q, int n, int d,
                          int elem_bytes, int metric, int cap, int b, int m, int n_layer,
                          void* stream) {
  if (q < 0 || n < 0 || d <= 0 || (elem_bytes != 4 && elem_bytes != 2) || metric < COSINE ||
      metric > DOT || cap <= 0 || b <= 0 || b > cap || m <= 0 || n_layer <= 0 ||
      (long long)b * m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return static_cast<int>(cudaSuccess);
  const HopArgs hop{ids, expanded, frontier, frontier_ok, done, nodes, neighbors, cand_ids,
                    reinterpret_cast<unsigned long long*>(evals), counter, all_done,
                    cap, b, m, n_layer};
  const bool slab = nodes == nullptr;
  return dispatch<true>(queries, table, nullptr, out, q, n, slab ? b : b * m, slab ? m : 1, d,
                        elem_bytes, metric, hop, static_cast<cudaStream_t>(stream));
}
