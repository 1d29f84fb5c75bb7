// The beam-search hop's queue update in one kernel, for Hopper (sm_90a).
// Per row q of a lockstep layer search, in place:
//   (ids, dists, flags)[q] <- merge_queue_with_flags(ids, dists, flags, cand_ids, cand_dists)[q]
//   changed[q]             <- whether the retained ids differ from the old ones
//   frontier[q], ok[q]     <- the first b slots of the new queue that are unexpanded (flag 0)
//                             and not EMPTY_ID, in slot order, ok = 1; then, where there are
//                             fewer than b, the first non-frontier slots in slot order, ok = 0
// ids, flags [Q, cap] int32, dists [Q, cap] f32, cand_ids [Q, c] int32, cand_dists [Q, c] f32,
// done [Q] bool (may be null), changed [Q] bool, frontier [Q, b] int64, ok [Q, b] bool.
// A row whose done is set is left as it is (its changed reads 0): the hop
// gives it no candidates, and a merge of empties into a queue that a merge
// made is the identity.
//
// With probes given, the kernel ends each row that is not done with the
// hop's termination accounting (search.py's unfused hop; reference:
// probe_depth decrement on non-improving rounds, src/lib.rs:233-238):
//   probes[q]      -= 1 where the merge did not change the queue
//   done[q]         = probes[q] <= 0, or the new queue has no frontier slot
//   improve_hop[q]  = the hop's number where the head's id changed
//   all_done        cleared where the row is still going (may be null)
// The hop's number is *hop_counter where that is given (a CUDA graph's
// device counter, which the hop's expand advanced), else hop_number.
// changed may then be null.
//
// Replaces no Pallas kernel.  In the JAX package this step is one
// lax.sort(num_keys=2, is_stable=True) that XLA compiles, and the next hop's
// frontier a top_k (parallel_hnsw_tpu/ops/queues.py, search.py).  The port
// ran it as torch ops: two stable radix sorts through lexsort_perm, a second
// pair in dedup_sorted, about ten gathers, and a top-k for the frontier; most
// of a hop's device time at 8192 rows.
//
// The contract is bit for bit with ops/queues.merge_queue_with_flags:
// entries are ordered by (dist, id) with IEEE comparison (-0.0 == +0.0, +inf
// last, NaN after +inf), equal keys in concatenation order (queue first, so
// an existing entry's flag survives the dedup); a later adjacent entry of a
// repeated id (not EMPTY_ID) becomes (EMPTY_ID, +inf) and keeps its flag;
// dedup_sorted's second sort is the stable partition that puts every
// (EMPTY_ID, +inf) entry, emptied or not, after the live ones in merged
// order (and live NaN entries after those, where that sort puts them).
// Distances are copied as bits, so -0.0 stays -0.0.
//
// What bounds it on an H100: bytes.  A row reads cap x 12 bytes of queue and
// c x 8 of candidates and writes cap x 12 back (and b x 9 of frontier): at
// 8192 rows, cap 300, c 192 that is ~71 MB, 21 us at 3.35 TB/s.  The sorting
// is a few thousand compare-exchanges a row in shared memory.
//
// Design.  One block a row, its whole working set in shared memory.  The
// queue is sorted on entry (it is the last merge's output), so only the c
// candidates are sorted: 64-bit keys orderable(dist) << 32 | id (the id's
// sign bit flipped so that signed order holds; -0.0 folded into +0.0 in the
// key only), with their position as the tie-breaker, by a bitonic network
// padded to a power of two.  Each entry of either list then finds its place
// in the merged order by a binary search in the other (queue first on equal
// keys) and writes its id and source there.  A queue that is not sorted
// (checked in the same pass that loads it) is sorted by the same network
// first, so the result never depends on that invariant.  One block-wide
// prefix sum over the merged order counts, per entry, the entries before it
// that go to the live part and to the empty part: that is the dedup mark and
// the stable partition together.  Entries that land in the first cap slots
// are written out; a second prefix sum over the new flags gives the
// frontier.  Threads a block follow the row width cap + c (64 to 1024), so
// the build's ef 6 searches and ef 300 both keep the multiprocessors full
// with rows; at most MAX_WIDTH entries fit the shared memory budget.
//
// Plain C interface for ctypes: launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMPTY_ID = 0x7fffffff;
constexpr uint32_t INF_BITS = 0x7f800000u;
constexpr uint64_t KEY_PAD = ~0ull;  // after every real key (ties broken by position)
constexpr int MAX_WIDTH = 4096;
constexpr unsigned FULL_MASK = 0xffffffffu;
// the partition's two counts, packed in one 32-bit sum (widths < 2^16)
constexpr uint32_t LIVE = 1u;
constexpr uint32_t EMPTY = 1u << 16;
constexpr uint16_t FROM_CANDIDATES = 0x8000;

__device__ __forceinline__ uint64_t sort_key(uint32_t bits, int id) {
  uint32_t o;
  if ((bits & 0x7fffffffu) > INF_BITS) {
    o = 0xffffffffu;  // NaN, of any sign or payload: after +inf
  } else {
    if (bits == 0x80000000u) bits = 0u;  // -0.0 sorts as +0.0
    o = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  }
  return (static_cast<uint64_t>(o) << 32) | (static_cast<uint32_t>(id) ^ 0x80000000u);
}

// the key of (EMPTY_ID, +inf)
constexpr uint64_t EMPTY_KEY = (static_cast<uint64_t>(INF_BITS | 0x80000000u) << 32) | 0xffffffffu;

// ascending by (key, position) over p (a power of two) entries; ends synchronised
__device__ void bitonic_sort(uint64_t* key, uint16_t* pos, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t ka = key[lo], kb = key[hi];
        const uint16_t pa = pos[lo], pb = pos[hi];
        const bool b_first = kb < ka || (kb == ka && pb < pa);
        if (b_first == ((lo & k) == 0)) {
          key[lo] = kb;
          key[hi] = ka;
          pos[lo] = pb;
          pos[hi] = pa;
        }
      }
      __syncthreads();
    }
  }
}

// entries of the sorted key[0, n) below k / not above k
__device__ __forceinline__ int count_below(const uint64_t* key, int n, uint64_t k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_up_to(const uint64_t* key, int n, uint64_t k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] <= k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// exclusive prefix sum over the block of one value a thread, and the total;
// every thread calls it; buf holds 32 words; ends synchronised
__device__ uint32_t block_scan(uint32_t v, uint32_t* buf, uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < warps ? buf[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    if (lane < warps) buf[lane] = w;
  }
  __syncthreads();
  const uint32_t before = (warp == 0 ? 0u : buf[warp - 1]) + x - v;
  total = buf[warps - 1];
  __syncthreads();
  return before;
}

struct Rows {  // one row's shared memory
  uint64_t *ckey, *qkey;
  uint32_t *qid, *qdist, *cdist, *scan;
  int *qflag, *mid;
  uint16_t *cpos, *qpos, *msrc;
  unsigned char* fpred;
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline long long smem_bytes(int cap, int c) {
  const long long n = cap + c, pc = pow2_at_least(c), pq = pow2_at_least(cap);
  return 8 * (pc + pq) + 4 * (3 * cap + c + n + 32) + 2 * (pc + pq + n) + cap;
}

__device__ Rows carve(unsigned char* smem, int cap, int c) {
  const int n = cap + c, pc = pow2_at_least(c), pq = pow2_at_least(cap);
  Rows r;
  r.ckey = reinterpret_cast<uint64_t*>(smem);
  r.qkey = r.ckey + pc;
  r.qid = reinterpret_cast<uint32_t*>(r.qkey + pq);
  r.qdist = r.qid + cap;
  r.qflag = reinterpret_cast<int*>(r.qdist + cap);
  r.cdist = reinterpret_cast<uint32_t*>(r.qflag + cap);
  r.mid = reinterpret_cast<int*>(r.cdist + c);
  r.scan = reinterpret_cast<uint32_t*>(r.mid + n);
  r.cpos = reinterpret_cast<uint16_t*>(r.scan + 32);
  r.qpos = r.cpos + pc;
  r.msrc = r.qpos + pq;
  r.fpred = reinterpret_cast<unsigned char*>(r.msrc + n);
  return r;
}

struct Merged {
  int id;         // as written out: EMPTY_ID where the entry is a later duplicate
  uint32_t bits;  // the distance's bits as written out
  int flag;
  uint32_t part;  // LIVE, EMPTY, or 0 for a live NaN entry (after the empty part)
};

// the entry at position m of the merged order, with its dedup mark applied
__device__ __forceinline__ Merged merged_at(const Rows& r, int m) {
  const uint16_t s = r.msrc[m];
  const int src = s & 0x7fff;
  const bool cand = s & FROM_CANDIDATES;
  Merged e;
  e.id = r.mid[m];
  e.bits = cand ? r.cdist[src] : r.qdist[src];
  e.flag = cand ? 0 : r.qflag[src];
  if (m > 0 && e.id != EMPTY_ID && r.mid[m - 1] == e.id) {
    e.id = EMPTY_ID;
    e.bits = INF_BITS;
  }
  const uint64_t key = sort_key(e.bits, e.id);
  e.part = key < EMPTY_KEY ? LIVE : (key == EMPTY_KEY ? EMPTY : 0u);
  return e;
}

// The hop's termination accounting (see the header); null probes: none.
struct Accounting {
  int* probes;              // [Q] int32
  int* improve_hop;         // [Q] int32
  const int* hop_counter;   // the hop's number on the device, or null
  int hop_number;           // the hop's number where hop_counter is null
  unsigned char* all_done;  // cleared where a row is still going, or null
};

__global__ void queue_merge_kernel(int* __restrict__ ids, uint32_t* __restrict__ dists,
                                   int* __restrict__ flags, const int* __restrict__ cand_ids,
                                   const uint32_t* __restrict__ cand_dists,
                                   unsigned char* __restrict__ done,
                                   unsigned char* __restrict__ changed,
                                   long long* __restrict__ frontier,
                                   unsigned char* __restrict__ frontier_ok, int cap, int c, int b,
                                   Accounting acc) {
  const long long row = blockIdx.x;
  if (done != nullptr && done[row]) {
    if (threadIdx.x == 0 && changed != nullptr) changed[row] = 0;
    return;
  }
  __shared__ int new_head;
  extern __shared__ __align__(16) unsigned char smem[];
  const Rows r = carve(smem, cap, c);
  const int n = cap + c, pc = pow2_at_least(c), pq = pow2_at_least(cap);
  const int tid = threadIdx.x, threads = blockDim.x;
  int* row_ids = ids + row * cap;
  uint32_t* row_dists = dists + row * cap;
  int* row_flags = flags + row * cap;

  // 1. the row into shared memory: every global read happens here, so the
  // writes below may go over the same buffers
  for (int i = tid; i < pq; i += threads) {
    if (i < cap) {
      const int id = row_ids[i];
      const uint32_t bits = row_dists[i];
      r.qid[i] = id;
      r.qdist[i] = bits;
      r.qflag[i] = row_flags[i];
      r.qkey[i] = sort_key(bits, id);
    } else {
      r.qkey[i] = KEY_PAD;
    }
    r.qpos[i] = static_cast<uint16_t>(i);
  }
  for (int j = tid; j < pc; j += threads) {
    if (j < c) {
      const uint32_t bits = cand_dists[row * c + j];
      r.cdist[j] = bits;
      r.ckey[j] = sort_key(bits, cand_ids[row * c + j]);
    } else {
      r.ckey[j] = KEY_PAD;
    }
    r.cpos[j] = static_cast<uint16_t>(j);
  }
  __syncthreads();
  int unsorted = 0;
  for (int i = tid + 1; i < cap; i += threads) unsorted |= r.qkey[i - 1] > r.qkey[i];
  unsorted = __syncthreads_or(unsorted);

  // 2. sort the candidates (and a queue that is not sorted), then merge by rank
  bitonic_sort(r.ckey, r.cpos, pc);
  if (unsorted) bitonic_sort(r.qkey, r.qpos, pq);
  for (int i = tid; i < cap; i += threads) {
    const int m = i + count_below(r.ckey, c, r.qkey[i]);
    const uint16_t src = r.qpos[i];
    r.mid[m] = static_cast<int>(r.qid[src]);
    r.msrc[m] = src;
  }
  for (int j = tid; j < c; j += threads) {
    const uint64_t key = r.ckey[j];
    const int m = j + count_up_to(r.qkey, cap, key);
    r.mid[m] = static_cast<int>(static_cast<uint32_t>(key) ^ 0x80000000u);
    r.msrc[m] = FROM_CANDIDATES | r.cpos[j];
  }
  __syncthreads();

  // 3. dedup and the stable partition: a thread takes a run of the merged order
  const int per = (n + threads - 1) / threads;
  const int m0 = min(n, tid * per), m1 = min(n, m0 + per);
  uint32_t mine = 0;
  for (int m = m0; m < m1; ++m) mine += merged_at(r, m).part;
  uint32_t total;
  uint32_t before = block_scan(mine, r.scan, total);
  const int live = total & 0xffff, empty = total >> 16;
  int diff = 0;
  for (int m = m0; m < m1; ++m) {
    const Merged e = merged_at(r, m);
    const int live_before = before & 0xffff, empty_before = before >> 16;
    const int out = e.part == LIVE ? live_before
                  : e.part == EMPTY ? live + empty_before
                  : live + empty + (m - live_before - empty_before);
    before += e.part;
    if (out < cap) {
      if (out == 0) new_head = e.id;
      row_ids[out] = e.id;
      row_dists[out] = e.bits;
      row_flags[out] = e.flag;
      r.fpred[out] = e.flag == 0 && e.id != EMPTY_ID;
      diff |= e.id != static_cast<int>(r.qid[out]);
    }
  }
  diff = __syncthreads_or(diff);

  // 4. the next hop's frontier
  const int per_slot = (cap + threads - 1) / threads;
  const int s0 = min(cap, tid * per_slot), s1 = min(cap, s0 + per_slot);
  uint32_t open = 0;
  for (int s = s0; s < s1; ++s) open += r.fpred[s];
  uint32_t open_total;
  uint32_t rank = block_scan(open, r.scan, open_total);
  const int picks = min(b, static_cast<int>(open_total));
  long long* row_front = frontier + row * b;
  unsigned char* row_ok = frontier_ok + row * b;
  for (int s = s0; s < s1; ++s) {
    if (r.fpred[s]) {
      if (static_cast<int>(rank) < b) {
        row_front[rank] = s;
        row_ok[rank] = 1;
      }
      ++rank;
    } else {
      const int filler = picks + s - static_cast<int>(rank);  // distinct slots, marked invalid
      if (filler < b) {
        row_front[filler] = s;
        row_ok[filler] = 0;
      }
    }
  }
  if (tid != 0) return;
  if (changed != nullptr) changed[row] = diff != 0;
  if (acc.probes != nullptr) {
    const int probes = acc.probes[row] - (diff == 0);
    acc.probes[row] = probes;
    if (new_head != static_cast<int>(r.qid[0]))
      acc.improve_hop[row] = acc.hop_counter != nullptr ? *acc.hop_counter : acc.hop_number;
    if (probes <= 0 || open_total == 0) {
      done[row] = 1;
    } else if (acc.all_done != nullptr) {
      *acc.all_done = 0;
    }
  }
}

}  // namespace

// Threads a block for a row of cap + c entries: one compare-exchange a
// thread per step of the candidates' sort, and at least one thread for every
// four merged entries; a power of two from 64 to 1024.
extern "C" int queue_merge_threads(int cap, int c) {
  const int sort = pow2_at_least(c), merged = pow2_at_least(cap + c) / 2;
  const int want = (sort > merged ? sort : merged) / 2;
  return want < 64 ? 64 : (want > 1024 ? 1024 : want);
}

// ids, flags [q, cap] int32, dists [q, cap] f32, updated in place; cand_ids
// [q, c] int32, cand_dists [q, c] f32; done [q] bool or null; changed [q]
// bool (may be null with probes given); frontier [q, b] int64 and
// frontier_ok [q, b] bool, updated in place (rows that are done keep
// theirs).  probes, improve_hop [q] int32 (with done, updated in place by
// the termination accounting), hop_counter (int32) and all_done (bool) may
// be null.  Every buffer contiguous.
extern "C" int queue_merge(int* ids, float* dists, int* flags, const int* cand_ids,
                           const float* cand_dists, unsigned char* done,
                           unsigned char* changed, long long* frontier,
                           unsigned char* frontier_ok, int* probes, int* improve_hop,
                           const int* hop_counter, int hop_number, unsigned char* all_done,
                           int q, int cap, int c, int b, void* stream) {
  if (q < 0 || cap <= 0 || c <= 0 || b <= 0 || b > cap || cap + c > MAX_WIDTH ||
      (probes != nullptr && (done == nullptr || improve_hop == nullptr)) ||
      (probes == nullptr && changed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return static_cast<int>(cudaSuccess);
  const long long smem = smem_bytes(cap, c);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  queue_merge_kernel<<<static_cast<unsigned>(q), queue_merge_threads(cap, c),
                       static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      ids, reinterpret_cast<uint32_t*>(dists), flags, cand_ids,
      reinterpret_cast<const uint32_t*>(cand_dists), done, changed, frontier, frontier_ok, cap,
      c, b, Accounting{probes, improve_hop, hop_counter, hop_number, all_done});
  return static_cast<int>(cudaGetLastError());
}
