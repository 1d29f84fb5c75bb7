// The bf16 product mainloop that the fast pairwise-distance kernel and the
// fast binned / folded scans share, for Hopper (sm_90a): TMA loads into a ring
// of shared-memory stages, `wgmma` products with f32 accumulation.
//
// One block owns a tile of TILE_ROWS = 128 query rows and walks groups of 128
// corpus rows.  Both operands are bf16, row-major [rows, D] with D a multiple
// of 8 (rows start on 16-byte boundaries: what a tensor map needs; the
// wrappers zero-pad other widths, and zero columns change no dot).  D is cut
// into chunks of CHUNK_K = 64 values = 128 bytes, the span of the 128-byte
// swizzle that both TMA and the `wgmma` shared-memory descriptors use, so a
// chunk of 128 rows is 16 KB and needs no padding to be conflict-free.
//
// * The query tile is loaded once per block (ceil(D / 64) chunks) and stays in
//   shared memory for the whole walk -- as long as it leaves room for three
//   stages beside it.  Wider rows (D > 640 or so) stream instead: a stage then
//   holds a chunk of the corpus rows AND the same chunk of the query tile (32
//   KB), re-read from L2 for every group, so there is no widest row.
// * Corpus chunks stream through a ring of stages, each with a `full`
//   mbarrier (the TMA's byte count completes it) and an `empty` one (the
//   consumers' warps arrive on it once their products have read the stage).
//   One thread of the producer warpgroup keeps the ring full.  TMA zero-fills
//   rows and columns past the matrix, so there are no masks in the loads.
// * Two consumer warpgroups own 64 query rows each.  For a group they start
//   m64n128k16 `wgmma`s over the chunks (A and B both from shared memory),
//   wait, hand the stages back and then run their epilogue (a fold into
//   running minima, or a store) on the 64 accumulator registers a thread
//   holds -- while the other warpgroup's products keep the tensor cores busy.
//
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through dlopen of libcuda (no link-time dependency), and passed
// to the kernels as __grid_constant__ parameters.
//
// Shared-memory budget: (chunks of the query tile + stages) x 16 KB + up to 6
// KB of barriers and norms within 227 KB.  A warpgroup holds the stage of the
// chunk it multiplies and of the one before, and the producer needs one to
// load into, so three stages are the least a resident query tile must leave.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace bf16_tile {

constexpr int TILE_ROWS = 128;                        // query rows per block, corpus rows per group
constexpr int CHUNK_K = 64;                           // bf16 values per row of a chunk (128 bytes)
constexpr int CHUNK_BYTES = TILE_ROWS * CHUNK_K * 2;  // 16 KB
constexpr int WG_ROWS = 64;                           // query rows per consumer warpgroup
constexpr int WG_BYTES = WG_ROWS * CHUNK_K * 2;       // their share of a chunk of the query tile
constexpr int CONSUMER_WARPS = 8;                     // two warpgroups
constexpr int THREADS = 384;                          // consumers first, then the producer warpgroup
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 3;       // that a resident query tile must leave
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block may use
constexpr int ALIGN = 1024;         // the swizzle pattern repeats every 8 rows of 128 bytes

struct Ring {
  uint64_t full[MAX_STAGES];
  uint64_t empty[MAX_STAGES];
  uint64_t x_full;
};

// Position in the ring and the parity of its current round.
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the barrier has left the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One [128 rows x 64 values] box at (column k0, row) of the mapped matrix into
// shared memory; its bytes complete `bar`.  Rows and columns past the matrix
// arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int k0, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(row)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) of contiguous global
// memory into shared memory; they complete `bar` like a tile's.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows 128 bytes apart, groups of 8 rows 1024 bytes apart.  A step of
// 16 values along K inside the chunk adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  uint64_t desc = (addr & 0x3FFFFu) >> 4;
  desc |= 1ull << 16;                   // leading byte offset: unused in this layout
  desc |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  desc |= 1ull << 62;                   // 128-byte swizzle
  return desc;
}
constexpr uint64_t DESC_K16 = 32 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Blocks until at most PENDING commit groups of this warpgroup are in flight.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// d[64 x 128] (+)= a[64 x 16] * b[128 x 16]^T, bf16 in, f32 out; `accumulate`
// false overwrites d.  Thread (warp w of the group, lane 4 * grp + tig) holds
// d[4 * j + 2 * h + e] = row 16 * w + grp + 8 * h, column 8 * j + 2 * tig + e.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The registers changed behind the compiler's back: pin its reads after this.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int REGS>
__device__ __forceinline__ void take_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Shape of one launch's walk, the same for every block.
struct Walk {
  int nk;          // chunks along D
  int last_steps;  // k16 steps of the last chunk (1..4)
  int stages;      // ring depth
  int resident;    // 1: the query tile stays in shared memory; 0: its chunks ride in the stages
};

// A stage: a chunk of 128 corpus rows and, when the query tile streams, the
// same chunk of the query tile behind it.
__host__ __device__ __forceinline__ int stage_bytes(const Walk& walk) {
  return walk.resident ? CHUNK_BYTES : 2 * CHUNK_BYTES;
}
// Shared memory of the resident query tile, in front of the ring.
__host__ __device__ __forceinline__ int query_tile_bytes(const Walk& walk) {
  return walk.resident ? walk.nk * CHUNK_BYTES : 0;
}

// By one thread, before the block's first barrier.  `empty_count`: arrivals
// that hand a stage back (one per warp that reads it).
__device__ __forceinline__ void init_ring(Ring* ring, int stages, int empty_count) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&ring->full[s], 1);
    mbar_init(&ring->empty[s], empty_count);
  }
  mbar_init(&ring->x_full, 1);
}

// Producer, one thread: the block's query tile where it is resident, all
// chunks on one barrier.
__device__ __forceinline__ void load_query_tile(const CUtensorMap* map_x, Ring* ring,
                                                uint32_t x_addr, const Walk& walk, int row0) {
  if (!walk.resident) return;
  mbar_expect_tx(&ring->x_full, walk.nk * CHUNK_BYTES);
  for (int kc = 0; kc < walk.nk; ++kc)
    tma_load(x_addr + kc * CHUNK_BYTES, map_x, &ring->x_full, kc * CHUNK_K, row0);
}

// Producer, one thread: chunk `kc` of the 128 corpus rows from `row` (and of
// the query tile from `row0`, where it streams) into the next stage, once the
// consumers have handed it back.  Returns the stage's `full` barrier, which
// expects `extra_tx` more bytes that the caller sends after it.
__device__ __forceinline__ uint64_t* load_chunk(const CUtensorMap* map_x, const CUtensorMap* map_y,
                                                 Ring* ring, uint32_t ring_addr, Cursor& cur,
                                                 const Walk& walk, int kc, int row0, int row,
                                                 uint32_t extra_tx) {
  uint64_t* full = &ring->full[cur.stage];
  const uint32_t dst = ring_addr + cur.stage * stage_bytes(walk);
  mbar_wait(&ring->empty[cur.stage], cur.phase ^ 1u);
  mbar_expect_tx(full, stage_bytes(walk) + extra_tx);
  tma_load(dst, map_y, full, kc * CHUNK_K, row);
  if (!walk.resident) tma_load(dst + CHUNK_BYTES, map_x, full, kc * CHUNK_K, row0);
  cur.advance(walk.stages);
  return full;
}

// Consumers, before their first group: the resident query tile has landed.
__device__ __forceinline__ void wait_query_tile(Ring* ring, const Walk& walk) {
  if (walk.resident) mbar_wait(&ring->x_full, 0);
}

// Consumer warpgroup: start acc = dots of its 64 query rows (`wg_off` bytes
// into each chunk of the query tile, which is resident from `x_addr` on or
// rides in the stages) with the 128 corpus rows of the next group in the ring.  Each
// chunk's products are a commit group of their own, and a chunk's stage goes
// back to the producer as soon as the next chunk's products are started and
// its own are complete, so a group may be deeper than the ring.  On return the
// last chunk is still in flight and its stage (returned) still held.
__device__ __forceinline__ int group_start(float (&acc)[64], uint32_t x_addr, uint32_t wg_off,
                                           uint32_t ring_addr, Ring* ring, Cursor& cur,
                                           const Walk& walk, int lane) {
  int held = cur.stage;
  wgmma_fence();
  for (int kc = 0; kc < walk.nk; ++kc) {
    mbar_wait(&ring->full[cur.stage], cur.phase);
    const uint32_t stage = ring_addr + cur.stage * stage_bytes(walk);
    const uint64_t a =
        make_desc((walk.resident ? x_addr + kc * CHUNK_BYTES : stage + CHUNK_BYTES) + wg_off);
    const uint64_t b = make_desc(stage);
    const int steps = kc == walk.nk - 1 ? walk.last_steps : CHUNK_K / 16;
#pragma unroll
    for (int ks = 0; ks < CHUNK_K / 16; ++ks)
      if (ks < steps) wgmma_m64n128k16(acc, a + ks * DESC_K16, b + ks * DESC_K16, (kc | ks) != 0);
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();  // everything but this chunk's products is complete
      if (lane == 0) mbar_arrive(&ring->empty[held]);
    }
    held = cur.stage;
    cur.advance(walk.stages);
  }
  return held;
}

// Wait until the group's products are complete, so that acc is, and hand its
// last stage back.
__device__ __forceinline__ void group_finish(float (&acc)[64], Ring* ring, int held, int lane) {
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(&ring->empty[held]);
}

// ---------------------------------------------------------------------------
// Host side.

// The walk of a D-wide product with `extra` bytes of shared memory beside the
// tiles: the query tile is resident where that leaves three stages, else it
// streams through stages of twice the size.
inline Walk plan_walk(int d, int extra) {
  Walk walk;
  walk.nk = (d + CHUNK_K - 1) / CHUNK_K;
  walk.last_steps = (d - (walk.nk - 1) * CHUNK_K + 15) / 16;
  const int room = (SMEM_LIMIT - ALIGN - extra) / CHUNK_BYTES;
  walk.resident = room - walk.nk >= MIN_STAGES;
  const int stages = walk.resident ? room - walk.nk : room / 2;
  walk.stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  return walk;
}

inline int smem_bytes(const Walk& walk, int extra) {
  return ALIGN + query_tile_bytes(walk) + walk.stages * stage_bytes(walk) + extra;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (libcuda != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Tensor map of a row-major bf16 matrix [rows, d] cut into [128 x 64] boxes in
// the 128-byte swizzle.  Returns a cudaError_t value.
inline int encode_map(CUtensorMap* map, const void* base, int rows, int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (d % 8 != 0 || reinterpret_cast<size_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {CHUNK_K, TILE_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Groups of 128 corpus rows (or corpus tiles) per block, into `per`: enough
// blocks for about eight rounds over the current device, each long enough to
// hide its prologue.  Returns a cudaError_t value.
inline int per_block(long long q_tiles, long long items, int* per) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = q_tiles * items / ((long long)sms * 8);
  *per = (int)(n < 1 ? 1 : (n > items ? items : n));
  return 0;
}

}  // namespace bf16_tile
