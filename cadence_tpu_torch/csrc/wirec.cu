// Kernel E: decode_wirec.
//
// Replaces the JAX package's ops/wirec.py `decode_wirec` (with `_read_le`):
// the full-tensor decode of a wirec slab [W, E, B] uint8, with its bases
// [W, K] int64 and n_events [W] int32, into the int64 lanes [W, E, 18].
// The replay path does not run it (kernel A decodes in its own event loop);
// it is the full-tensor decode, and the independent check that the fused
// reader decodes what was packed.
//
// Bound: bytes. The slab, bases and n_events read once and the [W, E, 18]
// int64 lanes written once; the output is most of it (144 B an event row
// against B, 12-20 on the port's corpora, read). A handful of integer
// operations a value.
//
// Design: a warp a workflow, a lane an event row.
// - Warp w of the grid decodes workflow w in chunks of E_ROWS = 32 event
//   rows, in order, so a DELTA lane's running sum never leaves the warp.
//   Blocks of E_WARPS = 8 warps, at most 64 registers a thread, so 4
//   blocks (32 warps) fit an SM where the shared memory allows. The
//   hardware hands blocks to SMs as they free up: on an H100 a persistent
//   one-wave grid walking the workflows was 8% slower at 40,960 x 123
//   (PERF.md).
// - A chunk's slab bytes are one contiguous span (the slab is [W, E, B]).
//   The warp copies it into a stage in shared memory with 16-byte cp.async
//   from the 16-byte boundary at or before its first byte (its start,
//   (w * E + row) * B, is aligned only by chance; the 16-byte blocks read
//   each hold a byte of the slab, so they never leave its allocation's
//   pages), beside the workflow's bases row and n_events. The copies run
//   E_STAGES - 1 chunks ahead of the decode. No byte is loaded from device
//   memory one at a time or by more than one lane.
// - Lane r decodes row r of the chunk from shared memory. The profile's
//   18 lanes are unrolled, so every profile field is a parameter at a fixed
//   offset and its kind a warp-uniform branch. ABS, TSREL_NZ and CONST
//   need nothing of the other rows. A DELTA lane's code * scale is an
//   inclusive scan across the 32 lanes (five __shfl_up_sync steps on
//   uint64_t, which wraps as int64 does) from the carry: bases[w, base] at
//   the first chunk, lane 31's value of the chunk before after it (kept in
//   shared memory, a slot for each parity of the chunk, so a slot is never
//   written while it is read). Lanes past E add 0. Padding rows advance
//   the carry as real rows do; only their output is masked.
// - The 32 decoded rows are staged in shared memory as 9 16-byte pairs a
//   row (144 B apart: a 16-byte access is served 8 lanes at a time, and 8
//   consecutive rows start in 8 distinct groups of 4 banks, so the stores
//   are free of bank conflicts without padding), then stored as the tile's
//   contiguous 16-byte units, 9 a lane, with evict-first stores (the
//   output is far larger than L2). A short last chunk stores its rows
//   only. Each lane storing its own row's 16-byte pairs, 144 B from its
//   neighbour's, was 6x slower on an H100 (PERF.md).
// The warp's whole schedule is decode_warp, the same on the card and in
// a host build (tests/test_torch_wirec_host.py), where the 32 lanes of a
// warp run as threads that meet at each shuffle and __syncwarp.
#include "wirec.cuh"

#include <cstddef>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cadence {
namespace {

constexpr int E_ROWS = 32;              // event rows a chunk: one a lane
constexpr int E_STAGES = 3;             // chunks in flight a warp, the decoded one included
constexpr int E_WARPS = 8;              // warps a block
constexpr int E_BLOCKS_PER_SM = 4;      // the launch bounds: at most 64 registers a thread
constexpr int E_ROW_BYTES = WIREC_LANES * 8;            // an output row: 144
constexpr int E_TILE_BYTES = E_ROWS * E_ROW_BYTES;       // a chunk's output: 4,608
constexpr int E_CARRY_BYTES = 2 * WIREC_LANES * 8;      // the DELTA carries, two slots
constexpr unsigned E_FULL = 0xFFFFFFFFu;
static_assert(E_STAGES >= 2, "one chunk copied ahead at least");
static_assert(E_ROW_BYTES % 16 == 0, "output rows are whole 16-byte units");

struct DecodeArgs {
  const uint8_t* slab;
  const int64_t* bases;
  const int32_t* n_events;
  int64_t* out;  // 16-byte aligned
  int64_t W, E;
  int B, K;
};

// A stage: the workflow's bases row [K] int64, its n_events, then (at a
// 16-byte boundary) the chunk's slab bytes from the 16-byte boundary at
// or before the first: at most 32 * B + 15 bytes, 2 * B + 1 units.
__host__ __device__ inline int head_bytes(int K) { return (8 * K + 4 + 15) / 16 * 16; }
__host__ __device__ inline int stage_bytes(int B, int K) {
  return head_bytes(K) + 16 * (2 * B + 1);
}

// Shared bytes of a warp: the output tile, the carries, the stages.
__host__ __device__ inline size_t warp_bytes(int B, int K) {
  return size_t(E_TILE_BYTES) + E_CARRY_BYTES + size_t(E_STAGES) * stage_bytes(B, K);
}

// Chunk `i` of workflow w: its first row and its rows.
struct Chunk {
  int64_t w, r0;
  int rows;
};

__device__ inline Chunk chunk_at(const DecodeArgs& a, int64_t w, int64_t i) {
  const int64_t r0 = i * E_ROWS;
  const int64_t left = a.E - r0;
  return {w, r0, static_cast<int>(left < E_ROWS ? left : E_ROWS)};
}

// The first slab byte of a chunk, as an address.
__device__ inline uintptr_t chunk_first(const DecodeArgs& a, const Chunk& c) {
  return reinterpret_cast<uintptr_t>(a.slab) + uintptr_t((c.w * a.E + c.r0) * a.B);
}

// This lane's share of chunk c's copy into `stage` (cp.async; the caller
// commits the group).
__device__ inline void copy_chunk(const DecodeArgs& a, const Chunk& c, uint8_t* stage, int lane) {
  if (lane < a.K) __pipeline_memcpy_async(stage + 8 * lane, a.bases + c.w * a.K + lane, 8);
  if (lane == E_ROWS - 1) __pipeline_memcpy_async(stage + 8 * a.K, a.n_events + c.w, 4);
  const uintptr_t first = chunk_first(a, c);
  const uintptr_t from = first & ~uintptr_t(15);
  // (no slab bytes, B = 0, no copy: the slab may have no allocation)
  const int units = a.B ? static_cast<int>((first - from + uintptr_t(c.rows) * a.B + 15) / 16) : 0;
  uint8_t* dst = stage + head_bytes(a.K);
  for (int u = lane; u < units; u += E_ROWS)
    __pipeline_memcpy_async(dst + 16 * u, reinterpret_cast<const void*>(from + 16 * u), 16);
}

// Lane r's row of chunk c (chunk `i` of its workflow, in `stage`)
// decoded into row r of the tile, its DELTA lanes scanned across the warp.
__device__ __forceinline__ void decode_chunk(const DecodeArgs& a, const WirecProfile& p,
                                             const Chunk& c, int64_t i, const uint8_t* stage,
                                             uint8_t* tile, int64_t* carry, int lane) {
  const int64_t* base = reinterpret_cast<const int64_t*>(stage);
  const int64_t n = *reinterpret_cast<const int32_t*>(stage + 8 * a.K);
  const uint8_t* row =
      stage + head_bytes(a.K) + (chunk_first(a, c) & 15) + size_t(lane) * a.B;
  const int64_t* carry_in = carry + (i & 1) * WIREC_LANES;
  int64_t* carry_out = carry + ((i + 1) & 1) * WIREC_LANES;
  const bool live = lane < c.rows;
  const bool real = c.r0 + lane < n;
  int64_t lo = 0;
#pragma unroll
  for (int j = 0; j < WIREC_LANES; ++j) {
    const WirecLane& l = p.lane[j];
    int64_t v = l.cnst;
    if (l.kind != KIND_CONST) {
      const int64_t code = live ? wirec_read_le(row, l.offset, l.width) : 0;
      if (l.kind == KIND_DELTA) {
        uint64_t x = static_cast<uint64_t>(code) * static_cast<uint64_t>(l.scale);
#pragma unroll
        for (int o = 1; o < E_ROWS; o <<= 1) {
          const uint64_t y = __shfl_up_sync(E_FULL, x, o);
          if (lane >= o) x += y;
        }
        x += static_cast<uint64_t>(c.r0 == 0 ? base[l.base] : carry_in[j]);
        if (lane == E_ROWS - 1) carry_out[j] = static_cast<int64_t>(x);
        v = static_cast<int64_t>(x);
      } else {
        int64_t unused = 0;
        v = wirec_lane_value(l, code, unused, l.base >= 0 ? base[l.base] : 0);
      }
    }
    if (!real) v = wirec_pad_value(j);
    if (j % 2 == 0) {
      lo = v;
    } else if (live) {
      *reinterpret_cast<longlong2*>(tile + size_t(lane) * E_ROW_BYTES + 8 * (j - 1)) =
          make_longlong2(lo, v);
    }
  }
}

// Chunk c's rows of the tile stored to the output, 16-byte units in
// order, lane u % 32 storing unit u, evict-first (st.global.cs).
__device__ __forceinline__ void store_chunk(const DecodeArgs& a, const Chunk& c,
                                            const uint8_t* tile, int lane) {
  longlong2* dst = reinterpret_cast<longlong2*>(a.out + (c.w * a.E + c.r0) * WIREC_LANES);
  const longlong2* src = reinterpret_cast<const longlong2*>(tile);
  const int units = c.rows * (E_ROW_BYTES / 16);
#pragma unroll
  for (int k = 0; k < E_ROW_BYTES / 16; ++k) {
    const int u = lane + k * E_ROWS;
    if (u < units) __stcs(dst + u, src[u]);
  }
}

// A warp's schedule: workflow w (none past W) chunk by chunk, the copies
// E_STAGES - 1 chunks ahead. `smem` is the warp's own warp_bytes(B, K)
// bytes, 16-byte aligned. Every lane runs it whole.
__device__ inline void decode_warp(const DecodeArgs& a, const WirecProfile& p, uint8_t* smem,
                                   int64_t w, int lane) {
  uint8_t* tile = smem;
  int64_t* carry = reinterpret_cast<int64_t*>(smem + E_TILE_BYTES);
  uint8_t* stages = smem + E_TILE_BYTES + E_CARRY_BYTES;
  const int sb = stage_bytes(a.B, a.K);
  const int64_t chunks = w < a.W ? (a.E + E_ROWS - 1) / E_ROWS : 0;
  for (int64_t i = 0; i + 1 < E_STAGES; ++i) {
    if (i < chunks) copy_chunk(a, chunk_at(a, w, i), stages + i * sb, lane);
    __pipeline_commit();
  }
  for (int64_t i = 0; i < chunks; ++i) {
    const int64_t ahead = i + E_STAGES - 1;
    if (ahead < chunks)
      copy_chunk(a, chunk_at(a, w, ahead), stages + (ahead % E_STAGES) * sb, lane);
    __pipeline_commit();
    __pipeline_wait_prior(E_STAGES - 1);  // this lane's copies of chunk i have landed
    __syncwarp();                         // and every lane's
    const Chunk c = chunk_at(a, w, i);
    decode_chunk(a, p, c, i, stages + (i % E_STAGES) * sb, tile, carry, lane);
    __syncwarp();  // the tile is whole; the stage is free for the copy E_STAGES - 1 ahead
    store_chunk(a, c, tile, lane);
    __syncwarp();  // the tile is free for the next chunk
  }
}

// Host: blocks of the grid for W workflows, a warp each.
inline int64_t grid_blocks(int64_t W) { return (W + E_WARPS - 1) / E_WARPS; }

// The kernel and its launcher (nvcc only).

__global__ void __launch_bounds__(E_WARPS * 32, E_BLOCKS_PER_SM)
    decode_wirec_kernel(DecodeArgs a, const __grid_constant__ WirecProfile p) {
  extern __shared__ __align__(16) uint8_t e_smem[];
  const int warp = static_cast<int>(threadIdx.x) / 32;
  decode_warp(a, p, e_smem + warp * warp_bytes(a.B, a.K), int64_t(blockIdx.x) * E_WARPS + warp,
              static_cast<int>(threadIdx.x) % 32);
}

}  // namespace
}  // namespace cadence

#include <map>
#include <mutex>

namespace {

std::mutex e_mutex;

}  // namespace

extern "C" int cadence_decode_wirec(const void* slab, const void* bases, const void* n_events,
                                    void* out, int64_t W, int64_t E, int B, int K,
                                    const int64_t* profile, void* stream) {
  using namespace cadence;
  if (W <= 0 || E <= 0) return 0;
  if (B < 0 || K < 0 || K > WIREC_LANES || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const WirecProfile p = wirec_profile_from(profile);
  const size_t smem = E_WARPS * warp_bytes(B, K);
  static std::map<int, int> optin;  // by device: the shared bytes a block may opt in to, once set
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  {
    std::lock_guard<std::mutex> lock(e_mutex);
    if (optin.find(dev) == optin.end()) {
      int bytes = 0;
      if ((rc = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
              cudaSuccess ||
          (rc = cudaFuncSetAttribute(decode_wirec_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
              cudaSuccess)
        return static_cast<int>(rc);
      optin[dev] = bytes;
    }
    if (smem > static_cast<size_t>(optin[dev])) return static_cast<int>(cudaErrorInvalidValue);
  }
  const DecodeArgs a{static_cast<const uint8_t*>(slab), static_cast<const int64_t*>(bases),
                     static_cast<const int32_t*>(n_events), static_cast<int64_t*>(out),
                     W, E, B, K};
  decode_wirec_kernel<<<static_cast<unsigned>(grid_blocks(W)), E_WARPS * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}
