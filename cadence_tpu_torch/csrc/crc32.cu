// Kernel C: crc32.
//
// Replaces the JAX package's ops/crc.py `crc32_rows` (with `_make_tables`;
// `replay_to_crc` is kernels A, B and this one in turn): the IEEE CRC32
// of each [width] int64 row's little-endian bytes, equal to zlib.crc32.
// The result is written to an int64 tensor as the unsigned value (torch's
// uint32 has almost no ops).
//
// Bound. Bytes: 8 * width read and 8 written a row (720 at the payload's
// 89 words). Operations: 8 slice-by-8 lookups in shared memory a word,
// with their shifts, masks and XORs.
//
// Design.
// - Rows come in as contiguous tiles. A tile of R rows (R even, so every
//   tile starts 16-byte aligned on a 16-byte-aligned base, which the
//   wrapper requires) is one span of R * 8 * width bytes that the block
//   copies into shared memory with cp.async, 16 bytes a thread, neighbours
//   on neighbouring units (coalesced). A persistent, one-wave grid walks
//   the tiles with C_STAGES tiles in flight a block, so the next tile's
//   copy overlaps this tile's hashing.
// - A tile's rows sit in shared memory at an odd stride of 8-byte words
//   (the width, or the width + 1 where it is even, copied a word at a
//   time), so the 16 lanes of a half-warp that each read a word of their
//   own row hit 16 distinct bank pairs.
// - The 8 KB slice-by-8 table is built once by each block of the
//   persistent grid, not once a 256-row block, and the block size is free
//   of it.
// - A row is split among S lanes (1 <= S <= 8; C_SPLIT, or lanes_for(W) at
//   launch when it is 0): lane s hashes segment s (ceil(width / S) words;
//   only segment 0 is seeded with 0xFFFFFFFF), then shifts its register
//   past the bytes after its segment, and the P lanes of the row (P the
//   power of two >= S, inside one warp) XOR their registers together with
//   __shfl_xor_sync. CRC is linear, as zlib's crc32_combine uses:
//   crc(A || B) = shift_|B|(crc(A)) ^ crc(B). The shift past n bytes is a
//   linear map on 32 bits, applied as four byte-indexed tables of 256
//   words, made on the host for each (width, S) and cached on the card.
//   So at small W the card still has enough lanes (8 a row at the
//   feeder's 4,096 rows, 4 from 16,384 on).
// On an H100 the kernel takes 1.2-1.35x its byte bound plus the card's
// launch floor at its launch shapes; more tiles staged, other tile sizes
// and interleaved copies of the table were no faster (PERF.md).
// The device code is phase functions (table_phase, copy_phase,
// hash_phase) that crc_block runs in barrier order, one step at a time
// through a visitor: the kernel's runs a step on its own thread and meets
// the block at a barrier; a host build's (tests/test_torch_crc_verify_host.py)
// runs each thread of the block in turn, a warp's lanes side by side.
#include <cstddef>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t POLY = 0xEDB88320u;  // reflected IEEE polynomial
constexpr uint32_t CRC_INIT = 0xFFFFFFFFu;
constexpr int C_ROWS = 32;     // rows a tile at most (even)
constexpr int C_STAGES = 2;    // tiles in flight a block
constexpr int C_SPLIT = 0;     // lanes a row; 0: lanes_for(W) at launch
constexpr int C_MAX_SPLIT = 8;
constexpr int C_TABLE_U64 = 8 * 256 / 2;  // the slice-by-8 table, in 8-byte words
constexpr int C_SHIFT_WORDS = 4 * 256;   // one segment's shift tables
static_assert(C_SPLIT >= 0 && C_SPLIT <= C_MAX_SPLIT, "C_SPLIT: 0 (chosen from W) or 1 .. 8");
static_assert(C_ROWS % 2 == 0 && C_STAGES >= 2, "tiles of an even row count, two or more staged");

struct CrcArgs {
  const int64_t* rows;
  int64_t* out;
  int64_t W;
  int width;
  int S;                   // lanes a row that hash a segment
  int tile_rows;           // rows a tile (even, at most C_ROWS)
  const uint32_t* shift;   // [S - 1][4][256]: lane s's shift past the bytes after its segment
};

// A tile row's stride in shared memory, in 8-byte words: odd.
__host__ __device__ inline int row_stride(int width) { return width | 1; }

// Shared bytes of a block: the table, then C_STAGES tiles.
__host__ __device__ inline size_t smem_bytes(int width, int tile_rows) {
  return C_TABLE_U64 * 8 + size_t(C_STAGES) * tile_rows * row_stride(width) * 8;
}

// Lane s's segment of a row, words [w0, w1) (empty past the width).
struct Segment {
  int w0, w1;
};

__host__ __device__ inline Segment segment(int width, int S, int s) {
  const int len = (width + S - 1) / S;
  const int w0 = s * len < width ? s * len : width;
  return {w0, w0 + len < width ? w0 + len : width};
}

// Table phase k of 8 (a barrier after each): k = 0 builds T[0], the
// classic byte table, and k > 0 T[k], T[k-1] advanced by one zero byte.
__device__ inline void table_phase(uint32_t* t, int k, int tid, int nthreads) {
  for (int i = tid; i < 256; i += nthreads) {
    uint32_t v;
    if (k == 0) {
      v = static_cast<uint32_t>(i);
      for (int b = 0; b < 8; ++b) v = (v >> 1) ^ ((v & 1u) ? POLY : 0u);
    } else {
      const uint32_t prev = t[(k - 1) * 256 + i];
      v = (prev >> 8) ^ t[prev & 0xFFu];
    }
    t[k * 256 + i] = v;
  }
}

// Thread tid's share of the copy of `tile` into a stage (cp.async; the
// caller commits the group): 16-byte units of the tile's span where the
// width is odd (the last 8 bytes alone where the span's words are odd),
// else a word at a time into rows padded to the odd stride.
__device__ inline void copy_phase(const CrcArgs& a, int64_t tile, uint64_t* stage, int tid,
                                  int nthreads) {
  const int64_t r0 = tile * a.tile_rows;
  const int64_t n = a.W - r0 < a.tile_rows ? a.W - r0 : a.tile_rows;
  const int words = static_cast<int>(n) * a.width;
  const int64_t* src = a.rows + r0 * a.width;
  if (a.width & 1) {
    for (int u = tid; u < words / 2; u += nthreads)
      __pipeline_memcpy_async(stage + 2 * u, src + 2 * u, 16);
    if ((words & 1) && tid == nthreads - 1)
      __pipeline_memcpy_async(stage + words - 1, src + words - 1, 8);
  } else {
    for (int i = tid; i < words; i += nthreads) {
      const int r = i / a.width;
      __pipeline_memcpy_async(stage + r * (a.width + 1) + (i - r * a.width), src + i, 8);
    }
  }
}

// Lane s's register over its segment of tile row r, shifted past the bytes
// after the segment (segment 0 seeded with 0xFFFFFFFF, the others with 0).
__device__ inline uint32_t lane_crc(const CrcArgs& a, const uint64_t* stage, const uint32_t* t,
                                    int r, int s) {
  const Segment g = segment(a.width, a.S, s);
  const uint64_t* p = stage + r * row_stride(a.width);
  uint32_t crc = s == 0 ? CRC_INIT : 0u;
  for (int i = g.w0; i < g.w1; ++i) {
    const uint64_t word = p[i];
    const uint32_t x = crc ^ static_cast<uint32_t>(word);
    const uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = t[7 * 256 + (x & 0xFFu)] ^ t[6 * 256 + ((x >> 8) & 0xFFu)] ^
          t[5 * 256 + ((x >> 16) & 0xFFu)] ^ t[4 * 256 + (x >> 24)] ^
          t[3 * 256 + (hi & 0xFFu)] ^ t[2 * 256 + ((hi >> 8) & 0xFFu)] ^
          t[256 + ((hi >> 16) & 0xFFu)] ^ t[hi >> 24];
  }
  if (s < a.S - 1) {
    const uint32_t* m = a.shift + s * C_SHIFT_WORDS;
    crc = __ldg(m + (crc & 0xFFu)) ^ __ldg(m + 256 + ((crc >> 8) & 0xFFu)) ^
          __ldg(m + 512 + ((crc >> 16) & 0xFFu)) ^ __ldg(m + 768 + (crc >> 24));
  }
  return crc;
}

// The hash of a staged tile: thread tid is lane tid % P of tile row tid / P;
// the row's P lanes (one warp holds 32 / P rows) XOR their registers and
// lane 0 writes the row's CRC. Every lane of the warp takes part in the
// shuffles, rows past the tile with 0.
template <int P>
__device__ inline void hash_phase(const CrcArgs& a, int64_t tile, const uint64_t* stage,
                                  const uint32_t* t, int tid) {
  const int r = tid / P, s = tid % P;
  const int64_t row = tile * a.tile_rows + r;
  const bool live = r < a.tile_rows && row < a.W;
  uint32_t v = live && s < a.S ? lane_crc(a, stage, t, r, s) : 0u;
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if (live && s == 0) a.out[row] = static_cast<int64_t>(v ^ CRC_INIT);
}

// A block's schedule over its tiles (block, block + grid, ...), the same
// on the card and in a host build: step(fn, warp) runs fn(tid) for each of
// the block's C_ROWS * P threads, then meets them at a barrier (`warp`:
// fn shuffles within warps). First the copies of the block's first
// C_STAGES - 1 tiles are issued and the table is built in 8 steps; then,
// a tile at a time, the copy C_STAGES - 1 tiles ahead is issued and this
// tile's awaited, and the tile is hashed (its barrier frees the stage for
// that later copy).
template <int P, class Step>
__device__ inline void crc_block(const CrcArgs& a, uint64_t* smem, int64_t block, int64_t grid,
                                 Step step) {
  constexpr int nthreads = C_ROWS * P;
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  uint64_t* stages = smem + C_TABLE_U64;
  const size_t stage_words = size_t(a.tile_rows) * row_stride(a.width);
  const int64_t tiles = (a.W + a.tile_rows - 1) / a.tile_rows;
  for (int k = 0; k < 8; ++k)
    step([&](int tid) {
      if (k == 0)
        for (int j = 0; j + 1 < C_STAGES; ++j) {
          const int64_t t = block + int64_t(j) * grid;
          if (t < tiles) copy_phase(a, t, stages + j * stage_words, tid, nthreads);
          __pipeline_commit();
        }
      table_phase(table, k, tid, nthreads);
    }, false);
  int i = 0;
  for (int64_t tile = block; tile < tiles; tile += grid, ++i) {
    const int64_t ahead = tile + int64_t(C_STAGES - 1) * grid;
    step([&](int tid) {
      if (ahead < tiles)
        copy_phase(a, ahead, stages + ((i + C_STAGES - 1) % C_STAGES) * stage_words, tid,
                   nthreads);
      __pipeline_commit();
      __pipeline_wait_prior(C_STAGES - 1);  // this thread's copies of `tile` have landed
    }, false);
    step([&](int tid) {
      hash_phase<P>(a, tile, stages + (i % C_STAGES) * stage_words, table, tid);
    }, true);
  }
}

// Host: the byte table T[0].
inline void byte_table(uint32_t* t0) {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int b = 0; b < 8; ++b) c = (c >> 1) ^ ((c & 1u) ? POLY : 0u);
    t0[i] = c;
  }
}

// Host: the four byte-indexed tables of 256 words that shift a CRC
// register past n zero bytes: shift(x) = T[0][x & 255] ^ T[1][(x >> 8) &
// 255] ^ T[2][(x >> 16) & 255] ^ T[3][x >> 24] (the map is linear).
inline void shift_tables(int64_t n, uint32_t* out) {
  uint32_t t0[256], image[32];
  byte_table(t0);
  for (int b = 0; b < 32; ++b) {
    uint32_t x = 1u << b;
    for (int64_t i = 0; i < n; ++i) x = (x >> 8) ^ t0[x & 0xFFu];
    image[b] = x;
  }
  for (int j = 0; j < 4; ++j)
    for (int v = 0; v < 256; ++v) {
      uint32_t acc = 0;
      for (int k = 0; k < 8; ++k)
        if ((v >> k) & 1) acc ^= image[8 * j + k];
      out[j * 256 + v] = acc;
    }
}

// Host: lanes s = 0 .. S - 2's shift tables for rows of `width` words split
// S ways ([S - 1][4][256]; the last lane's shift is the identity).
inline void combine_tables(int width, int S, uint32_t* out) {
  for (int s = 0; s + 1 < S; ++s)
    shift_tables(8 * int64_t(width - segment(width, S, s).w1), out + s * C_SHIFT_WORDS);
}

// Host: rows a tile, even and at most C_ROWS, whose C_STAGES stages and
// table fit in `smem` bytes (0: none fits).
inline int tile_rows_for(int width, size_t smem) {
  for (int r = C_ROWS; r >= 2; r -= 2)
    if (smem_bytes(width, r) <= smem) return r;
  return 0;
}

// Host: lanes a row at W rows, when C_SPLIT leaves it open: 8 where the
// card has fewer than 64 rows an SM, else 4 (chosen by timing 1, 2, 4 and
// 8 at the launch shapes; PERF.md).
inline int lanes_for(int64_t W, int sms) {
  return W < int64_t(sms) * 64 ? 8 : 4;
}

// The kernel and its launcher (nvcc only).

// A step of crc_block on the card: this thread's part, then the barrier.
struct BlockStep {
  template <class F>
  __device__ void operator()(F fn, bool) const {
    fn(static_cast<int>(threadIdx.x));
    __syncthreads();
  }
};

template <int P>
__global__ void __launch_bounds__(C_ROWS * P) crc32_kernel(CrcArgs a) {
  extern __shared__ __align__(16) uint64_t c_smem[];
  crc_block<P>(a, c_smem, blockIdx.x, gridDim.x, BlockStep{});
}

}  // namespace

#include <map>
#include <mutex>
#include <tuple>
#include <vector>

namespace {

std::mutex c_mutex;

// What one device and width launch with: the grid bound and rows a tile
// of each instance, and each split's shift tables on the card (made once).
struct CrcDevice {
  int sms = 0;
  std::map<std::tuple<int, int>, std::tuple<int, int>> grid;  // (P, width) -> (blocks, rows)
  std::map<std::tuple<int, int>, uint32_t*> shift;            // (width, S) -> tables
};

template <int P>
cudaError_t crc_grid(CrcDevice& d, int dev, int width, int* blocks, int* rows) {
  const auto key = std::make_tuple(P, width);
  auto it = d.grid.find(key);
  if (it == d.grid.end()) {
    int optin = 0, per_sm = 0;
    cudaError_t rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc != cudaSuccess) return rc;
    const int r = tile_rows_for(width, static_cast<size_t>(optin));
    if (r == 0) return cudaErrorInvalidValue;
    const size_t smem = smem_bytes(width, r);
    if ((rc = cudaFuncSetAttribute(crc32_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin)) != cudaSuccess)
      return rc;
    if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32_kernel<P>, C_ROWS * P,
                                                            smem)) != cudaSuccess)
      return rc;
    it = d.grid.emplace(key, std::make_tuple(d.sms * (per_sm > 0 ? per_sm : 1), r)).first;
  }
  *blocks = std::get<0>(it->second);
  *rows = std::get<1>(it->second);
  return cudaSuccess;
}

cudaError_t crc_shift(CrcDevice& d, int width, int S, cudaStream_t st, const uint32_t** out) {
  *out = nullptr;
  if (S == 1) return cudaSuccess;
  const auto key = std::make_tuple(width, S);
  auto it = d.shift.find(key);
  if (it == d.shift.end()) {
    std::vector<uint32_t> host(size_t(S - 1) * C_SHIFT_WORDS);
    combine_tables(width, S, host.data());
    const size_t bytes = host.size() * 4;
    uint32_t* dev_tables = nullptr;
    cudaError_t rc = cudaMalloc(&dev_tables, bytes);
    if (rc != cudaSuccess) return rc;
    rc = cudaMemcpyAsync(dev_tables, host.data(), bytes, cudaMemcpyHostToDevice, st);
    if (rc == cudaSuccess) rc = cudaStreamSynchronize(st);
    if (rc != cudaSuccess) {
      cudaFree(dev_tables);
      return rc;
    }
    it = d.shift.emplace(key, dev_tables).first;
  }
  *out = it->second;
  return cudaSuccess;
}

template <int P>
cudaError_t launch_crc(CrcDevice& d, int dev, CrcArgs a, cudaStream_t st) {
  int max_blocks = 0;
  cudaError_t rc = crc_grid<P>(d, dev, a.width, &max_blocks, &a.tile_rows);
  if (rc != cudaSuccess) return rc;
  if ((rc = crc_shift(d, a.width, a.S, st, &a.shift)) != cudaSuccess) return rc;
  const int64_t tiles = (a.W + a.tile_rows - 1) / a.tile_rows;
  const unsigned blocks = static_cast<unsigned>(tiles < max_blocks ? tiles : max_blocks);
  crc32_kernel<P><<<blocks, C_ROWS * P, smem_bytes(a.width, a.tile_rows), st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// rows: [W, width] int64, 16-byte aligned; out: [W] int64.
extern "C" int cadence_crc32(const void* rows, void* out, int64_t W, int width, void* stream) {
  if (W <= 0) return 0;
  if (width <= 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::map<int, CrcDevice> devices;
  std::lock_guard<std::mutex> lock(c_mutex);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  CrcDevice& d = devices[dev];
  if (d.sms == 0 &&
      (rc = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(rc);
  CrcArgs a{static_cast<const int64_t*>(rows), static_cast<int64_t*>(out), W, width,
            C_SPLIT > 0 ? C_SPLIT : lanes_for(W, d.sms), 0, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.S <= 1) rc = launch_crc<1>(d, dev, a, st);
  else if (a.S <= 2) rc = launch_crc<2>(d, dev, a, st);
  else if (a.S <= 4) rc = launch_crc<4>(d, dev, a, st);
  else rc = launch_crc<8>(d, dev, a, st);
  return static_cast<int>(rc);
}
