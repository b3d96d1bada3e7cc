// Kernel D: verify_rows.
//
// Replaces the JAX package's ops/replay.py `verify_rows`: one mismatch bit
// per workflow, set when any word of its payload row differs from the
// expected row OR its device-chosen current branch differs from the
// expected branch.
//
// Bound: bytes, 2 * 8 * width + 2 * 4 read and 1 written a workflow (1,433
// at the payload's 89 words); one compare a word.
//
// Design. `rows` and `expected` are two flat streams of the same shape.
// - A block takes a tile of D_ROWS rows (even, so the tile's span starts
//   16-byte aligned on 16-byte-aligned bases, which the wrapper requires)
//   and its threads read 16-byte units of both spans with coalesced
//   non-coherent vector loads (ld.global.nc), D_UNROLL units a thread in
//   flight. Nothing is reused, so nothing is staged.
// - A unit whose words differ sets the flag of the row each differing word
//   belongs to (word / width, as a multiply by the width's reciprocal), a
//   byte in shared memory. After a barrier the block writes its rows'
//   bytes with branch != expected_branch OR-ed in.
// - No early exit: the common case (no mismatch) reads every row whole.
// - The grid is one wave of the card (the occupancy query's blocks a
//   multiprocessor times the multiprocessors), walking the tiles.
// The device code is phase functions (clear_phase, compare_phase,
// out_phase) that verify_block runs in barrier order, one step at a time
// through a visitor: the kernel's runs a step on its own thread and meets
// the block at a barrier; a host build's (tests/test_torch_crc_verify_host.py)
// runs each thread of the block in turn.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int D_ROWS = 8;        // rows a tile (even)
constexpr int D_THREADS = 256;
constexpr int D_UNROLL = 2;      // 16-byte units of each stream a thread loads before comparing
constexpr int D_MAX_WIDTH = 1 << 13;  // row_of is exact below it

struct VerifyArgs {
  const int64_t* rows;
  const int64_t* expected;
  const int32_t* branch;
  const int32_t* expected_branch;
  uint8_t* out;
  int64_t W;
  int width;
  uint64_t reciprocal;  // ceil(2^32 / width)
};

// ceil(2^32 / width): row_of(i) = i / width exactly for i * width < 2^32
// (i below D_ROWS * width, width below D_MAX_WIDTH).
inline uint64_t reciprocal_of(int width) {
  return ((uint64_t(1) << 32) + uint64_t(width) - 1) / uint64_t(width);
}

__device__ inline int row_of(uint32_t word, uint64_t reciprocal) {
  return static_cast<int>((uint64_t(word) * reciprocal) >> 32);
}

__device__ inline void clear_phase(uint8_t* flag, int tid) {
  if (tid < D_ROWS) flag[tid] = 0;
}

// Thread tid's compare of `tile`: its 16-byte units of both spans, every
// differing word flagging its row in `flag` (the tile's last word alone
// when the span's words are odd).
__device__ inline void compare_phase(const VerifyArgs& a, int64_t tile, uint8_t* flag, int tid) {
  const int64_t r0 = tile * D_ROWS;
  const int n = static_cast<int>(a.W - r0 < D_ROWS ? a.W - r0 : D_ROWS);
  const uint32_t words = static_cast<uint32_t>(n * a.width);
  const uint32_t units = words / 2;
  const longlong2* x = reinterpret_cast<const longlong2*>(a.rows + r0 * a.width);
  const longlong2* y = reinterpret_cast<const longlong2*>(a.expected + r0 * a.width);
  for (uint32_t u0 = tid; u0 < units; u0 += D_THREADS * D_UNROLL) {
    longlong2 p[D_UNROLL], q[D_UNROLL];
#pragma unroll
    for (int k = 0; k < D_UNROLL; ++k) {
      const uint32_t u = u0 + k * D_THREADS;
      if (u < units) {
        p[k] = __ldg(x + u);
        q[k] = __ldg(y + u);
      }
    }
#pragma unroll
    for (int k = 0; k < D_UNROLL; ++k) {
      const uint32_t u = u0 + k * D_THREADS;
      if (u < units) {
        if (p[k].x != q[k].x) flag[row_of(2 * u, a.reciprocal)] = 1;
        if (p[k].y != q[k].y) flag[row_of(2 * u + 1, a.reciprocal)] = 1;
      }
    }
  }
  if ((words & 1) && tid == D_THREADS - 1) {
    const int64_t i = r0 * a.width + words - 1;
    if (__ldg(a.rows + i) != __ldg(a.expected + i)) flag[n - 1] = 1;
  }
}

// Thread tid < the tile's rows writes its row's bit, the branch compare
// OR-ed in, and clears the flag for the next tile.
__device__ inline void out_phase(const VerifyArgs& a, int64_t tile, uint8_t* flag, int tid) {
  const int64_t row = tile * D_ROWS + tid;
  if (tid < D_ROWS && row < a.W) {
    a.out[row] = flag[tid] | (__ldg(a.branch + row) != __ldg(a.expected_branch + row));
    flag[tid] = 0;
  }
}

// A block's schedule over its tiles (block, block + grid, ...), the same
// on the card and in a host build: step(fn) runs fn(tid) for each of the
// block's D_THREADS threads, then meets them at a barrier.
template <class Step>
__device__ inline void verify_block(const VerifyArgs& a, uint8_t* flag, int64_t block,
                                    int64_t grid, Step step) {
  step([&](int tid) { clear_phase(flag, tid); });
  const int64_t tiles = (a.W + D_ROWS - 1) / D_ROWS;
  for (int64_t tile = block; tile < tiles; tile += grid) {
    step([&](int tid) { compare_phase(a, tile, flag, tid); });
    step([&](int tid) { out_phase(a, tile, flag, tid); });
  }
}

// The kernel and its launcher (nvcc only).

// A step of verify_block on the card: this thread's part, then the barrier.
struct BlockStep {
  template <class F>
  __device__ void operator()(F fn) const {
    fn(static_cast<int>(threadIdx.x));
    __syncthreads();
  }
};

__global__ void __launch_bounds__(D_THREADS) verify_kernel(VerifyArgs a) {
  __shared__ uint8_t flag[D_ROWS];
  verify_block(a, flag, blockIdx.x, gridDim.x, BlockStep{});
}

// One wave of verify_kernel on the current device, asked once a device.
cudaError_t d_max_blocks(int* out) {
  static int cache[64];  // 0: not asked yet
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return rc;
    if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, verify_kernel, D_THREADS,
                                                            0)) != cudaSuccess)
      return rc;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cache[dev];
  return cudaSuccess;
}

}  // namespace

// rows, expected: [W, width] int64, 16-byte aligned; branch,
// expected_branch: [W] int32; out: [W] bool.
extern "C" int cadence_verify_rows(const void* rows, const void* expected, const void* branch,
                                   const void* expected_branch, void* out, int64_t W, int width,
                                   void* stream) {
  if (W <= 0) return 0;
  if (width <= 0 || width >= D_MAX_WIDTH ||
      (reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(expected)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int max_blocks = 0;
  const cudaError_t rc = d_max_blocks(&max_blocks);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t tiles = (W + D_ROWS - 1) / D_ROWS;
  const unsigned blocks = static_cast<unsigned>(tiles < max_blocks ? tiles : max_blocks);
  verify_kernel<<<blocks, D_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      VerifyArgs{static_cast<const int64_t*>(rows), static_cast<const int64_t*>(expected),
                 static_cast<const int32_t*>(branch), static_cast<const int32_t*>(expected_branch),
                 static_cast<uint8_t*>(out), W, width, reciprocal_of(width)});
  return static_cast<int>(cudaGetLastError());
}
