// Kernel F: stats.
//
// Replaces the reduction inside the JAX package's parallel/mesh.py
// `_replay_with_stats`, `_replay_crc_with_stats` and
// `_replay_wirec_crc_with_stats`: stack([(error != 0).sum(),
// (close_status != 0).sum()]) over one shard's [W] int32 tensors, as an
// int64 [2]. XLA's psum across the mesh becomes a sum on the host of each
// shard's [2] (16 bytes read back per shard).
//
// Design. One pass: each thread counts its rows (a grid-stride loop),
// the two counts are summed within each warp by shuffles, then across the
// block's warps in shared memory, and thread 0 adds the block's totals
// with one atomicAdd each into the output, which the entry point zeroes
// first on the same stream. Kept apart from kernel A, whose register
// budget an epilogue would touch.
//
// Bound. Bytes: 8 read per workflow and 16 written; one compare and one
// add per value. At the main path's widths the launch itself dominates.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;

__global__ void stats_kernel(const int32_t* __restrict__ error,
                             const int32_t* __restrict__ close_status,
                             unsigned long long* __restrict__ out, int64_t W) {
  unsigned long long errors = 0, closed = 0;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < W; w += stride) {
    errors += error[w] != 0;
    closed += close_status[w] != 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    errors += __shfl_down_sync(0xffffffffu, errors, off);
    closed += __shfl_down_sync(0xffffffffu, closed, off);
  }
  __shared__ unsigned long long warp_sums[2][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sums[0][warp] = errors;
    warp_sums[1][warp] = closed;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long e = 0, c = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      e += warp_sums[0][i];
      c += warp_sums[1][i];
    }
    atomicAdd(out, e);
    atomicAdd(out + 1, c);
  }
}

}  // namespace

extern "C" int cadence_stats(const void* error, const void* close_status, void* out, int64_t W,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(out, 0, 2 * sizeof(int64_t), s);
  if (rc != cudaSuccess || W <= 0) return static_cast<int>(rc);
  int64_t blocks = (W + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  stats_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const int32_t*>(error), static_cast<const int32_t*>(close_status),
      static_cast<unsigned long long*>(out), W);
  return static_cast<int>(cudaGetLastError());
}
