// Kernel C: crc32.
//
// Replaces the JAX package's ops/crc.py `crc32_rows` (with `_make_tables`;
// `replay_to_crc` is kernels A, B and this one in turn): the IEEE CRC32
// of each [width] int64 row's little-endian bytes, equal to zlib.crc32.
//
// Design. One thread per row. The slice-by-8 table set (8 x 256 uint32,
// 8 KB) is built by each block into shared memory at the start; each
// int64 word is consumed as its lo/hi uint32 halves with 8 table lookups,
// as crc.py does, so the dependent chain is `width` steps long, not
// 8 * width. The result is written to an int64 tensor as the unsigned
// value (torch's uint32 has almost no ops).
//
// Bound. Bytes: 8 * width read and 8 written per row. The 8 shared-memory
// lookups per word are the operation count; the per-thread rows do not
// coalesce, which this first version accepts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t POLY = 0xEDB88320u;  // reflected IEEE polynomial
constexpr int THREADS = 256;

__global__ void crc32_kernel(const int64_t* __restrict__ rows, int64_t* __restrict__ out,
                             int64_t W, int width) {
  __shared__ uint32_t t[8][256];
  {
    uint32_t c = threadIdx.x;
    for (int i = 0; i < 8; ++i) c = (c >> 1) ^ ((c & 1u) ? POLY : 0u);
    t[0][threadIdx.x] = c;
  }
  __syncthreads();
  for (int k = 1; k < 8; ++k) {
    const uint32_t prev = t[k - 1][threadIdx.x];
    t[k][threadIdx.x] = (prev >> 8) ^ t[0][prev & 0xFFu];
    __syncthreads();
  }
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t* row = rows + w * width;
  uint32_t crc = 0xFFFFFFFFu;
  for (int i = 0; i < width; ++i) {
    const uint64_t word = static_cast<uint64_t>(row[i]);
    const uint32_t x = crc ^ static_cast<uint32_t>(word);
    const uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = t[7][x & 0xFFu] ^ t[6][(x >> 8) & 0xFFu] ^ t[5][(x >> 16) & 0xFFu] ^ t[4][x >> 24] ^
          t[3][hi & 0xFFu] ^ t[2][(hi >> 8) & 0xFFu] ^ t[1][(hi >> 16) & 0xFFu] ^ t[0][hi >> 24];
  }
  out[w] = static_cast<int64_t>(crc ^ 0xFFFFFFFFu);
}

}  // namespace

extern "C" int cadence_crc32(const void* rows, void* out, int64_t W, int width, void* stream) {
  if (W <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((W + THREADS - 1) / THREADS);
  crc32_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), static_cast<int64_t*>(out), W, width);
  return static_cast<int>(cudaGetLastError());
}
