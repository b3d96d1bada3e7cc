// Kernel D: verify_rows.
//
// Replaces the JAX package's ops/replay.py `verify_rows`: one mismatch bit
// per workflow, set when any column of its payload row differs from the
// expected row OR its device-chosen current branch differs from the
// expected branch.
//
// Design. One thread per workflow walks its two rows and stops at the
// first difference. Bound: bytes, 2 * 8 * width + 8 read and 1 written
// per workflow; one compare per 16 bytes read.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void verify_kernel(const int64_t* __restrict__ rows,
                              const int64_t* __restrict__ expected,
                              const int32_t* __restrict__ branch,
                              const int32_t* __restrict__ expected_branch,
                              uint8_t* __restrict__ out, int64_t W, int width) {
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= W) return;
  bool diff = branch[w] != expected_branch[w];
  const int64_t* a = rows + w * width;
  const int64_t* b = expected + w * width;
  for (int i = 0; i < width && !diff; ++i) diff = a[i] != b[i];
  out[w] = diff ? 1 : 0;
}

}  // namespace

extern "C" int cadence_verify_rows(const void* rows, const void* expected, const void* branch,
                                   const void* expected_branch, void* out, int64_t W, int width,
                                   void* stream) {
  if (W <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((W + threads - 1) / threads);
  verify_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), static_cast<const int64_t*>(expected),
      static_cast<const int32_t*>(branch), static_cast<const int32_t*>(expected_branch),
      static_cast<uint8_t*>(out), W, width);
  return static_cast<int>(cudaGetLastError());
}
