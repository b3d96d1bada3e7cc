// Kernel I: gen_lanes.
//
// Replaces the JAX package's ops/genkernel.py `generate_lanes` (the
// `lax.scan` of `gen_step` from `init_gen_state`, swapped to [W, E, L]):
// it materialises the lanes the fused north-star path replays, for samples,
// the oracle's cross-checks and the materialize-then-replay contract.
//
// Design. One thread per workflow runs genkernel.cuh's step E times, its
// GenState in registers, and writes each event's 18 int64 lanes to its own
// [E, 18] row of the output. The generator reads nothing from memory.
//
// Bound. Bytes: the W * E * 144 bytes written (2.36 GB at 16,384 x 1,000,
// 0.70 ms at 3.35 TB/s). The operations are the generator's, about four
// 64-bit splitmix hashes (three 64-bit multiplies each, several 32-bit
// instructions apiece on this card) and a few 64-bit modulos by constants
// per event. Each thread writes its own row, E * 144 bytes from its
// neighbour's, so a warp's stores do not coalesce; this first version
// accepts that (a field-major or shared-memory-staged store is the fix).
#include <cuda_runtime.h>

#include "genkernel.cuh"

namespace {

constexpr int GEN_THREADS = 128;

__global__ void gen_lanes_kernel(int64_t seed, int64_t first_index, int64_t W, int64_t E,
                                 int64_t* __restrict__ out) {
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= W) return;
  using namespace cadence::gen;
  GenState g;
  init(g, seed, first_index + w);
  int64_t* row = out + w * E * GEN_LANES;
  for (int64_t e = 0; e < E; ++e) {
    int64_t lane[GEN_LANES];
    step(g, seed, first_index + w, e, E, lane);
#pragma unroll
    for (int i = 0; i < GEN_LANES; ++i) row[e * GEN_LANES + i] = lane[i];
  }
}

}  // namespace

// out: [W, E, 18] int64, written whole.
extern "C" int cadence_gen_lanes(int64_t seed, int64_t first_index, int64_t W, int64_t E,
                                 void* out, void* stream) {
  if (W <= 0 || E <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((W + GEN_THREADS - 1) / GEN_THREADS);
  gen_lanes_kernel<<<blocks, GEN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, first_index, W, E, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
