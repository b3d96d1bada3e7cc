// Kernel E: decode_wirec.
//
// Replaces the JAX package's ops/wirec.py `decode_wirec` (with `_read_le`):
// the full-tensor decode of a wirec slab [W, E, B] uint8, with its bases
// [W, K] int64 and n_events [W] int32, into the int64 lanes [W, E, 18].
// The replay path does not run it (kernel A decodes in its own event loop);
// it is the full-tensor decode, and the independent check that the fused
// reader decodes what was packed.
//
// Design. One thread per (workflow, lane) column, lanes fastest, so the 18
// threads of one workflow read the same slab row and write one 144-byte
// output row between them. A DELTA lane is a running sum along the event
// axis, so its thread owns the whole column and carries the sum in a
// register. The profile comes by value (wirec.cuh).
//
// Bound. Bytes: the slab, bases and n_events read once and the [W, E, 18]
// int64 lanes written once; the output dominates (144 B per event row
// against B <= 18 read). A handful of integer operations per value.
#include "wirec.cuh"

#include <cuda_runtime.h>

namespace cadence {
namespace {

constexpr int THREADS = 256;

__global__ void decode_wirec_kernel(const uint8_t* __restrict__ slab,
                                    const int64_t* __restrict__ bases,
                                    const int32_t* __restrict__ n_events,
                                    int64_t* __restrict__ out, int64_t W, int64_t E, int B,
                                    int K, const __grid_constant__ WirecProfile p) {
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= W * WIREC_LANES) return;
  const int64_t w = idx / WIREC_LANES;
  const int lane = static_cast<int>(idx % WIREC_LANES);
  const WirecLane l = p.lane[lane];
  const int64_t n = n_events[w];
  const int64_t base = l.base >= 0 ? bases[w * K + l.base] : 0;
  int64_t carry = base;
  const uint8_t* rows = slab + w * E * B;
  int64_t* o = out + w * E * WIREC_LANES + lane;
  const int64_t pad = wirec_pad_value(lane);
  for (int64_t e = 0; e < E; ++e) {
    int64_t v = l.cnst;
    if (l.kind != KIND_CONST)
      v = wirec_lane_value(l, wirec_read_le(rows + e * B, l.offset, l.width), carry, base);
    o[e * WIREC_LANES] = e < n ? v : pad;
  }
}

}  // namespace
}  // namespace cadence

extern "C" int cadence_decode_wirec(const void* slab, const void* bases, const void* n_events,
                                    void* out, int64_t W, int64_t E, int B, int K,
                                    const int64_t* profile, void* stream) {
  using namespace cadence;
  if (W <= 0 || E <= 0) return 0;
  const WirecProfile p = wirec_profile_from(profile);
  const int64_t threads = W * WIREC_LANES;
  const unsigned blocks = static_cast<unsigned>((threads + THREADS - 1) / THREADS);
  decode_wirec_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slab), static_cast<const int64_t*>(bases),
      static_cast<const int32_t*>(n_events), static_cast<int64_t*>(out), W, E, B, K, p);
  return static_cast<int>(cudaGetLastError());
}
