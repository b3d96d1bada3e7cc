// Kernel A's generator reader: replay_gen.
//
// Replaces the JAX package's ops/genkernel.py `_fused_scan` (with
// `generate_and_replay`, its CRC form and the sharded forms, which add
// kernels B and C): `gen_step` fused with ops/transitions.py `step`, so each
// workflow's events are generated and applied in the same loop and the
// corpus never exists. The stepping thread's semantics are replay_gen.cuh's.
//
// What a plain fused loop (kernel A's kernel with a generator in place of
// its event reader) runs into: one thread a workflow runs 1,000 dependent
// steps, and its chain holds the generator's four splitmix hashes and their
// modulos, which depend on no state, and loads from device memory: every
// table lookup scans all K occupancy bytes and keys, each load its own
// 32-byte sector (a row is K x 8 B from its neighbour's), and the version
// history is re-read every step. At bench.py's chunk of 16,384 that is
// under 4 warps an SM, so each instruction's latency is exposed.
//
// Design. A block holds GEN_WF workflows and GEN_WF * TPW threads. It walks
// the E steps in tiles of GEN_TILE. For each tile, every thread of the block
// first computes the draws of GEN_TILE x GEN_WF (workflow, step) pairs
// (gen::pack_dice: four hashes and seven modulos, packed in 56 bits) into
// shared memory, independent work with no chain; then the GEN_WF stepping
// threads (one a workflow: every TPW-th thread, so each warp holds 32 / TPW
// of them) each run the tile's steps, reading one word a step from shared
// memory and nothing from device memory (replay_gen.cuh). More threads a
// workflow give the hashes more threads and the stepping chains more warps
// to hide each other's latency, and cost issue slots (a warp steps 32 / TPW
// workflows). The launch takes 2 threads a workflow where that grid fits
// the card in one wave, which it reads from the occupancy calculator, and 1
// where it does not: on the H100, 2 at bench.py's chunk of 16,384 and 1 at
// 131,072, the faster of the two at each (chip_smoke.py kernel_replay_gen).
//
// Bound. Operations: the generator's four 64-bit splitmix hashes (a 64-bit
// multiply is four 32-bit instructions on this card) and its modulos, and
// the step; the state (3,602 B a workflow) is read and written once.
#include "replay_gen.cuh"

namespace cadence {
namespace {

constexpr int GEN_WF = 32;    // workflows (stepping threads) a block
constexpr int GEN_TILE = 16;  // steps whose draws are made ahead

template <int TPW>
__global__ void __launch_bounds__(GEN_WF * TPW)
    replay_gen_kernel(StatePtrs S, int64_t W, int64_t E, Caps c, int64_t seed,
                      int64_t first_index) {
  extern __shared__ uint64_t gen_smem[];
  uint64_t* dice = gen_smem;  // [GEN_TILE][GEN_WF]
  int64_t* keys = reinterpret_cast<int64_t*>(gen_smem + GEN_TILE * GEN_WF);  // [K][GEN_WF]
  const int t = threadIdx.x;
  const int wl = t / TPW;  // this thread's workflow in the block
  const int64_t w0 = int64_t(blockIdx.x) * GEN_WF;
  const bool stepper = t % TPW == 0 && w0 + wl < W;

  GenTables tables{S, w0 + wl, c, keys + wl, GEN_WF, 0, 0, 0};
  GenStepper st;
  if (stepper) st.load(S, c, tables, w0 + wl, seed, first_index + w0 + wl);

  for (int64_t e0 = 0; e0 < E; e0 += GEN_TILE) {
    const int n = E - e0 < GEN_TILE ? static_cast<int>(E - e0) : GEN_TILE;
#pragma unroll 2
    for (int j = t; j < GEN_TILE * GEN_WF; j += GEN_WF * TPW) {
      const int s = j / GEN_WF, x = j % GEN_WF;
      if (s < n && w0 + x < W) dice[j] = gen::pack_dice(seed, first_index + w0 + x, e0 + s);
    }
    __syncthreads();
    if (stepper) {
      for (int s = 0; s < n && st.r.error == 0; ++s)
        st.step(S, c, tables, e0 + s, E, dice[s * GEN_WF + wl]);
    }
    __syncthreads();
  }
  if (stepper) st.store(S, c, tables);
}

size_t gen_smem_bytes(const Caps& c) {
  return sizeof(uint64_t) * GEN_WF * (GEN_TILE + c.ka + c.kt + c.kc);
}

// Launch replay_gen_kernel<TPW>, unless `force` is false and its grid would
// not fit the card in one wave (then `launched` stays false).
template <int TPW>
cudaError_t launch_gen(const StatePtrs& S, int64_t W, int64_t E, const Caps& c, int64_t seed,
                       int64_t first_index, bool force, bool& launched, cudaStream_t st) {
  launched = false;
  const size_t smem = gen_smem_bytes(c);
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(replay_gen_kernel<TPW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int64_t blocks = (W + GEN_WF - 1) / GEN_WF;
  if (!force) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
    if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return rc;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, replay_gen_kernel<TPW>,
                                                       GEN_WF * TPW, smem);
    if (rc != cudaSuccess) return rc;
    if (blocks > int64_t(per_sm) * sms) return cudaSuccess;
  }
  replay_gen_kernel<TPW><<<static_cast<unsigned>(blocks), GEN_WF * TPW, smem, st>>>(
      S, W, E, c, seed, first_index);
  launched = true;
  return cudaGetLastError();
}

}  // namespace
}  // namespace cadence

// Kernel A's generator reader: generate and replay E events for each of the
// W workflows first_index .. first_index + W - 1 of `seed`, in place on the
// state (ops/genkernel.py generate_and_replay's loop). The activity, timer
// and child capacities must be at most 64. `tpw`: threads a workflow (1 or
// 2), or 0 to take 2 where that grid fits the card in one wave, else 1.
extern "C" int cadence_replay_gen(const void* ptr_table, int64_t seed, int64_t first_index,
                                  int64_t W, int64_t E, const int* caps, int b, int kv,
                                  int tpw, void* stream) {
  using namespace cadence;
  StatePtrs S;
  const uint64_t* table = static_cast<const uint64_t*>(ptr_table);
  for (int i = 0; i < NUM_FIELDS; ++i) S.p[i] = reinterpret_cast<void*>(table[i]);
  const Caps c{caps[0], caps[1], caps[2], caps[3], caps[4], b, kv};
  if (c.ka > GEN_MAX_K || c.kt > GEN_MAX_K || c.kc > GEN_MAX_K || tpw < 0 || tpw > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool launched = false;
  cudaError_t rc = cudaSuccess;
  if (tpw != 1) rc = launch_gen<2>(S, W, E, c, seed, first_index, tpw == 2, launched, st);
  if (rc == cudaSuccess && !launched)
    rc = launch_gen<1>(S, W, E, c, seed, first_index, true, launched, st);
  return static_cast<int>(rc);
}
