// Kernel I: gen_lanes.
//
// Replaces the JAX package's ops/genkernel.py `generate_lanes` (the
// `lax.scan` of `gen_step` from `init_gen_state`, swapped to [W, E, L]):
// it materialises the lanes the fused north-star path replays, for samples,
// the oracle's cross-checks and the materialize-then-replay contract.
//
// Bound. Bytes: the W * E * 144 bytes written (2.36 GB at 16,384 x 1,000,
// 0.70 ms at 3.35 TB/s). The operations are the generator's, about four
// 64-bit splitmix hashes (three 64-bit multiplies each, several 32-bit
// instructions apiece on this card) and a few 64-bit modulos by constants
// per event.
//
// What a plain loop (one thread a workflow, each writing its own [E, 18]
// row) runs into: each thread's chain holds the four hashes and their
// modulos, which depend on no state, and its 18 stores a step land E * 144
// bytes from its neighbour's, so a warp's stores never coalesce (32
// sectors a store, 18 stores a step). At the north star's parity leg, 32
// workflows, one warp carries the whole launch on one SM.
//
// Design. A block holds LANES_WF = 32 workflows: warp 0 steps them, one
// thread a workflow, and the block's other three warps do the rest. The
// block walks the E steps in tiles of LANES_TILE. While the stepping warp
// runs tile k, reading each step's draws as one packed word from shared
// memory (genkernel.cuh pack_dice / PackedDice) and writing each event's 18
// lanes as nine 16-byte stores into a shared tile [workflow][LANES_TILE
// events][18], the other warps make tile k + 1's draws and write tile k -
// 1's lanes out: each workflow's span of the tile is LANES_TILE * 144
// contiguous bytes of the output, stored in 16-byte units by neighbouring
// threads, so a warp's stores coalesce. The tiles and the draws are
// double-buffered, one barrier a tile. A workflow's row in the tile is
// padded by 16 bytes (ROW_WORDS), which keeps the stepping warp's 16-byte
// stores free of bank conflicts. The stepping thread's chain is
// genkernel.cuh `choose` and `act_all`, which computes every action's
// update under its predicate: a warp whose workflows took different
// actions runs one instruction stream instead of each action's branch in
// turn (a switch on the action was 1.5x slower at 32 workflows and 1.3x at
// 16,384: chip_smoke.py --variants, switch_step).
//
// Shared memory: 2 * 32 * (LANES_TILE * 18 + 2) * 8 bytes of lanes and
// 2 * LANES_TILE * 32 * 8 of draws, 39,936 bytes at LANES_TILE = 4: five
// blocks an SM, so bench.py's chunk of 16,384 workflows (512 blocks) runs
// in one wave, four stepping warps an SM. With 128 threads each stepping
// warp has its SM sub-partition's issue slots to itself. Tiles of 8 and 16
// steps (two blocks an SM and one) and 256 threads were slower on the H100
// (chip_smoke.py --variants, PERF.md).
#include <cuda_runtime.h>

#include "genkernel.cuh"

namespace {

using namespace cadence::gen;

constexpr int LANES_WF = 32;        // workflows a block: its stepping warp
constexpr int LANES_TILE = 4;       // steps a tile
constexpr int LANES_THREADS = 128;  // the stepping warp and three that draw and store
// int64 words of one workflow's row in a tile: its lanes, then 16 bytes of
// padding
constexpr int ROW_WORDS = LANES_TILE * GEN_LANES + 2;
constexpr int TILE_WORDS = LANES_WF * ROW_WORDS;  // one lanes buffer
constexpr int DICE_WORDS = LANES_TILE * LANES_WF;  // one draws buffer, [step][workflow]
constexpr size_t LANES_SMEM = sizeof(int64_t) * 2 * (TILE_WORDS + DICE_WORDS);

// One stepping thread's generator.
struct Stepper {
  GenState g;
  int64_t started;  // 600 + die(r2, 6600) of step 0
};

// The draws of steps e0 .. e0 + LANES_TILE - 1 (those below E) of the
// block's nw workflows from global index wf0, word [s * LANES_WF + x], made
// by threads tid, tid + nthreads, ...
__device__ __forceinline__ void draw_tile(uint64_t* dice, int64_t seed, int64_t wf0, int nw,
                                          int64_t e0, int64_t E, int tid, int nthreads) {
  for (int j = tid; j < DICE_WORDS; j += nthreads) {
    const int s = j / LANES_WF, x = j % LANES_WF;
    if (x < nw && e0 + s < E) dice[j] = pack_dice(seed, wf0 + x, e0 + s);
  }
}

// Stepping thread x's steps e0 .. of one tile: each event's 18 lanes into
// its row of the tile, nine 16-byte stores.
__device__ __forceinline__ void step_tile(Stepper& st, const uint64_t* dice, int64_t* tile, int x,
                                          int64_t e0, int64_t E) {
  const int n = E - e0 < LANES_TILE ? static_cast<int>(E - e0) : LANES_TILE;
  int64_t* row = tile + x * ROW_WORDS;
  uint64_t word = dice[x];
  for (int s = 0; s < n; ++s) {
    const PackedDice d{word, st.started};
    if (s + 1 < n) word = dice[(s + 1) * LANES_WF + x];  // the next draw, off the chain
    int64_t lane[GEN_LANES];
    step_with(st.g, d, e0 + s, E, lane);
#pragma unroll
    for (int i = 0; i < GEN_LANES; i += 2)
      *reinterpret_cast<longlong2*>(row + s * GEN_LANES + i) = make_longlong2(lane[i], lane[i + 1]);
  }
}

// One tile's lanes (steps e0 .. below E) of the block's nw workflows, rows
// w0 .. of out, written by threads tid, tid + nthreads, ...: each
// workflow's span n * 144 contiguous bytes, in 16-byte units.
__device__ __forceinline__ void store_tile(int64_t* __restrict__ out, const int64_t* tile,
                                           int64_t w0, int nw, int64_t e0, int64_t E, int tid,
                                           int nthreads) {
  const int n = E - e0 < LANES_TILE ? static_cast<int>(E - e0) : LANES_TILE;
  const int span = n * GEN_LANES / 2;  // 16-byte units a workflow
  for (int j = tid; j < nw * span; j += nthreads) {
    const int x = j / span, u = j - x * span;
    const longlong2 v = *reinterpret_cast<const longlong2*>(tile + x * ROW_WORDS + 2 * u);
    __stcs(reinterpret_cast<longlong2*>(out + ((w0 + x) * E + e0) * GEN_LANES) + u, v);
  }
}

// Thread t's share of phase k of a block: phase -1 draws tile 0 (every
// thread) and starts the generators; phase k in [0, tiles) steps tile k
// (warp 0) while the other warps draw tile k + 1 and store tile k - 1;
// phase `tiles` stores the last tile (every thread). The block runs the
// phases in order with a barrier after each.
__device__ __forceinline__ void lanes_phase(int64_t k, int64_t tiles, int t, Stepper& st,
                                            int64_t seed, int64_t first_index, int64_t w0, int nw,
                                            int64_t E, int64_t* lanes, uint64_t* dice,
                                            int64_t* __restrict__ out) {
  const int64_t wf0 = first_index + w0;
  if (k < 0) {
    if (t < nw) {
      init(st.g, seed, wf0 + t);
      st.started = 600 + die(mix(seed, wf0 + t, 0, 3), 6600);
    }
    draw_tile(dice, seed, wf0, nw, 0, E, t, LANES_THREADS);
  } else if (k == tiles) {
    store_tile(out, lanes + (k - 1) % 2 * TILE_WORDS, w0, nw, (k - 1) * LANES_TILE, E, t,
               LANES_THREADS);
  } else if (t < LANES_WF) {
    if (t < nw)
      step_tile(st, dice + k % 2 * DICE_WORDS, lanes + k % 2 * TILE_WORDS, t, k * LANES_TILE, E);
  } else {
    const int h = t - LANES_WF, nh = LANES_THREADS - LANES_WF;
    if (k + 1 < tiles)
      draw_tile(dice + (k + 1) % 2 * DICE_WORDS, seed, wf0, nw, (k + 1) * LANES_TILE, E, h, nh);
    if (k >= 1)
      store_tile(out, lanes + (k - 1) % 2 * TILE_WORDS, w0, nw, (k - 1) * LANES_TILE, E, h, nh);
  }
}

__global__ void __launch_bounds__(LANES_THREADS)
    gen_lanes_kernel(int64_t seed, int64_t first_index, int64_t W, int64_t E,
                     int64_t* __restrict__ out) {
  extern __shared__ __align__(16) int64_t lanes_smem[];
  uint64_t* dice = reinterpret_cast<uint64_t*>(lanes_smem + 2 * TILE_WORDS);
  const int64_t w0 = int64_t(blockIdx.x) * LANES_WF;
  const int nw = W - w0 < LANES_WF ? static_cast<int>(W - w0) : LANES_WF;
  const int64_t tiles = (E + LANES_TILE - 1) / LANES_TILE;
  Stepper st;
  for (int64_t k = -1; k <= tiles; ++k) {
    lanes_phase(k, tiles, threadIdx.x, st, seed, first_index, w0, nw, E, lanes_smem, dice, out);
    if (k < tiles) __syncthreads();
  }
}

}  // namespace

// out: [W, E, 18] int64, written whole.
extern "C" int cadence_gen_lanes(int64_t seed, int64_t first_index, int64_t W, int64_t E,
                                 void* out, void* stream) {
  if (W <= 0 || E <= 0) return 0;
  cudaError_t rc = cudaFuncSetAttribute(gen_lanes_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(LANES_SMEM));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>((W + LANES_WF - 1) / LANES_WF);
  gen_lanes_kernel<<<blocks, LANES_THREADS, LANES_SMEM, static_cast<cudaStream_t>(stream)>>>(
      seed, first_index, W, E, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
