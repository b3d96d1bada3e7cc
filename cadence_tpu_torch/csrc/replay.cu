// Kernel A's entry points on the staged route, without tasks: the int64 and
// wire32 readers and the wirec reader. The kernel, its design and its bound
// are replay_kernel.cuh's.
#include "replay_kernel.cuh"

// Kernel A on the staged route: every table capacity at most CHIP_MAX_K
// (ops/replay.py replay_route); any other layout returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int cadence_replay(const void* ptr_table, const void* events, int64_t W, int64_t E,
                              int wire32, const int* caps, int b, int kv, void* stream) {
  return launch_dense<false, false>(ptr_table, events, W, E, wire32, caps, b, kv,
                                    cadence::TaskLogPtrs{}, stream);
}

// Kernel A's wirec reader: slab [W, E, B] uint8, bases [W, K] int64,
// n_events [W] int32, and the profile as ops/wirec.py profile_table gives it.
extern "C" int cadence_replay_wirec(const void* ptr_table, const void* slab, const void* bases,
                                    const void* n_events, int64_t W, int64_t E, int B, int K,
                                    const int64_t* profile, const int* caps, int b, int kv,
                                    void* stream) {
  return launch_wirec<false>(ptr_table, slab, bases, n_events, W, E, B, K, profile, caps, b,
                             kv, stream);
}
