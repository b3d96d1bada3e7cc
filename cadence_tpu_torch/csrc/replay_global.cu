// Kernel A on the global route, for any layout: the tables and version
// histories in device memory (replay_kernel.cuh).
#include "replay_kernel.cuh"

// The same three on the global route, for any layout, with the same
// arguments.
extern "C" int cadence_replay_global(const void* ptr_table, const void* events, int64_t W,
                                     int64_t E, int wire32, const int* caps, int b, int kv,
                                     void* stream) {
  return launch_dense<false, true>(ptr_table, events, W, E, wire32, caps, b, kv,
                                   cadence::TaskLogPtrs{}, stream);
}

extern "C" int cadence_replay_tasks_global(const void* ptr_table, const void* log_table,
                                           const void* events, int64_t W, int64_t E,
                                           int wire32, const int* caps, int b, int kv,
                                           int64_t tt, int64_t tm, int64_t retention,
                                           void* stream) {
  return launch_dense<true, true>(ptr_table, events, W, E, wire32, caps, b, kv,
                                  task_logs(log_table, tt, tm, retention), stream);
}

extern "C" int cadence_replay_wirec_global(const void* ptr_table, const void* slab,
                                           const void* bases, const void* n_events, int64_t W,
                                           int64_t E, int B, int K, const int64_t* profile,
                                           const int* caps, int b, int kv, void* stream) {
  return launch_wirec<true>(ptr_table, slab, bases, n_events, W, E, B, K, profile, caps, b,
                            kv, stream);
}
