// Kernel A's TASKS variant on the staged route (replay_kernel.cuh with
// taskgen.cuh).
#include "replay_kernel.cuh"

// Kernel A with tasks: as cadence_replay, and the transfer and timer task
// logs, 12 device pointers in ops/taskgen.py TaskLog order ([W, Tt] / [W, Tm]
// int64 rows, [W] int64 counts, [W] bool overflow), appended to in place.
// `retention` is retention_days * 86400e9, which the caller checked fits.
extern "C" int cadence_replay_tasks(const void* ptr_table, const void* log_table,
                                    const void* events, int64_t W, int64_t E, int wire32,
                                    const int* caps, int b, int kv, int64_t tt, int64_t tm,
                                    int64_t retention, void* stream) {
  return launch_dense<true, false>(ptr_table, events, W, E, wire32, caps, b, kv,
                                   task_logs(log_table, tt, tm, retention), stream);
}
