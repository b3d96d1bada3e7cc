// The ReplayState as the kernels see it: one device pointer per state
// tensor, in the field order of cadence_tpu_torch/ops/state.py
// (`leaves()`), at the JAX package's [W], [W, K] and [W, B, Kv] layouts.
// ops/replay.py asserts that its field list matches the indices below.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cadence {

enum Field : int {
  F_STATE = 0, F_CLOSE_STATUS, F_CANCEL_REQUESTED, F_LAST_FIRST_EVENT_ID,
  F_NEXT_EVENT_ID, F_LAST_PROCESSED_EVENT, F_SIGNAL_COUNT,
  F_DECISION_VERSION, F_DECISION_SCHEDULE_ID, F_DECISION_STARTED_ID,
  F_DECISION_ATTEMPT, F_DECISION_TIMEOUT, F_DECISION_SCHEDULED_TS,
  F_DECISION_STARTED_TS, F_DECISION_ORIGINAL_SCHEDULED_TS,
  F_WORKFLOW_TIMEOUT, F_DECISION_STS_TIMEOUT, F_START_TIMESTAMP,
  F_COMPLETION_EVENT_BATCH_ID, F_LAST_EVENT_TASK_ID, F_WORKFLOW_ATTEMPT,
  F_EXPIRATION_TIME, F_HAS_PARENT, F_CURRENT_VERSION,
  F_VH_EVENT_IDS, F_VH_VERSIONS, F_VH_COUNT, F_CURRENT_BRANCH,  // 24..27
  // activities (28..45)
  F_ACT_OCC, F_ACT_SCHEDULE_ID, F_ACT_STARTED_ID, F_ACT_VERSION,
  F_ACT_ACTIVITY_KEY, F_ACT_SCHEDULED_TIME, F_ACT_STARTED_TIME,
  F_ACT_LAST_HEARTBEAT, F_ACT_SCHED_TO_START, F_ACT_SCHED_TO_CLOSE,
  F_ACT_START_TO_CLOSE, F_ACT_HEARTBEAT, F_ACT_CANCEL_REQUESTED,
  F_ACT_CANCEL_REQUEST_ID, F_ACT_ATTEMPT, F_ACT_TIMER_STATUS,
  F_ACT_HAS_RETRY, F_ACT_BATCH_ID,
  // timers (46..51)
  F_TMR_OCC, F_TMR_TIMER_KEY, F_TMR_STARTED_ID, F_TMR_EXPIRY_TIME,
  F_TMR_TASK_STATUS, F_TMR_VERSION,
  // children (52..56)
  F_CH_OCC, F_CH_INITIATED_ID, F_CH_STARTED_ID, F_CH_VERSION, F_CH_BATCH_ID,
  // request-cancels (57..60)
  F_RC_OCC, F_RC_INITIATED_ID, F_RC_VERSION, F_RC_BATCH_ID,
  // signals (61..64)
  F_SG_OCC, F_SG_INITIATED_ID, F_SG_VERSION, F_SG_BATCH_ID,
  F_ERROR,  // 65
  NUM_FIELDS
};

struct StatePtrs {
  void* p[NUM_FIELDS];
};

// Capacities, read at run time from the state's shapes (layout_of), so a
// widened layout needs no new kernel.
struct Caps {
  int ka, kt, kc, kr, ks;  // activities, timers, children, cancels, signals
  int b, kv;               // branches, version-history items per branch
};

__device__ __forceinline__ int64_t* f64(const StatePtrs& s, int f) {
  return static_cast<int64_t*>(s.p[f]);
}
__device__ __forceinline__ int32_t* f32(const StatePtrs& s, int f) {
  return static_cast<int32_t*>(s.p[f]);
}
// torch.bool is one byte holding 0 or 1
__device__ __forceinline__ uint8_t* fb(const StatePtrs& s, int f) {
  return static_cast<uint8_t*>(s.p[f]);
}

constexpr int64_t PAD = int64_t(1) << 62;

// The branch and version-history part of the JAX package's ops/state.py
// `narrow_ok` rule, for one row of a state at b branches: the row fits
// out_b branches of out_kv items each when its current branch is below
// out_b, no branch at or past out_b holds an item and no branch holds more
// than out_kv. `count` is the row's [b] vh_count. Kernel H (rehome.cu)
// and kernel B's fit epilogue (payload.cu) both take it; the table part
// of the rule (no occupied slot at or past the narrow capacity) each reads
// from its own copy of the occupancy.
__device__ __forceinline__ bool branches_fit(int32_t current_branch,
                                             const int32_t* count, int b, int out_b,
                                             int out_kv) {
  bool ok = current_branch < out_b;
  for (int i = 0; i < b; ++i) {
    const int32_t c = count[i];
    if ((i >= out_b && c != 0) || c > out_kv) ok = false;
  }
  return ok;
}

// The most dynamic shared memory a block may have on sm_90 (227 KB).
constexpr int SMEM_LIMIT = 232448;

}  // namespace cadence
