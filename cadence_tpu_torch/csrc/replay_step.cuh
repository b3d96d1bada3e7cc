// One event's effect on one workflow's state: the semantics every
// instance of kernel A shares (replay_kernel.cuh's int64, wire32, wirec and TASKS
// readers, and the generator reader in replay_gen.cu).
//
// The scalars are held in registers (struct Scalars). The pending tables
// are reached through a storage policy `T`: GlobalTables below reads and
// writes them at the JAX [W, K] layout in device memory (kernel A's global
// route); replay_tables.cuh's ChipTables (its staged route) and
// replay_gen.cuh's GenTables keep their occupancy in registers and the
// lookup keys in shared memory, and write the same fields through.
// apply_event is the per-type switch of ops/transitions.py `step` after the
// version-history update; each case calls one of the effect functions
// below, which the generator reader also calls directly.
#pragma once

#include "state.cuh"

namespace cadence {
namespace {

constexpr int64_t FIRST_EVENT_ID = 1;
constexpr int64_t EMPTY_EVENT_ID = -23;
constexpr int64_t EMPTY_VERSION = -24;
constexpr int64_t NANOS_PER_SECOND = 1000000000LL;

// WorkflowState / CloseStatus / TimeoutType (core/enums.py)
constexpr int32_t WS_CREATED = 0, WS_RUNNING = 1, WS_COMPLETED = 2,
                  WS_ZOMBIE = 3, WS_VOID = 4;
constexpr int32_t CS_NONE = 0, CS_COMPLETED = 1, CS_FAILED = 2,
                  CS_CANCELED = 3, CS_TERMINATED = 4, CS_CONTINUED_AS_NEW = 5,
                  CS_TIMED_OUT = 6;
constexpr int64_t TIMEOUT_SCHEDULE_TO_START = 1;

// ErrorCode (ops/state.py)
constexpr int32_t E_INVALID_STATE_TRANSITION = 1, E_VERSION_HISTORY_ORDER = 2,
                  E_VERSION_HISTORY_OVERFLOW = 3, E_MISSING_DECISION = 4,
                  E_MISSING_ACTIVITY = 5, E_MISSING_TIMER = 6,
                  E_MISSING_CHILD = 7, E_MISSING_REQUEST_CANCEL = 8,
                  E_MISSING_SIGNAL = 9, E_TABLE_OVERFLOW = 10,
                  E_UNKNOWN_EVENT_TYPE = 11, E_INVALID_BACKOFF_INITIATOR = 12,
                  E_BRANCH_OVERFLOW = 13, E_BAD_FORK = 14;

// EventType (core/enums.py)
enum : int64_t {
  ET_WF_STARTED = 0, ET_WF_COMPLETED = 1, ET_WF_FAILED = 2, ET_WF_TIMED_OUT = 3,
  ET_DT_SCHEDULED = 4, ET_DT_STARTED = 5, ET_DT_COMPLETED = 6,
  ET_DT_TIMED_OUT = 7, ET_DT_FAILED = 8,
  ET_AT_SCHEDULED = 9, ET_AT_STARTED = 10, ET_AT_COMPLETED = 11,
  ET_AT_FAILED = 12, ET_AT_TIMED_OUT = 13, ET_AT_CANCEL_REQUESTED = 14,
  ET_AT_CANCELED = 16,
  ET_TIMER_STARTED = 17, ET_TIMER_FIRED = 18, ET_TIMER_CANCELED = 20,
  ET_WF_CANCEL_REQUESTED = 21, ET_WF_CANCELED = 22,
  ET_RC_INITIATED = 23, ET_RC_FAILED = 24, ET_EXT_CANCEL_REQUESTED = 25,
  ET_WF_SIGNALED = 27, ET_WF_TERMINATED = 28, ET_WF_CONTINUED_AS_NEW = 29,
  ET_CHILD_INITIATED = 30, ET_CHILD_START_FAILED = 31, ET_CHILD_STARTED = 32,
  ET_CHILD_COMPLETED = 33, ET_CHILD_FAILED = 34, ET_CHILD_CANCELED = 35,
  ET_CHILD_TIMED_OUT = 36, ET_CHILD_TERMINATED = 37,
  ET_SG_INITIATED = 38, ET_SG_FAILED = 39, ET_EXT_SIGNALED = 40,
  ET_UPSERT_SEARCH_ATTRIBUTES = 41, ET_LAST = 41,
};

__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wrap_mul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}

// workflowExecutionInfo.go state/close-status transition guard
__device__ __forceinline__ bool transition_valid(int32_t cur_state, int32_t cur_close,
                                                 int32_t new_state, int32_t new_close) {
  const bool crz_ok = new_close == CS_NONE;
  switch (cur_state) {
    case WS_VOID:
      return true;
    case WS_CREATED:
      if (new_state == WS_CREATED || new_state == WS_RUNNING || new_state == WS_ZOMBIE)
        return crz_ok;
      return new_state == WS_COMPLETED &&
             (new_close == CS_TERMINATED || new_close == CS_TIMED_OUT ||
              new_close == CS_CONTINUED_AS_NEW);
    case WS_RUNNING:
      if (new_state == WS_CREATED) return false;
      if (new_state == WS_RUNNING || new_state == WS_ZOMBIE) return crz_ok;
      return new_state == WS_COMPLETED && new_close != CS_NONE;
    case WS_COMPLETED:
      return new_state == WS_COMPLETED && new_close == cur_close;
    case WS_ZOMBIE:
      if (new_state == WS_CREATED || new_state == WS_RUNNING) return new_close == CS_NONE;
      return (new_state == WS_COMPLETED || new_state == WS_ZOMBIE) && new_close != CS_NONE;
    default:
      return false;
  }
}

// First free slot of a [K] occupancy row, or -1 when the table is full.
__device__ __forceinline__ int first_free(const uint8_t* occ, int k) {
  for (int i = 0; i < k; ++i)
    if (!occ[i]) return i;
  return -1;
}

// The scalar part of one workflow's state, held in registers.
struct Scalars {
  int32_t state, close_status;
  bool cancel_requested, has_parent;
  int64_t last_first_event_id, next_event_id, last_processed_event, signal_count;
  int64_t d_version, d_sched, d_started, d_attempt, d_timeout, d_sched_ts,
      d_started_ts, d_orig_ts;
  int64_t workflow_timeout, decision_sts_timeout, start_timestamp,
      completion_event_batch_id, last_event_task_id, workflow_attempt,
      expiration_time, current_version;
  int32_t current_branch, error;
};

__device__ void load_scalars(const StatePtrs& S, int64_t w, Scalars& r) {
  r.state = f32(S, F_STATE)[w];
  r.close_status = f32(S, F_CLOSE_STATUS)[w];
  r.cancel_requested = fb(S, F_CANCEL_REQUESTED)[w] != 0;
  r.last_first_event_id = f64(S, F_LAST_FIRST_EVENT_ID)[w];
  r.next_event_id = f64(S, F_NEXT_EVENT_ID)[w];
  r.last_processed_event = f64(S, F_LAST_PROCESSED_EVENT)[w];
  r.signal_count = f64(S, F_SIGNAL_COUNT)[w];
  r.d_version = f64(S, F_DECISION_VERSION)[w];
  r.d_sched = f64(S, F_DECISION_SCHEDULE_ID)[w];
  r.d_started = f64(S, F_DECISION_STARTED_ID)[w];
  r.d_attempt = f64(S, F_DECISION_ATTEMPT)[w];
  r.d_timeout = f64(S, F_DECISION_TIMEOUT)[w];
  r.d_sched_ts = f64(S, F_DECISION_SCHEDULED_TS)[w];
  r.d_started_ts = f64(S, F_DECISION_STARTED_TS)[w];
  r.d_orig_ts = f64(S, F_DECISION_ORIGINAL_SCHEDULED_TS)[w];
  r.workflow_timeout = f64(S, F_WORKFLOW_TIMEOUT)[w];
  r.decision_sts_timeout = f64(S, F_DECISION_STS_TIMEOUT)[w];
  r.start_timestamp = f64(S, F_START_TIMESTAMP)[w];
  r.completion_event_batch_id = f64(S, F_COMPLETION_EVENT_BATCH_ID)[w];
  r.last_event_task_id = f64(S, F_LAST_EVENT_TASK_ID)[w];
  r.workflow_attempt = f64(S, F_WORKFLOW_ATTEMPT)[w];
  r.expiration_time = f64(S, F_EXPIRATION_TIME)[w];
  r.has_parent = fb(S, F_HAS_PARENT)[w] != 0;
  r.current_version = f64(S, F_CURRENT_VERSION)[w];
  r.current_branch = f32(S, F_CURRENT_BRANCH)[w];
  r.error = f32(S, F_ERROR)[w];
}

__device__ void store_scalars(const StatePtrs& S, int64_t w, const Scalars& r) {
  f32(S, F_STATE)[w] = r.state;
  f32(S, F_CLOSE_STATUS)[w] = r.close_status;
  fb(S, F_CANCEL_REQUESTED)[w] = r.cancel_requested ? 1 : 0;
  f64(S, F_LAST_FIRST_EVENT_ID)[w] = r.last_first_event_id;
  f64(S, F_NEXT_EVENT_ID)[w] = r.next_event_id;
  f64(S, F_LAST_PROCESSED_EVENT)[w] = r.last_processed_event;
  f64(S, F_SIGNAL_COUNT)[w] = r.signal_count;
  f64(S, F_DECISION_VERSION)[w] = r.d_version;
  f64(S, F_DECISION_SCHEDULE_ID)[w] = r.d_sched;
  f64(S, F_DECISION_STARTED_ID)[w] = r.d_started;
  f64(S, F_DECISION_ATTEMPT)[w] = r.d_attempt;
  f64(S, F_DECISION_TIMEOUT)[w] = r.d_timeout;
  f64(S, F_DECISION_SCHEDULED_TS)[w] = r.d_sched_ts;
  f64(S, F_DECISION_STARTED_TS)[w] = r.d_started_ts;
  f64(S, F_DECISION_ORIGINAL_SCHEDULED_TS)[w] = r.d_orig_ts;
  f64(S, F_WORKFLOW_TIMEOUT)[w] = r.workflow_timeout;
  f64(S, F_DECISION_STS_TIMEOUT)[w] = r.decision_sts_timeout;
  f64(S, F_START_TIMESTAMP)[w] = r.start_timestamp;
  f64(S, F_COMPLETION_EVENT_BATCH_ID)[w] = r.completion_event_batch_id;
  f64(S, F_LAST_EVENT_TASK_ID)[w] = r.last_event_task_id;
  f64(S, F_WORKFLOW_ATTEMPT)[w] = r.workflow_attempt;
  f64(S, F_EXPIRATION_TIME)[w] = r.expiration_time;
  fb(S, F_HAS_PARENT)[w] = r.has_parent ? 1 : 0;
  f64(S, F_CURRENT_VERSION)[w] = r.current_version;
  f32(S, F_CURRENT_BRANCH)[w] = r.current_branch;
  f32(S, F_ERROR)[w] = r.error;
}

// Insert into one of the two initiated-ID tables (request-cancels, signals).
__device__ __forceinline__ void insert_initiated(const StatePtrs& S, int64_t w, int k,
                                                 int f_occ, int64_t ev_id,
                                                 int64_t ev_version, int64_t batch_first,
                                                 int32_t& error) {
  uint8_t* occ = fb(S, f_occ) + w * k;
  const int slot = first_free(occ, k);
  if (slot < 0) {
    if (error == 0) error = E_TABLE_OVERFLOW;
    return;
  }
  occ[slot] = 1;
  f64(S, f_occ + 1)[w * k + slot] = ev_id;        // initiated_id
  f64(S, f_occ + 2)[w * k + slot] = ev_version;   // version
  f64(S, f_occ + 3)[w * k + slot] = batch_first;  // batch_id
}

// Delete every occupied slot whose key equals `key`; returns whether any did.
__device__ __forceinline__ bool delete_matches(uint8_t* occ, const int64_t* keys, int k,
                                               int64_t key) {
  bool found = false;
  for (int i = 0; i < k; ++i) {
    if (occ[i] && keys[i] == key) {
      occ[i] = 0;
      found = true;
    }
  }
  return found;
}

// ---------------------------------------------------------------------------
// The effect of one applied event, by type. `a` points at the event's eight
// attribute lanes. Each function sets r.error as ops/transitions.py does and
// changes nothing else when it raises.

__device__ __forceinline__ void on_workflow_started(Scalars& r, int64_t ev_id, int64_t ts,
                                                    const int64_t* a) {
  if (!transition_valid(r.state, r.close_status, WS_CREATED, CS_NONE)) {
    r.error = E_INVALID_STATE_TRANSITION;
    return;
  }
  if (a[2] > 0 && (a[7] == 0 || a[7] >= 3)) {
    r.error = E_INVALID_BACKOFF_INITIATOR;
    return;
  }
  r.workflow_timeout = a[0];
  r.decision_sts_timeout = a[1];
  r.start_timestamp = ts;
  r.workflow_attempt = a[3];
  if (a[4] != 0) r.expiration_time = a[4];
  r.has_parent = a[5] != 0;
  r.state = WS_CREATED;
  r.close_status = CS_NONE;
  r.last_processed_event = EMPTY_EVENT_ID;
  r.last_first_event_id = ev_id;
  r.d_version = EMPTY_VERSION;
  r.d_sched = EMPTY_EVENT_ID;
  r.d_started = EMPTY_EVENT_ID;
  r.d_timeout = 0;
}

__device__ __forceinline__ void on_decision_scheduled(Scalars& r, int64_t ev_id,
                                                      int64_t ev_version, int64_t ts,
                                                      const int64_t* a) {
  const bool trans = r.state != WS_ZOMBIE;
  if (trans && !transition_valid(r.state, r.close_status, WS_RUNNING, CS_NONE)) {
    r.error = E_INVALID_STATE_TRANSITION;
    return;
  }
  if (trans) {
    r.state = WS_RUNNING;
    r.close_status = CS_NONE;
  }
  r.d_version = ev_version;
  r.d_sched = ev_id;
  r.d_started = EMPTY_EVENT_ID;
  r.d_attempt = a[1];
  r.d_timeout = a[0];
  r.d_sched_ts = ts;
  r.d_started_ts = 0;
  r.d_orig_ts = ts;
}

__device__ __forceinline__ void on_decision_started(Scalars& r, int64_t ev_id,
                                                    int64_t ev_version, int64_t ts,
                                                    const int64_t* a) {
  if (r.d_sched != a[0]) {
    r.error = E_MISSING_DECISION;
    return;
  }
  r.d_version = ev_version;
  r.d_started = ev_id;
  r.d_attempt = 0;
  r.d_started_ts = ts;
}

__device__ __forceinline__ void on_decision_completed(Scalars& r, const int64_t* a) {
  r.d_version = EMPTY_VERSION;
  r.d_sched = EMPTY_EVENT_ID;
  r.d_started = EMPTY_EVENT_ID;
  r.d_attempt = 0;
  r.d_timeout = 0;
  r.d_sched_ts = 0;
  r.d_started_ts = 0;
  r.last_processed_event = a[1];
}

__device__ __forceinline__ void on_signaled(Scalars& r) {
  r.signal_count = wrap_add(r.signal_count, 1);
}

// WorkflowExecution{Completed,Failed,TimedOut,Canceled,Terminated,ContinuedAsNew}
__device__ __forceinline__ void on_workflow_closed(Scalars& r, int32_t cs, int64_t batch_first) {
  if (!transition_valid(r.state, r.close_status, WS_COMPLETED, cs)) {
    r.error = E_INVALID_STATE_TRANSITION;
    return;
  }
  r.state = WS_COMPLETED;
  r.close_status = cs;
  r.completion_event_batch_id = batch_first;
}

// The fields an insert writes, beside the occupancy bit, at flat index i
// (w * K + slot).
__device__ __forceinline__ void write_activity(const StatePtrs& S, int64_t i, int64_t ev_id,
                                               int64_t ev_version, int64_t ts,
                                               int64_t batch_first, const int64_t* a) {
  f64(S, F_ACT_SCHEDULE_ID)[i] = ev_id;
  f64(S, F_ACT_STARTED_ID)[i] = EMPTY_EVENT_ID;
  f64(S, F_ACT_VERSION)[i] = ev_version;
  f64(S, F_ACT_ACTIVITY_KEY)[i] = a[0];
  f64(S, F_ACT_SCHEDULED_TIME)[i] = ts;
  f64(S, F_ACT_STARTED_TIME)[i] = 0;
  f64(S, F_ACT_LAST_HEARTBEAT)[i] = 0;
  f64(S, F_ACT_SCHED_TO_START)[i] = a[1];
  f64(S, F_ACT_SCHED_TO_CLOSE)[i] = a[2];
  f64(S, F_ACT_START_TO_CLOSE)[i] = a[3];
  f64(S, F_ACT_HEARTBEAT)[i] = a[4];
  fb(S, F_ACT_CANCEL_REQUESTED)[i] = 0;
  f64(S, F_ACT_CANCEL_REQUEST_ID)[i] = EMPTY_EVENT_ID;
  f64(S, F_ACT_ATTEMPT)[i] = 0;
  f32(S, F_ACT_TIMER_STATUS)[i] = 0;
  fb(S, F_ACT_HAS_RETRY)[i] = a[5] != 0 ? 1 : 0;
  f64(S, F_ACT_BATCH_ID)[i] = batch_first;
}

__device__ __forceinline__ void write_activity_started(const StatePtrs& S, int64_t i,
                                                       int64_t ev_id, int64_t ev_version,
                                                       int64_t ts) {
  f64(S, F_ACT_VERSION)[i] = ev_version;
  f64(S, F_ACT_STARTED_ID)[i] = ev_id;
  f64(S, F_ACT_STARTED_TIME)[i] = ts;
  f64(S, F_ACT_LAST_HEARTBEAT)[i] = ts;
}

__device__ __forceinline__ void write_activity_cancel_requested(const StatePtrs& S, int64_t i,
                                                                int64_t ev_id,
                                                                int64_t ev_version) {
  f64(S, F_ACT_VERSION)[i] = ev_version;
  fb(S, F_ACT_CANCEL_REQUESTED)[i] = 1;
  f64(S, F_ACT_CANCEL_REQUEST_ID)[i] = ev_id;
}

__device__ __forceinline__ void write_timer(const StatePtrs& S, int64_t i, int64_t key,
                                            int64_t ev_id, int64_t ev_version, int64_t ts,
                                            int64_t timeout_s) {
  f64(S, F_TMR_TIMER_KEY)[i] = key;
  f64(S, F_TMR_STARTED_ID)[i] = ev_id;
  f64(S, F_TMR_EXPIRY_TIME)[i] = wrap_add(ts, wrap_mul(timeout_s, NANOS_PER_SECOND));
  f32(S, F_TMR_TASK_STATUS)[i] = 0;
  f64(S, F_TMR_VERSION)[i] = ev_version;
}

__device__ __forceinline__ void write_child(const StatePtrs& S, int64_t i, int64_t ev_id,
                                            int64_t ev_version, int64_t batch_first) {
  f64(S, F_CH_INITIATED_ID)[i] = ev_id;
  f64(S, F_CH_STARTED_ID)[i] = EMPTY_EVENT_ID;
  f64(S, F_CH_VERSION)[i] = ev_version;
  f64(S, F_CH_BATCH_ID)[i] = batch_first;
}

// The pending tables in device memory at the JAX [W, K] layout: every
// lookup walks the occupancy row. Each insert returns false when the table
// is full; each match returns whether any slot matched.
struct GlobalTables {
  // replay_kernel's __launch_bounds__ on this route: its block, no floor
  static constexpr int MAX_THREADS = 128;
  static constexpr int MIN_BLOCKS = 1;

  const StatePtrs& S;
  int64_t w;
  const Caps& c;

  __device__ __forceinline__ GlobalTables(const StatePtrs& s, int64_t w_, const Caps& c_,
                                          int64_t*, int, int)
      : S(s), w(w_), c(c_) {}
  __device__ __forceinline__ void load() {}
  __device__ __forceinline__ void store() {}
  __device__ __forceinline__ void reset() {}  // reset_row rewrote the tables
  // the first occupied activity / timer slot at or after `from`, or -1
  __device__ __forceinline__ int act_next(int from) const {
    return next(fb(S, F_ACT_OCC) + w * c.ka, c.ka, from);
  }
  __device__ __forceinline__ int timer_next(int from) const {
    return next(fb(S, F_TMR_OCC) + w * c.kt, c.kt, from);
  }
  __device__ __forceinline__ static int next(const uint8_t* occ, int k, int from) {
    for (int i = from; i < k; ++i)
      if (occ[i]) return i;
    return -1;
  }

  __device__ __forceinline__ bool act_insert(int64_t ev_id, int64_t ev_version, int64_t ts,
                                             int64_t batch_first, const int64_t* a) {
    uint8_t* occ = fb(S, F_ACT_OCC) + w * c.ka;
    const int slot = first_free(occ, c.ka);
    if (slot < 0) return false;
    occ[slot] = 1;
    write_activity(S, w * c.ka + slot, ev_id, ev_version, ts, batch_first, a);
    return true;
  }
  __device__ __forceinline__ bool act_start(int64_t key, int64_t ev_id, int64_t ev_version,
                                            int64_t ts) {
    const int k = c.ka;
    const uint8_t* occ = fb(S, F_ACT_OCC) + w * k;
    const int64_t* sched = f64(S, F_ACT_SCHEDULE_ID) + w * k;
    bool found = false;
    for (int i = 0; i < k; ++i) {
      if (occ[i] && sched[i] == key) {
        found = true;
        write_activity_started(S, w * k + i, ev_id, ev_version, ts);
      }
    }
    return found;
  }
  __device__ __forceinline__ bool act_close(int64_t key) {
    return delete_matches(fb(S, F_ACT_OCC) + w * c.ka, f64(S, F_ACT_SCHEDULE_ID) + w * c.ka,
                          c.ka, key);
  }
  __device__ __forceinline__ void act_cancel_request(int64_t key, int64_t ev_id,
                                                     int64_t ev_version) {
    const int k = c.ka;
    const uint8_t* occ = fb(S, F_ACT_OCC) + w * k;
    const int64_t* akey = f64(S, F_ACT_ACTIVITY_KEY) + w * k;
    for (int i = 0; i < k; ++i)
      if (occ[i] && akey[i] == key) write_activity_cancel_requested(S, w * k + i, ev_id, ev_version);
  }
  __device__ __forceinline__ bool timer_insert(int64_t key, int64_t ev_id, int64_t ev_version,
                                               int64_t ts, int64_t timeout_s) {
    uint8_t* occ = fb(S, F_TMR_OCC) + w * c.kt;
    const int slot = first_free(occ, c.kt);
    if (slot < 0) return false;
    occ[slot] = 1;
    write_timer(S, w * c.kt + slot, key, ev_id, ev_version, ts, timeout_s);
    return true;
  }
  __device__ __forceinline__ bool timer_close(int64_t key) {
    return delete_matches(fb(S, F_TMR_OCC) + w * c.kt, f64(S, F_TMR_TIMER_KEY) + w * c.kt, c.kt,
                          key);
  }
  __device__ __forceinline__ bool child_insert(int64_t ev_id, int64_t ev_version,
                                               int64_t batch_first) {
    uint8_t* occ = fb(S, F_CH_OCC) + w * c.kc;
    const int slot = first_free(occ, c.kc);
    if (slot < 0) return false;
    occ[slot] = 1;
    write_child(S, w * c.kc + slot, ev_id, ev_version, batch_first);
    return true;
  }
  __device__ __forceinline__ bool child_start(int64_t key, int64_t ev_id) {
    const int k = c.kc;
    const uint8_t* occ = fb(S, F_CH_OCC) + w * k;
    const int64_t* init = f64(S, F_CH_INITIATED_ID) + w * k;
    bool found = false;
    for (int i = 0; i < k; ++i) {
      if (occ[i] && init[i] == key) {
        found = true;
        f64(S, F_CH_STARTED_ID)[w * k + i] = ev_id;
      }
    }
    return found;
  }
  __device__ __forceinline__ bool child_close(int64_t key) {
    return delete_matches(fb(S, F_CH_OCC) + w * c.kc, f64(S, F_CH_INITIATED_ID) + w * c.kc,
                          c.kc, key);
  }
  // the request-cancel and signal tables: (F_RC_OCC, c.kr) or (F_SG_OCC, c.ks)
  __device__ __forceinline__ void initiated_insert(int f_occ, int k, int64_t ev_id,
                                                   int64_t ev_version, int64_t batch_first,
                                                   int32_t& error) {
    insert_initiated(S, w, k, f_occ, ev_id, ev_version, batch_first, error);
  }
  __device__ __forceinline__ bool initiated_close(int f_occ, int k, int64_t key) {
    return delete_matches(fb(S, f_occ) + w * k, f64(S, f_occ + 1) + w * k, k, key);
  }
};

// The table events' effects, raising as ops/transitions.py does: a full
// table on insert, no matching slot on a lookup.
template <class T>
__device__ __forceinline__ void on_activity_scheduled(Scalars& r, T& t, int64_t ev_id,
                                                      int64_t ev_version, int64_t ts,
                                                      int64_t batch_first, const int64_t* a) {
  if (!t.act_insert(ev_id, ev_version, ts, batch_first, a)) r.error = E_TABLE_OVERFLOW;
}
template <class T>
__device__ __forceinline__ void on_activity_started(Scalars& r, T& t, int64_t ev_id,
                                                    int64_t ev_version, int64_t ts,
                                                    const int64_t* a) {
  if (!t.act_start(a[0], ev_id, ev_version, ts)) r.error = E_MISSING_ACTIVITY;
}
template <class T>
__device__ __forceinline__ void on_activity_closed(Scalars& r, T& t, const int64_t* a) {
  if (!t.act_close(a[0])) r.error = E_MISSING_ACTIVITY;
}
template <class T>
__device__ __forceinline__ void on_timer_started(Scalars& r, T& t, int64_t ev_id,
                                                 int64_t ev_version, int64_t ts,
                                                 const int64_t* a) {
  if (!t.timer_insert(a[0], ev_id, ev_version, ts, a[1])) r.error = E_TABLE_OVERFLOW;
}
template <class T>
__device__ __forceinline__ void on_timer_closed(Scalars& r, T& t, const int64_t* a) {
  if (!t.timer_close(a[0])) r.error = E_MISSING_TIMER;
}
template <class T>
__device__ __forceinline__ void on_child_initiated(Scalars& r, T& t, int64_t ev_id,
                                                   int64_t ev_version, int64_t batch_first) {
  if (!t.child_insert(ev_id, ev_version, batch_first)) r.error = E_TABLE_OVERFLOW;
}
template <class T>
__device__ __forceinline__ void on_child_started(Scalars& r, T& t, int64_t ev_id,
                                                 const int64_t* a) {
  if (!t.child_start(a[0], ev_id)) r.error = E_MISSING_CHILD;
}
template <class T>
__device__ __forceinline__ void on_child_closed(Scalars& r, T& t, const int64_t* a) {
  if (!t.child_close(a[0])) r.error = E_MISSING_CHILD;
}

// ops/transitions.py `step`'s per-type update, after the version history:
// the event applied cleanly so far and its type is in range.
template <class T>
__device__ __forceinline__ void apply_event(Scalars& r, T& t, const Caps& c, int64_t etype,
                                            int64_t ev_id, int64_t ev_version, int64_t ts,
                                            int64_t batch_first, const int64_t* a) {
  switch (etype) {
    case ET_WF_STARTED:
      on_workflow_started(r, ev_id, ts, a);
      break;
    case ET_DT_SCHEDULED:
      on_decision_scheduled(r, ev_id, ev_version, ts, a);
      break;
    case ET_DT_STARTED:
      on_decision_started(r, ev_id, ev_version, ts, a);
      break;
    case ET_DT_COMPLETED:
      on_decision_completed(r, a);
      break;
    case ET_DT_TIMED_OUT:
    case ET_DT_FAILED:
      if (etype == ET_DT_TIMED_OUT && a[0] == TIMEOUT_SCHEDULE_TO_START) {
        r.d_version = EMPTY_VERSION;
        r.d_sched = EMPTY_EVENT_ID;
        r.d_attempt = 0;
        r.d_timeout = 0;
        r.d_sched_ts = 0;
      } else {
        r.d_version = r.current_version;
        r.d_sched = r.next_event_id;
        r.d_attempt = wrap_add(r.d_attempt, 1);
        r.d_timeout = r.decision_sts_timeout;
        r.d_sched_ts = ts;
      }
      r.d_started = EMPTY_EVENT_ID;
      r.d_started_ts = 0;
      r.d_orig_ts = 0;
      break;
    case ET_AT_SCHEDULED:
      on_activity_scheduled(r, t, ev_id, ev_version, ts, batch_first, a);
      break;
    case ET_AT_STARTED:
      on_activity_started(r, t, ev_id, ev_version, ts, a);
      break;
    case ET_AT_COMPLETED:
    case ET_AT_FAILED:
    case ET_AT_TIMED_OUT:
    case ET_AT_CANCELED:
      on_activity_closed(r, t, a);
      break;
    case ET_AT_CANCEL_REQUESTED:  // unknown IDs tolerated
      t.act_cancel_request(a[0], ev_id, ev_version);
      break;
    case ET_TIMER_STARTED:
      on_timer_started(r, t, ev_id, ev_version, ts, a);
      break;
    case ET_TIMER_FIRED:
    case ET_TIMER_CANCELED:
      on_timer_closed(r, t, a);
      break;
    case ET_CHILD_INITIATED:
      on_child_initiated(r, t, ev_id, ev_version, batch_first);
      break;
    case ET_CHILD_STARTED:
      on_child_started(r, t, ev_id, a);
      break;
    case ET_CHILD_START_FAILED:
    case ET_CHILD_COMPLETED:
    case ET_CHILD_FAILED:
    case ET_CHILD_CANCELED:
    case ET_CHILD_TIMED_OUT:
    case ET_CHILD_TERMINATED:
      on_child_closed(r, t, a);
      break;
    case ET_RC_INITIATED:
      t.initiated_insert(F_RC_OCC, c.kr, ev_id, ev_version, batch_first, r.error);
      break;
    case ET_RC_FAILED:
    case ET_EXT_CANCEL_REQUESTED:
      if (!t.initiated_close(F_RC_OCC, c.kr, a[0])) r.error = E_MISSING_REQUEST_CANCEL;
      break;
    case ET_SG_INITIATED:
      t.initiated_insert(F_SG_OCC, c.ks, ev_id, ev_version, batch_first, r.error);
      break;
    case ET_SG_FAILED:
    case ET_EXT_SIGNALED:
      if (!t.initiated_close(F_SG_OCC, c.ks, a[0])) r.error = E_MISSING_SIGNAL;
      break;
    case ET_WF_SIGNALED:
      on_signaled(r);
      break;
    case ET_WF_CANCEL_REQUESTED:
      r.cancel_requested = true;
      break;
    case ET_WF_COMPLETED:
    case ET_WF_FAILED:
    case ET_WF_TIMED_OUT:
    case ET_WF_CANCELED:
    case ET_WF_TERMINATED:
    case ET_WF_CONTINUED_AS_NEW:
      on_workflow_closed(r, etype == ET_WF_COMPLETED    ? CS_COMPLETED
                            : etype == ET_WF_FAILED     ? CS_FAILED
                            : etype == ET_WF_TIMED_OUT  ? CS_TIMED_OUT
                            : etype == ET_WF_CANCELED   ? CS_CANCELED
                            : etype == ET_WF_TERMINATED ? CS_TERMINATED
                                                        : CS_CONTINUED_AS_NEW,
                         batch_first);
      break;
    default:  // types with no state effect (markers, failed cancels, ...)
      break;
  }
}

}  // namespace
}  // namespace cadence
