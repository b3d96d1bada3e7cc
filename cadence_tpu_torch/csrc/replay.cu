// Kernel A: replay.
//
// Replaces the JAX package's ops/transitions.py `step` (with
// `table_insert_slot`, `table_match`, `state_transition_valid` and
// ops/state.py `reset_rows`) and the `lax.scan` loops over it in
// ops/replay.py (`replay_events`, `replay_from_state`, `replay_events32`
// with `widen_wire32`, and `replay_wirec` / `replay_wirec_from_state` with
// ops/wirec.py `decode_step` fused into the loop), and, with its generator
// reader, ops/genkernel.py `_fused_scan` (`generate_and_replay` and its
// CRC and sharded forms: `gen_step` fused with `step`).
//
// Design. One thread per workflow loops over that workflow's E events and
// updates its ReplayState row in place in device memory, so a fresh
// replay and a replay from a carried state are the same launch. Where the
// JAX step blends every event type's update under masks, the thread takes
// a real `switch` on the event type. The scalars live in registers for
// the whole loop; the pending tables and version-history rows stay at the
// JAX [W, K] / [W, B, Kv] layout in device memory, and only the slots an
// event touches are read or written. Capacities (K, B, Kv) come at run
// time from the state's shapes.
//
// Semantics kept from the JAX step, which the CPU tests and chip_smoke.py
// hold this kernel to:
// - an event with id <= 0, or on a row whose error is set, changes nothing;
// - inside a live event there is no early exit past what `step` commits:
//   the version-history update, current_branch, current_version and
//   last_event_task_id are written in the same step that raises, say,
//   MISSING_ACTIVITY, and only next_event_id/last_first_event_id are held
//   back by an error (end_ok); the first error code set sticks;
// - current_version on a completed workflow, and the branch switch, read
//   the current branch's last version from the state BEFORE the step;
//   a failed decision reads the pre-step next_event_id but the chained
//   current_version and decision_sts_timeout;
// - table_match selects EVERY matching slot; inserts take the FIRST free
//   slot; a full table raises TABLE_OVERFLOW and inserts nothing;
// - branch/parent lanes are cast to int32, then clipped to [0, B-1]; only
//   branch >= B raises BRANCH_OVERFLOW;
// - FLAG_RUN_RESET re-initialises the whole row (tables, version
//   histories, current_branch) but keeps the error code;
// - int64 sums wrap (done in uint64_t; signed overflow is undefined).
//
// Four event readers, one instantiation each: int64 lanes, wire32 lanes,
// wirec, and the device generator. The int64 and wire32 readers have a second instantiation,
// TASKS, which also appends each event's transfer and timer tasks to the
// task logs (taskgen.cuh; cadence_replay_tasks). The wirec reader decodes
// the thread's slab row (B bytes) under a profile passed by value
// (wirec.cuh), with each DELTA lane's running value carried in a register
// from the `bases` column the profile names; it decodes EVERY row e < E
// before the id <= 0 skip, padding rows included, because the JAX
// decode_step advances its carry on every column and masks only the output.
// The generator reader (cadence_replay_gen) reads no event at all: each
// step runs genkernel.cuh's generator step on the thread's GenState, held
// in registers beside the Scalars, and applies the lanes it fills. The
// generator never sets FLAG_RUN_RESET, so that instance has no reset
// branch (JAX's `enable_reset=False`); the sticky-error break is right
// here too, since the generator's output feeds nothing but this row.
//
// Bound. The work per event is a few dozen integer operations and a
// K-wide scan of at most one table, so the kernel is bound by memory: the
// event lanes are read once (144 B/event as int64, 80 B as wire32, B bytes
// of slab plus the per-workflow bases and count as wirec) and the state
// (3,602 B per workflow at the default layout) is written once.
// Each thread reads its own 144-byte rows, so a warp's loads do not
// coalesce; a field-major lane and state layout is the later fix. The
// generator reader's inputs are two scalars and its output the state, so
// it is bound by integer operations: the generator's four 64-bit hashes
// and modulos a step (a 64-bit multiply is several 32-bit instructions on
// this card) beside the step's own work.
#include "genkernel.cuh"
#include "state.cuh"
#include "wirec.cuh"

namespace cadence {
namespace {

constexpr int NUM_LANES = 18;
static_assert(NUM_LANES == WIREC_LANES, "wirec decodes every lane");
constexpr int NUM_LANES32 = 20;
constexpr int LANE_TIMESTAMP = 3;
constexpr int LANE_A0 = 7;
constexpr int LANE32_TS_HI = 18;
constexpr int LANE32_A4_HI = 19;
constexpr int64_t FLAG_RUN_RESET = 1;
constexpr int64_t FLAG_VH_ONLY = 2;

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

enum Reader : int { READ_INT64 = 0, READ_WIRE32 = 1, READ_WIREC = 2, READ_GEN = 3 };

// The wirec reader: decode one slab row into the 18 lanes. `acc[i]` is
// lane i's DELTA carry, advanced here, or its TSREL_NZ base. The loop is
// unrolled, so `acc` stays in registers.
__device__ __forceinline__ void read_wirec(const uint8_t* row, const WirecProfile& p,
                                           int64_t* acc, bool real, int64_t* lane) {
#pragma unroll
  for (int i = 0; i < NUM_LANES; ++i) {
    const WirecLane& l = p.lane[i];
    int64_t v = l.cnst;
    if (l.kind != KIND_CONST) {
      const int64_t code = wirec_read_le(row, l.offset, l.width);
      int64_t unused = 0;
      v = l.kind == KIND_DELTA ? wirec_lane_value(l, code, acc[i], 0)
                               : wirec_lane_value(l, code, unused, acc[i]);
    }
    lane[i] = real ? v : wirec_pad_value(i);
  }
}

template <int READER>
__device__ __forceinline__ void read_event(const void* events, int64_t row, int64_t* lane) {
  if constexpr (READER == READ_WIRE32) {
    const int32_t* ev = static_cast<const int32_t*>(events) + row * NUM_LANES32;
#pragma unroll
    for (int i = 0; i < NUM_LANES; ++i) lane[i] = ev[i];
    lane[LANE_TIMESTAMP] = static_cast<int64_t>(
        (static_cast<uint64_t>(static_cast<uint32_t>(ev[LANE32_TS_HI])) << 32) |
        static_cast<uint32_t>(ev[LANE_TIMESTAMP]));
    lane[LANE_A0 + 4] = static_cast<int64_t>(
        (static_cast<uint64_t>(static_cast<uint32_t>(ev[LANE32_A4_HI])) << 32) |
        static_cast<uint32_t>(ev[LANE_A0 + 4]));
  } else {
    const int64_t* ev = static_cast<const int64_t*>(events) + row * NUM_LANES;
#pragma unroll
    for (int i = 0; i < NUM_LANES; ++i) lane[i] = ev[i];
  }
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

// init_state's values for one row (the error code is kept by the caller).
__device__ void reset_row(const StatePtrs& S, int64_t w, const Caps& c, Scalars& r) {
  r.state = WS_CREATED;
  r.close_status = CS_NONE;
  r.cancel_requested = false;
  r.has_parent = false;
  r.last_first_event_id = FIRST_EVENT_ID;
  r.next_event_id = FIRST_EVENT_ID;
  r.last_processed_event = EMPTY_EVENT_ID;
  r.signal_count = 0;
  r.d_version = EMPTY_VERSION;
  r.d_sched = EMPTY_EVENT_ID;
  r.d_started = EMPTY_EVENT_ID;
  r.d_attempt = 0;
  r.d_timeout = 0;
  r.d_sched_ts = 0;
  r.d_started_ts = 0;
  r.d_orig_ts = 0;
  r.workflow_timeout = 0;
  r.decision_sts_timeout = 0;
  r.start_timestamp = 0;
  r.completion_event_batch_id = EMPTY_EVENT_ID;
  r.last_event_task_id = 0;
  r.workflow_attempt = 0;
  r.expiration_time = 0;
  r.current_version = EMPTY_VERSION;
  r.current_branch = 0;

  const int64_t nv = int64_t(c.b) * c.kv;
  for (int64_t i = 0; i < nv; ++i) {
    f64(S, F_VH_EVENT_IDS)[w * nv + i] = PAD;
    f64(S, F_VH_VERSIONS)[w * nv + i] = PAD;
  }
  for (int i = 0; i < c.b; ++i) f32(S, F_VH_COUNT)[w * c.b + i] = 0;

  // every table field is zero (False) at init
  struct Span { int first, last, k; };
  const Span spans[5] = {{F_ACT_OCC, F_ACT_BATCH_ID, c.ka},
                         {F_TMR_OCC, F_TMR_VERSION, c.kt},
                         {F_CH_OCC, F_CH_BATCH_ID, c.kc},
                         {F_RC_OCC, F_RC_BATCH_ID, c.kr},
                         {F_SG_OCC, F_SG_BATCH_ID, c.ks}};
  for (int t = 0; t < 5; ++t) {
    const int k = spans[t].k;
    for (int f = spans[t].first; f <= spans[t].last; ++f) {
      if (f == F_ACT_OCC || f == F_ACT_CANCEL_REQUESTED || f == F_ACT_HAS_RETRY ||
          f == F_TMR_OCC || f == F_CH_OCC || f == F_RC_OCC || f == F_SG_OCC) {
        for (int i = 0; i < k; ++i) fb(S, f)[w * k + i] = 0;
      } else if (f == F_ACT_TIMER_STATUS || f == F_TMR_TASK_STATUS) {
        for (int i = 0; i < k; ++i) f32(S, f)[w * k + i] = 0;
      } else {
        for (int i = 0; i < k; ++i) f64(S, f)[w * k + i] = 0;
      }
    }
  }
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

// The wirec inputs; unused by the other readers.
struct WirecArgs {
  const int64_t* bases;    // [W, K]
  const int32_t* n_events; // [W]
  int b, k;                // slab bytes per event, bases columns
};

// The generator reader's inputs: row w is global workflow first_index + w.
struct GenArgs {
  int64_t seed, first_index;
};

#include "taskgen.cuh"

// TASKS: also emit each event's transfer and timer tasks into the logs `L`
// (taskgen.cuh); unused otherwise.
template <int READER, bool TASKS>
__global__ void replay_kernel(StatePtrs S, const void* __restrict__ events, int64_t W,
                              int64_t E, Caps c, WirecArgs wa, GenArgs ga,
                              const __grid_constant__ WirecProfile prof, TaskLogPtrs L) {
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= W) return;

  TaskCursor cur{};
  if constexpr (TASKS) cur = TaskCursor{L.tr_count[w], L.tm_count[w], L.overflow[w] != 0};

  int64_t acc[NUM_LANES];
  int64_t n_real = 0;
  if constexpr (READER == READ_WIREC) {
    n_real = wa.n_events[w];
#pragma unroll
    for (int i = 0; i < NUM_LANES; ++i)
      acc[i] = prof.lane[i].base >= 0 ? wa.bases[w * wa.k + prof.lane[i].base] : 0;
  }
  gen::GenState gs;
  if constexpr (READER == READ_GEN) gen::init(gs, ga.seed, ga.first_index + w);

  Scalars r;
  load_scalars(S, w, r);
  int64_t* vh_ids = f64(S, F_VH_EVENT_IDS) + w * c.b * c.kv;
  int64_t* vh_vers = f64(S, F_VH_VERSIONS) + w * c.b * c.kv;
  int32_t* vh_cnt = f32(S, F_VH_COUNT) + w * c.b;
  const int kv = c.kv;

  for (int64_t e = 0; e < E; ++e) {
    if (r.error != 0) break;  // sticky: nothing later can change the row
    int64_t lane[NUM_LANES];
    if constexpr (READER == READ_WIREC)
      read_wirec(static_cast<const uint8_t*>(events) + (w * E + e) * wa.b, prof, acc,
                 e < n_real, lane);
    else if constexpr (READER == READ_GEN)
      gen::step(gs, ga.seed, ga.first_index + w, e, E, lane);
    else
      read_event<READER>(events, w * E + e, lane);
    const int64_t ev_id = lane[0];
    if (ev_id <= 0) continue;
    const int64_t etype = lane[1];
    const int64_t ev_version = lane[2];
    const int64_t ts = lane[3];
    const int64_t task_id = lane[4];
    const int64_t batch_first = lane[5];
    const int64_t batch_last = lane[6];
    const int64_t* a = lane + LANE_A0;
    const int32_t branch = static_cast<int32_t>(lane[15]);
    const int32_t parent = static_cast<int32_t>(lane[16]);
    const int64_t flags = lane[17];

    // 0. continue-as-new run boundary
    if constexpr (READER != READ_GEN) {
      if (flags & FLAG_RUN_RESET) reset_row(S, w, c, r);
    }
    const bool vh_only = (flags & FLAG_VH_ONLY) != 0;

    // 1. per-branch version history with fork-inherit
    if (branch >= c.b) {
      r.error = E_BRANCH_OVERFLOW;
      continue;
    }
    const int b = branch < 0 ? 0 : branch;
    const int p = parent < 0 ? 0 : (parent > c.b - 1 ? c.b - 1 : parent);
    int32_t b_count = vh_cnt[b];
    const int32_t p_count = vh_cnt[p];

    // the current branch's last version, before this step
    const int cb = r.current_branch < 0 ? 0
                   : (r.current_branch > c.b - 1 ? c.b - 1 : r.current_branch);
    const int32_t cur_count = vh_cnt[cb];
    int64_t cur_last_version = EMPTY_VERSION;
    if (cur_count > 0) cur_last_version = cur_count - 1 < kv ? vh_vers[cb * kv + cur_count - 1] : 0;

    if (b_count == 0 && p != b) {  // fork-inherit the parent's prefix
      const int64_t lca = ev_id - 1;
      if (p_count == 0 || lca < 1) {
        r.error = E_BAD_FORK;
        continue;
      }
      int32_t cnt = 0;
      for (int k = 0; k < kv; ++k) {
        const int64_t prev = k == 0 ? 0 : vh_ids[p * kv + k - 1];
        const bool keep = k < p_count && prev < lca;
        const int64_t pid = vh_ids[p * kv + k];
        vh_ids[b * kv + k] = keep ? (pid < lca ? pid : lca) : PAD;
        vh_vers[b * kv + k] = keep ? vh_vers[p * kv + k] : PAD;
        cnt += keep ? 1 : 0;
      }
      b_count = cnt;
      vh_cnt[b] = cnt;
    }

    const bool has_items = b_count > 0;
    const int32_t last_idx = b_count - 1 > 0 ? b_count - 1 : 0;
    int64_t vh_last_version = EMPTY_VERSION, vh_last_event = EMPTY_EVENT_ID;
    if (has_items) {
      vh_last_version = last_idx < kv ? vh_vers[b * kv + last_idx] : 0;
      vh_last_event = last_idx < kv ? vh_ids[b * kv + last_idx] : 0;
    }

    // 2. AddOrUpdateItem(event.ID, event.Version)
    const bool vh_order_bad =
        has_items && (ev_version < vh_last_version || ev_id <= vh_last_event);
    if (vh_order_bad) r.error = E_VERSION_HISTORY_ORDER;
    const bool vh_ok = !vh_order_bad;
    const bool append = vh_ok && (!has_items || ev_version > vh_last_version);
    const bool vh_overflow = append && b_count >= kv;
    if (vh_overflow && r.error == 0) r.error = E_VERSION_HISTORY_OVERFLOW;
    const bool append_ok = append && !vh_overflow;
    const bool update_last = vh_ok && has_items && ev_version == vh_last_version;
    if (append_ok) {
      vh_ids[b * kv + b_count] = ev_id;
      vh_vers[b * kv + b_count] = ev_version;
      vh_cnt[b] = b_count + 1;
    }
    if (update_last && last_idx < kv) vh_ids[b * kv + last_idx] = ev_id;

    // 3. current-branch arbitration
    bool ok = vh_ok && !vh_overflow;
    if (ok && b != r.current_branch && ev_version > cur_last_version) r.current_branch = b;

    // 4. UpdateCurrentVersion(version, force=True)
    if (!vh_only) r.current_version = r.state == WS_COMPLETED ? cur_last_version : ev_version;

    ok = ok && !vh_only;
    if (!ok) continue;
    r.last_event_task_id = task_id;
    if (etype < 0 || etype > ET_LAST) {
      r.error = E_UNKNOWN_EVENT_TYPE;
      continue;
    }

    switch (etype) {
      case ET_WF_STARTED:
        if (!transition_valid(r.state, r.close_status, WS_CREATED, CS_NONE)) {
          r.error = E_INVALID_STATE_TRANSITION;
          break;
        }
        if (a[2] > 0 && (a[7] == 0 || a[7] >= 3)) {
          r.error = E_INVALID_BACKOFF_INITIATOR;
          break;
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
        break;
      case ET_DT_SCHEDULED: {
        const bool trans = r.state != WS_ZOMBIE;
        if (trans && !transition_valid(r.state, r.close_status, WS_RUNNING, CS_NONE)) {
          r.error = E_INVALID_STATE_TRANSITION;
          break;
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
        break;
      }
      case ET_DT_STARTED:
        if (r.d_sched != a[0]) {
          r.error = E_MISSING_DECISION;
          break;
        }
        r.d_version = ev_version;
        r.d_started = ev_id;
        r.d_attempt = 0;
        r.d_started_ts = ts;
        break;
      case ET_DT_COMPLETED:
        r.d_version = EMPTY_VERSION;
        r.d_sched = EMPTY_EVENT_ID;
        r.d_started = EMPTY_EVENT_ID;
        r.d_attempt = 0;
        r.d_timeout = 0;
        r.d_sched_ts = 0;
        r.d_started_ts = 0;
        r.last_processed_event = a[1];
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
      case ET_AT_SCHEDULED: {
        const int k = c.ka;
        uint8_t* occ = fb(S, F_ACT_OCC) + w * k;
        const int slot = first_free(occ, k);
        if (slot < 0) {
          r.error = E_TABLE_OVERFLOW;
          break;
        }
        const int64_t i = w * k + slot;
        occ[slot] = 1;
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
        break;
      }
      case ET_AT_STARTED: {
        const int k = c.ka;
        const uint8_t* occ = fb(S, F_ACT_OCC) + w * k;
        int64_t* sched = f64(S, F_ACT_SCHEDULE_ID) + w * k;
        bool found = false;
        for (int i = 0; i < k; ++i) {
          if (occ[i] && sched[i] == a[0]) {
            found = true;
            f64(S, F_ACT_VERSION)[w * k + i] = ev_version;
            f64(S, F_ACT_STARTED_ID)[w * k + i] = ev_id;
            f64(S, F_ACT_STARTED_TIME)[w * k + i] = ts;
            f64(S, F_ACT_LAST_HEARTBEAT)[w * k + i] = ts;
          }
        }
        if (!found) r.error = E_MISSING_ACTIVITY;
        break;
      }
      case ET_AT_COMPLETED:
      case ET_AT_FAILED:
      case ET_AT_TIMED_OUT:
      case ET_AT_CANCELED:
        if (!delete_matches(fb(S, F_ACT_OCC) + w * c.ka, f64(S, F_ACT_SCHEDULE_ID) + w * c.ka,
                            c.ka, a[0]))
          r.error = E_MISSING_ACTIVITY;
        break;
      case ET_AT_CANCEL_REQUESTED: {  // unknown IDs tolerated
        const int k = c.ka;
        const uint8_t* occ = fb(S, F_ACT_OCC) + w * k;
        const int64_t* key = f64(S, F_ACT_ACTIVITY_KEY) + w * k;
        for (int i = 0; i < k; ++i) {
          if (occ[i] && key[i] == a[0]) {
            f64(S, F_ACT_VERSION)[w * k + i] = ev_version;
            fb(S, F_ACT_CANCEL_REQUESTED)[w * k + i] = 1;
            f64(S, F_ACT_CANCEL_REQUEST_ID)[w * k + i] = ev_id;
          }
        }
        break;
      }
      case ET_TIMER_STARTED: {
        const int k = c.kt;
        uint8_t* occ = fb(S, F_TMR_OCC) + w * k;
        const int slot = first_free(occ, k);
        if (slot < 0) {
          r.error = E_TABLE_OVERFLOW;
          break;
        }
        const int64_t i = w * k + slot;
        occ[slot] = 1;
        f64(S, F_TMR_TIMER_KEY)[i] = a[0];
        f64(S, F_TMR_STARTED_ID)[i] = ev_id;
        f64(S, F_TMR_EXPIRY_TIME)[i] = wrap_add(ts, wrap_mul(a[1], NANOS_PER_SECOND));
        f32(S, F_TMR_TASK_STATUS)[i] = 0;
        f64(S, F_TMR_VERSION)[i] = ev_version;
        break;
      }
      case ET_TIMER_FIRED:
      case ET_TIMER_CANCELED:
        if (!delete_matches(fb(S, F_TMR_OCC) + w * c.kt, f64(S, F_TMR_TIMER_KEY) + w * c.kt,
                            c.kt, a[0]))
          r.error = E_MISSING_TIMER;
        break;
      case ET_CHILD_INITIATED: {
        const int k = c.kc;
        uint8_t* occ = fb(S, F_CH_OCC) + w * k;
        const int slot = first_free(occ, k);
        if (slot < 0) {
          r.error = E_TABLE_OVERFLOW;
          break;
        }
        const int64_t i = w * k + slot;
        occ[slot] = 1;
        f64(S, F_CH_INITIATED_ID)[i] = ev_id;
        f64(S, F_CH_STARTED_ID)[i] = EMPTY_EVENT_ID;
        f64(S, F_CH_VERSION)[i] = ev_version;
        f64(S, F_CH_BATCH_ID)[i] = batch_first;
        break;
      }
      case ET_CHILD_STARTED: {
        const int k = c.kc;
        const uint8_t* occ = fb(S, F_CH_OCC) + w * k;
        const int64_t* init = f64(S, F_CH_INITIATED_ID) + w * k;
        bool found = false;
        for (int i = 0; i < k; ++i) {
          if (occ[i] && init[i] == a[0]) {
            found = true;
            f64(S, F_CH_STARTED_ID)[w * k + i] = ev_id;
          }
        }
        if (!found) r.error = E_MISSING_CHILD;
        break;
      }
      case ET_CHILD_START_FAILED:
      case ET_CHILD_COMPLETED:
      case ET_CHILD_FAILED:
      case ET_CHILD_CANCELED:
      case ET_CHILD_TIMED_OUT:
      case ET_CHILD_TERMINATED:
        if (!delete_matches(fb(S, F_CH_OCC) + w * c.kc, f64(S, F_CH_INITIATED_ID) + w * c.kc,
                            c.kc, a[0]))
          r.error = E_MISSING_CHILD;
        break;
      case ET_RC_INITIATED:
        insert_initiated(S, w, c.kr, F_RC_OCC, ev_id, ev_version, batch_first, r.error);
        break;
      case ET_RC_FAILED:
      case ET_EXT_CANCEL_REQUESTED:
        if (!delete_matches(fb(S, F_RC_OCC) + w * c.kr, f64(S, F_RC_INITIATED_ID) + w * c.kr,
                            c.kr, a[0]))
          r.error = E_MISSING_REQUEST_CANCEL;
        break;
      case ET_SG_INITIATED:
        insert_initiated(S, w, c.ks, F_SG_OCC, ev_id, ev_version, batch_first, r.error);
        break;
      case ET_SG_FAILED:
      case ET_EXT_SIGNALED:
        if (!delete_matches(fb(S, F_SG_OCC) + w * c.ks, f64(S, F_SG_INITIATED_ID) + w * c.ks,
                            c.ks, a[0]))
          r.error = E_MISSING_SIGNAL;
        break;
      case ET_WF_SIGNALED:
        r.signal_count = wrap_add(r.signal_count, 1);
        break;
      case ET_WF_CANCEL_REQUESTED:
        r.cancel_requested = true;
        break;
      case ET_WF_COMPLETED:
      case ET_WF_FAILED:
      case ET_WF_TIMED_OUT:
      case ET_WF_CANCELED:
      case ET_WF_TERMINATED:
      case ET_WF_CONTINUED_AS_NEW: {
        const int32_t cs = etype == ET_WF_COMPLETED  ? CS_COMPLETED
                           : etype == ET_WF_FAILED   ? CS_FAILED
                           : etype == ET_WF_TIMED_OUT ? CS_TIMED_OUT
                           : etype == ET_WF_CANCELED ? CS_CANCELED
                           : etype == ET_WF_TERMINATED ? CS_TERMINATED
                                                       : CS_CONTINUED_AS_NEW;
        if (!transition_valid(r.state, r.close_status, WS_COMPLETED, cs)) {
          r.error = E_INVALID_STATE_TRANSITION;
          break;
        }
        r.state = WS_COMPLETED;
        r.close_status = cs;
        r.completion_event_batch_id = batch_first;
        break;
      }
      default:  // types with no state effect (markers, failed cancels, ...)
        break;
    }

    // batch-end bookkeeping, only when this event applied cleanly
    if (r.error == 0 && batch_last == 1) {
      r.last_first_event_id = batch_first;
      r.next_event_id = wrap_add(ev_id, 1);
    }

    // the event's tasks, from the post-step state. Every `continue` above
    // skips them: each is an id <= 0, an error, or a VH-only event, which
    // emit nothing; an error set inside the switch suppresses them here.
    if constexpr (TASKS) {
      if (r.error == 0)
        step_tasks(S, w, c, r, L, cur, ev_id, etype, ev_version, ts, batch_last, a[0], a[2],
                   a[3], a[7]);
    }
  }
  store_scalars(S, w, r);
  if constexpr (TASKS) {
    L.tr_count[w] = cur.tr;
    L.tm_count[w] = cur.tm;
    L.overflow[w] = cur.overflow ? 1 : 0;
  }
}

}  // namespace
}  // namespace cadence

namespace {

cadence::StatePtrs state_from(const void* ptr_table) {
  cadence::StatePtrs S;
  const uint64_t* table = static_cast<const uint64_t*>(ptr_table);
  for (int i = 0; i < cadence::NUM_FIELDS; ++i) S.p[i] = reinterpret_cast<void*>(table[i]);
  return S;
}

constexpr int REPLAY_THREADS = 128;

// The dense readers' launch, without or with tasks.
template <bool TASKS>
int launch_dense(const void* ptr_table, const void* events, int64_t W, int64_t E, int wire32,
                 const int* caps, int b, int kv, const cadence::TaskLogPtrs& L, void* stream) {
  using namespace cadence;
  const StatePtrs S = state_from(ptr_table);
  Caps c{caps[0], caps[1], caps[2], caps[3], caps[4], b, kv};
  if (W <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((W + REPLAY_THREADS - 1) / REPLAY_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WirecArgs none{nullptr, nullptr, 0, 0};
  const WirecProfile no_profile{};
  if (wire32)
    replay_kernel<READ_WIRE32, TASKS><<<blocks, REPLAY_THREADS, 0, st>>>(
        S, events, W, E, c, none, GenArgs{}, no_profile, L);
  else
    replay_kernel<READ_INT64, TASKS><<<blocks, REPLAY_THREADS, 0, st>>>(
        S, events, W, E, c, none, GenArgs{}, no_profile, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cadence_replay(const void* ptr_table, const void* events, int64_t W, int64_t E,
                              int wire32, const int* caps, int b, int kv, void* stream) {
  return launch_dense<false>(ptr_table, events, W, E, wire32, caps, b, kv,
                             cadence::TaskLogPtrs{}, stream);
}

// Kernel A with tasks: as cadence_replay, and the transfer and timer task
// logs, 12 device pointers in ops/taskgen.py TaskLog order ([W, Tt] / [W, Tm]
// int64 rows, [W] int64 counts, [W] bool overflow), appended to in place.
// `retention` is retention_days * 86400e9, which the caller checked fits.
extern "C" int cadence_replay_tasks(const void* ptr_table, const void* log_table,
                                    const void* events, int64_t W, int64_t E, int wire32,
                                    const int* caps, int b, int kv, int64_t tt, int64_t tm,
                                    int64_t retention, void* stream) {
  const uint64_t* p = static_cast<const uint64_t*>(log_table);
  auto i64 = [&](int i) { return reinterpret_cast<int64_t*>(p[i]); };
  const cadence::TaskLogPtrs L{i64(0), i64(1), i64(2), i64(3), i64(4), i64(5),
                               i64(6), i64(7), i64(8), i64(9), i64(10),
                               reinterpret_cast<uint8_t*>(p[11]), tt, tm, retention};
  return launch_dense<true>(ptr_table, events, W, E, wire32, caps, b, kv, L, stream);
}

// Kernel A's wirec reader: slab [W, E, B] uint8, bases [W, K] int64,
// n_events [W] int32, and the profile as ops/wirec.py profile_table gives it.
extern "C" int cadence_replay_wirec(const void* ptr_table, const void* slab, const void* bases,
                                    const void* n_events, int64_t W, int64_t E, int B, int K,
                                    const int64_t* profile, const int* caps, int b, int kv,
                                    void* stream) {
  using namespace cadence;
  const StatePtrs S = state_from(ptr_table);
  Caps c{caps[0], caps[1], caps[2], caps[3], caps[4], b, kv};
  if (W <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((W + REPLAY_THREADS - 1) / REPLAY_THREADS);
  const WirecArgs wa{static_cast<const int64_t*>(bases), static_cast<const int32_t*>(n_events),
                     B, K};
  replay_kernel<READ_WIREC, false>
      <<<blocks, REPLAY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          S, slab, W, E, c, wa, GenArgs{}, wirec_profile_from(profile), TaskLogPtrs{});
  return static_cast<int>(cudaGetLastError());
}

// Kernel A's generator reader: generate and replay E events for each of the
// W workflows first_index .. first_index + W - 1 of `seed`, in place on the
// state (ops/genkernel.py generate_and_replay's loop).
extern "C" int cadence_replay_gen(const void* ptr_table, int64_t seed, int64_t first_index,
                                  int64_t W, int64_t E, const int* caps, int b, int kv,
                                  void* stream) {
  using namespace cadence;
  const StatePtrs S = state_from(ptr_table);
  Caps c{caps[0], caps[1], caps[2], caps[3], caps[4], b, kv};
  if (W <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((W + REPLAY_THREADS - 1) / REPLAY_THREADS);
  const WirecArgs none{nullptr, nullptr, 0, 0};
  const WirecProfile no_profile{};
  replay_kernel<READ_GEN, false><<<blocks, REPLAY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      S, nullptr, W, E, c, none, GenArgs{seed, first_index}, no_profile, TaskLogPtrs{});
  return static_cast<int>(cudaGetLastError());
}
