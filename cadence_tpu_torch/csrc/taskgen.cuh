// Kernel A's task emission: the TASKS variant of replay_kernel.
//
// Replaces the JAX package's ops/taskgen.py `step_tasks` (with
// `batch_end_timer_tasks`, `emit_transfer` / `emit_timer`, `_lex_min3` and
// `init_task_log`'s layout), run after every event by ops/replay.py
// `replay_events_with_tasks`. The plain version is
// cadence_tpu_torch/ops/taskgen.py, which the tests and chip_smoke.py hold
// this code to.
//
// Included by replay_kernel.cuh inside its namespace, after the event-type and
// timeout constants, wrap_add / wrap_mul and struct Scalars, which it uses.
//
// Design. The same thread that stepped the workflow emits its tasks from
// the post-step state: the scalars it holds in registers, the occupancy
// through the route's table policy (act_next / timer_next) and the other
// table fields from device memory, where every route writes them through.
// The log counts and the overflow flag stay in registers for the whole
// event loop; an entry is written straight to the [W, T] log rows (the JAX
// layout). A `switch` on the event type decides which entries an event
// writes, in the JAX order. At a batch's last event the activity and
// user-timer scans walk the occupied slots once, reading the table fields
// from device memory (no local copies), and fold the JAX package's three
// masked minima into one pass (LexMin).
//
// Bound. A task entry is 24 B (transfer) or 48 B (timer) written once; the
// scans re-read at most 12 fields of each occupied activity slot and 3 of
// each occupied timer slot per batch. The kernel stays bound by kernel A's
// per-event chain of dependent loads, not by these bytes.

struct TaskLogPtrs {
  int64_t *tr_type, *tr_version, *tr_event_id, *tr_count;
  int64_t *tm_type, *tm_version, *tm_vis, *tm_event_id, *tm_timeout_type, *tm_attempt,
      *tm_count;
  uint8_t* overflow;  // torch.bool
  int64_t tt, tm;     // capacities of the transfer and timer logs
  int64_t retention;  // retention_days * 86400e9, checked on the host
};

// TransferTaskType, TimerTaskType, WorkflowBackoffTimeoutType, TimeoutType
// (core/enums.py)
constexpr int64_t TR_DECISION = 0, TR_ACTIVITY = 1, TR_CLOSE = 2, TR_CANCEL = 3,
                  TR_START_CHILD = 4, TR_SIGNAL = 5, TR_RECORD_STARTED = 6,
                  TR_UPSERT_SEARCH_ATTRIBUTES = 8;
constexpr int64_t TM_DECISION_TIMEOUT = 0, TM_ACTIVITY_TIMEOUT = 1, TM_USER_TIMER = 2,
                  TM_WORKFLOW_TIMEOUT = 3, TM_DELETE_HISTORY = 4, TM_WORKFLOW_BACKOFF = 6;
constexpr int64_t BACKOFF_RETRY = 0, BACKOFF_CRON = 1;
constexpr int64_t TO_START_TO_CLOSE = 0, TO_SCHEDULE_TO_START = 1, TO_SCHEDULE_TO_CLOSE = 2,
                  TO_HEARTBEAT = 3;
// TIMER_TASK_STATUS_CREATED_* bits, and the user timers' CREATED status
constexpr int32_t BIT_START_TO_CLOSE = 1, BIT_SCHEDULE_TO_START = 2,
                  BIT_SCHEDULE_TO_CLOSE = 4, BIT_HEARTBEAT = 8;
constexpr int32_t TIMER_CREATED = 1;
// what an invalid candidate enters each minimum as (`_lex_min3`'s `big`)
constexpr int64_t LEX_BIG = int64_t(1) << 62;

// One workflow's log counts and overflow flag, in registers.
struct TaskCursor {
  int64_t tr, tm;
  bool overflow;
};

// A full log does not advance its count and sets the shared overflow flag.
__device__ __forceinline__ void emit_transfer(const TaskLogPtrs& L, int64_t w, TaskCursor& c,
                                              int64_t type, int64_t version, int64_t event_id) {
  if (c.tr >= L.tt) {
    c.overflow = true;
    return;
  }
  const int64_t i = w * L.tt + c.tr++;
  L.tr_type[i] = type;
  L.tr_version[i] = version;
  L.tr_event_id[i] = event_id;
}

__device__ __forceinline__ void emit_timer(const TaskLogPtrs& L, int64_t w, TaskCursor& c,
                                           int64_t type, int64_t version, int64_t vis,
                                           int64_t event_id, int64_t timeout_type,
                                           int64_t attempt) {
  if (c.tm >= L.tm) {
    c.overflow = true;
    return;
  }
  const int64_t i = w * L.tm + c.tm++;
  L.tm_type[i] = type;
  L.tm_version[i] = version;
  L.tm_vis[i] = vis;
  L.tm_event_id[i] = event_id;
  L.tm_timeout_type[i] = timeout_type;
  L.tm_attempt[i] = attempt;
}

// `_lex_min3` in one pass. add() takes the VALID candidates in any order,
// each with its index in the concatenated candidate row; select() then
// gives the JAX result over all `n_cand` candidates. JAX takes three
// masked minima, where every candidate outside the mask (invalid, or not
// tied at the previous key) enters as LEX_BIG. So the lexicographic
// minimum (ts, eid, type, first index) over the valid candidates is JAX's
// selection, unless one of its keys lies above LEX_BIG while a candidate
// outside that key's mask exists: JAX's minimum is then LEX_BIG, which no
// masked candidate equals, and nothing is selected though `found` holds.
struct LexMin {
  int64_t n_valid = 0, n_ts = 0, n_eid = 0;  // valid; tied at min ts; tied at min (ts, eid)
  int64_t ts = 0, eid = 0, type = 0;
  int idx = -1;

  __device__ __forceinline__ void add(int64_t t, int64_t e, int64_t y, int i) {
    if (n_valid++ == 0 || t < ts) {
      ts = t, eid = e, type = y, idx = i, n_ts = 1, n_eid = 1;
    } else if (t == ts) {
      ++n_ts;
      if (e < eid) {
        eid = e, type = y, idx = i, n_eid = 1;
      } else if (e == eid) {
        ++n_eid;
        if (y < type || (y == type && i < idx)) type = y, idx = i;
      }
    }
  }
  __device__ __forceinline__ bool found() const { return n_valid > 0; }
  // the selected candidate's index, or -1
  __device__ __forceinline__ int select(int64_t n_cand) const {
    if ((n_valid < n_cand && ts > LEX_BIG) || (n_ts < n_cand && eid > LEX_BIG) ||
        (n_eid < n_cand && type > LEX_BIG))
      return -1;
    return idx;
  }
};

// GenerateActivityTimerTasks at batch end: the first of the four candidate
// timers of every pending activity (timer_sequence.go:219-254), created
// unless its bit is already set.
template <class T>
__device__ void activity_timer_task(const StatePtrs& S, const T& t, int64_t w, int k_cap,
                                    int64_t current_version, const TaskLogPtrs& L,
                                    TaskCursor& cur) {
  const int64_t base = w * k_cap;
  LexMin lm;
  for (int k = t.act_next(0); k >= 0; k = t.act_next(k + 1)) {
    const int64_t i = base + k;
    const int64_t eid = f64(S, F_ACT_SCHEDULE_ID)[i];
    const int64_t sched = f64(S, F_ACT_SCHEDULED_TIME)[i];
    lm.add(wrap_add(sched, wrap_mul(f64(S, F_ACT_SCHED_TO_CLOSE)[i], NANOS_PER_SECOND)), eid,
           TO_SCHEDULE_TO_CLOSE, k);
    if (f64(S, F_ACT_STARTED_ID)[i] == EMPTY_EVENT_ID) {
      lm.add(wrap_add(sched, wrap_mul(f64(S, F_ACT_SCHED_TO_START)[i], NANOS_PER_SECOND)), eid,
             TO_SCHEDULE_TO_START, k_cap + k);
    } else {
      const int64_t started = f64(S, F_ACT_STARTED_TIME)[i];
      lm.add(wrap_add(started, wrap_mul(f64(S, F_ACT_START_TO_CLOSE)[i], NANOS_PER_SECOND)),
             eid, TO_START_TO_CLOSE, 2 * k_cap + k);
      const int64_t hb = f64(S, F_ACT_HEARTBEAT)[i];
      if (hb > 0) {
        const int64_t last = f64(S, F_ACT_LAST_HEARTBEAT)[i];
        lm.add(wrap_add(started > last ? started : last, wrap_mul(hb, NANOS_PER_SECOND)), eid,
               TO_HEARTBEAT, 3 * k_cap + k);
      }
    }
  }
  if (!lm.found()) return;
  const int sel = lm.select(4 * int64_t(k_cap));
  int64_t vis = 0, eid = 0, type = 0, attempt = 0;
  if (sel >= 0) {
    const int q = sel / k_cap;
    const int64_t i = base + sel % k_cap;
    const int32_t bit = q == 0 ? BIT_SCHEDULE_TO_CLOSE
                        : q == 1 ? BIT_SCHEDULE_TO_START
                        : q == 2 ? BIT_START_TO_CLOSE
                                 : BIT_HEARTBEAT;
    int32_t* status = f32(S, F_ACT_TIMER_STATUS) + i;
    if (*status & bit) return;  // the first timer is already created
    *status |= bit;
    vis = lm.ts, eid = lm.eid, type = lm.type, attempt = f64(S, F_ACT_ATTEMPT)[i];
  }
  emit_timer(L, w, cur, TM_ACTIVITY_TIMEOUT, current_version, vis, eid, type, attempt);
}

// GenerateUserTimerTasks at batch end (timer_sequence.go:127-160).
template <class T>
__device__ void user_timer_task(const StatePtrs& S, const T& t, int64_t w, int k_cap,
                                int64_t current_version, const TaskLogPtrs& L,
                                TaskCursor& cur) {
  const int64_t base = w * k_cap;
  LexMin lm;
  for (int k = t.timer_next(0); k >= 0; k = t.timer_next(k + 1))
    lm.add(f64(S, F_TMR_EXPIRY_TIME)[base + k], f64(S, F_TMR_STARTED_ID)[base + k], 0, k);
  if (!lm.found()) return;
  const int sel = lm.select(k_cap);
  int64_t vis = 0, eid = 0;
  if (sel >= 0) {
    int32_t* status = f32(S, F_TMR_TASK_STATUS) + base + sel;
    if (*status == TIMER_CREATED) return;
    *status = TIMER_CREATED;
    vis = lm.ts, eid = lm.eid;
  }
  emit_timer(L, w, cur, TM_USER_TIMER, current_version, vis, eid, 0, 0);
}

// step_tasks for one workflow and one event that applied cleanly (the
// caller tests id > 0, no error after the step, not VH-only). `r` is the
// post-step state, `t` the route's tables; a0..a7 the event's attribute
// lanes that tasks read (passed by value, so the caller's lanes stay in
// registers).
template <class T>
__device__ __forceinline__ void step_tasks(const StatePtrs& S, int64_t w, const Caps& c,
                                           const Scalars& r, const T& t, const TaskLogPtrs& L,
                                           TaskCursor& cur, int64_t ev_id, int64_t etype,
                                           int64_t ev_version, int64_t ts, int64_t batch_last,
                                           int64_t a0, int64_t a2, int64_t a3, int64_t a7) {
  switch (etype) {
    case ET_WF_STARTED: {  // state_builder.go:158-177
      emit_transfer(L, w, cur, TR_RECORD_STARTED, ev_version, 0);
      const int64_t backoff = wrap_mul(a2, NANOS_PER_SECOND);
      int64_t timeout_ts =
          wrap_add(wrap_add(ts, wrap_mul(r.workflow_timeout, NANOS_PER_SECOND)), backoff);
      if (a3 > 0 && r.expiration_time != 0 && timeout_ts > r.expiration_time)
        timeout_ts = r.expiration_time;
      emit_timer(L, w, cur, TM_WORKFLOW_TIMEOUT, ev_version, timeout_ts, 0, 0, 0);
      if (a2 > 0)  // the initiator lane: RetryPolicy → Retry, else Cron
        emit_timer(L, w, cur, TM_WORKFLOW_BACKOFF, ev_version, wrap_add(ts, backoff), 0,
                   a7 == 1 ? BACKOFF_RETRY : BACKOFF_CRON, 0);
      break;
    }
    case ET_DT_TIMED_OUT:  // a schedule-to-start timeout schedules no transient decision
      if (a0 == TIMEOUT_SCHEDULE_TO_START) break;
      [[fallthrough]];
    case ET_DT_SCHEDULED:
    case ET_DT_FAILED:
      emit_transfer(L, w, cur, TR_DECISION, r.d_version, r.d_sched);
      break;
    case ET_DT_STARTED:  // task_generator.go:352-388
      emit_timer(L, w, cur, TM_DECISION_TIMEOUT, r.d_version,
                 wrap_add(r.d_started_ts, wrap_mul(r.d_timeout, NANOS_PER_SECOND)), r.d_sched,
                 TO_START_TO_CLOSE, r.d_attempt);
      break;
    case ET_AT_SCHEDULED:
      emit_transfer(L, w, cur, TR_ACTIVITY, ev_version, ev_id);
      break;
    case ET_CHILD_INITIATED:
      emit_transfer(L, w, cur, TR_START_CHILD, ev_version, ev_id);
      break;
    case ET_RC_INITIATED:
      emit_transfer(L, w, cur, TR_CANCEL, ev_version, ev_id);
      break;
    case ET_SG_INITIATED:
      emit_transfer(L, w, cur, TR_SIGNAL, ev_version, ev_id);
      break;
    case ET_UPSERT_SEARCH_ATTRIBUTES:
      emit_transfer(L, w, cur, TR_UPSERT_SEARCH_ATTRIBUTES, r.current_version, 0);
      break;
    case ET_WF_COMPLETED:
    case ET_WF_FAILED:
    case ET_WF_TIMED_OUT:
    case ET_WF_CANCELED:
    case ET_WF_TERMINATED:
    case ET_WF_CONTINUED_AS_NEW:  // task_generator.go:168-258, passive path
      emit_transfer(L, w, cur, TR_CLOSE, ev_version, 0);
      emit_timer(L, w, cur, TM_DELETE_HISTORY, ev_version, wrap_add(ts, L.retention), 0, 0, 0);
      break;
    default:
      break;
  }
  if (batch_last == 1) {  // state_builder.go:634-640
    activity_timer_task(S, t, w, c.ka, r.current_version, L, cur);
    user_timer_task(S, t, w, c.kt, r.current_version, L, cur);
  }
}
