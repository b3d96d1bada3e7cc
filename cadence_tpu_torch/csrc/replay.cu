// Kernel A: replay.
//
// Replaces the JAX package's ops/transitions.py `step` (with
// `table_insert_slot`, `table_match`, `state_transition_valid` and
// ops/state.py `reset_rows`) and the `lax.scan` loops over it in
// ops/replay.py (`replay_events`, `replay_from_state`, `replay_events32`
// with `widen_wire32`, and `replay_wirec` / `replay_wirec_from_state` with
// ops/wirec.py `decode_step` fused into the loop). Its generator reader
// (ops/genkernel.py `_fused_scan`) is its own kernel, replay_gen.cu; both
// apply an event through replay_step.cuh.
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
// Three event readers, one instantiation each: int64 lanes, wire32 lanes
// and wirec. The int64 and wire32 readers have a second instantiation,
// TASKS, which also appends each event's transfer and timer tasks to the
// task logs (taskgen.cuh; cadence_replay_tasks). The wirec reader decodes
// the thread's slab row (B bytes) under a profile passed by value
// (wirec.cuh), with each DELTA lane's running value carried in a register
// from the `bases` column the profile names; it decodes EVERY row e < E
// before the id <= 0 skip, padding rows included, because the JAX
// decode_step advances its carry on every column and masks only the output.
//
// Bound. The work per event is a few dozen integer operations and a
// K-wide scan of at most one table, so the kernel is bound by memory: the
// event lanes are read once (144 B/event as int64, 80 B as wire32, B bytes
// of slab plus the per-workflow bases and count as wirec) and the state
// (3,602 B per workflow at the default layout) is written once.
// Each thread reads its own 144-byte rows, so a warp's loads do not
// coalesce; a field-major lane and state layout is the later fix.
#include "replay_step.cuh"
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

enum Reader : int { READ_INT64 = 0, READ_WIRE32 = 1, READ_WIREC = 2 };

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


// The wirec inputs; unused by the other readers.
struct WirecArgs {
  const int64_t* bases;    // [W, K]
  const int32_t* n_events; // [W]
  int b, k;                // slab bytes per event, bases columns
};

#include "taskgen.cuh"

// TASKS: also emit each event's transfer and timer tasks into the logs `L`
// (taskgen.cuh); unused otherwise.
template <int READER, bool TASKS>
__global__ void replay_kernel(StatePtrs S, const void* __restrict__ events, int64_t W,
                              int64_t E, Caps c, WirecArgs wa,
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
  Scalars r;
  load_scalars(S, w, r);
  int64_t* vh_ids = f64(S, F_VH_EVENT_IDS) + w * c.b * c.kv;
  int64_t* vh_vers = f64(S, F_VH_VERSIONS) + w * c.b * c.kv;
  int32_t* vh_cnt = f32(S, F_VH_COUNT) + w * c.b;
  const int kv = c.kv;
  GlobalTables tables{S, w, c};

  for (int64_t e = 0; e < E; ++e) {
    if (r.error != 0) break;  // sticky: nothing later can change the row
    int64_t lane[NUM_LANES];
    if constexpr (READER == READ_WIREC)
      read_wirec(static_cast<const uint8_t*>(events) + (w * E + e) * wa.b, prof, acc,
                 e < n_real, lane);
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
    if (flags & FLAG_RUN_RESET) reset_row(S, w, c, r);
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

    apply_event(r, tables, c, etype, ev_id, ev_version, ts, batch_first, a);

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
        S, events, W, E, c, none, no_profile, L);
  else
    replay_kernel<READ_INT64, TASKS><<<blocks, REPLAY_THREADS, 0, st>>>(
        S, events, W, E, c, none, no_profile, L);
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
          S, slab, W, E, c, wa, wirec_profile_from(profile), TaskLogPtrs{});
  return static_cast<int>(cudaGetLastError());
}
