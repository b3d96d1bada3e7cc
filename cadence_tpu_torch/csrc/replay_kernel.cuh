// Kernel A: replay (the kernel and its launch; the C entry points are in
// replay.cu, replay_tasks.cu and replay_global.cu, one nvcc each).
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
// updates its ReplayState row in place, so a fresh replay and a replay from
// a carried state are the same launch. Where the JAX step blends every event
// type's update under masks, the thread takes a real `switch` on the event
// type. The scalars live in registers for the whole loop. What the event's
// dependent chain reads is placed by the route (replay_tables.cuh), which
// the host picks from the layout before the launch:
// - the staged route (cadence_replay, cadence_replay_tasks,
//   cadence_replay_wirec), for every table capacity at most CHIP_MAX_K:
//   each table's occupancy a 64-bit mask in registers, the lookup keys in
//   shared memory, each branch's version-history count, last version and
//   last event id on the chip; the int64 and wire32 readers load the next
//   event's lanes into registers before applying the current one, so the
//   lane loads leave the chain (PREFETCH_LANES). A block holds STAGED_WF
//   workflows, one warp, so a chunk of 4,096 spreads over 128 SMs. The
//   wirec reader, whose decode carries 18 lanes, is held by __launch_bounds__
//   to the registers of STAGED_MIN_WARPS warps an SM (one wave at 40,960
//   workflows); the other readers fit them unbounded, and run faster so;
// - the global route (the *_global entry points), for any capacity: the
//   tables and version histories in device memory, every lookup a walk of
//   the K occupancy bytes, as kernel A was first written.
// Both write every field to the state at the JAX [W, K] / [W, B, Kv] layout,
// so the state after a launch is the same. Capacities (K, B, Kv) come at run
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
//   histories, current_branch), and on the staged route the masks, key
//   columns and cached version histories with it, but keeps the error code;
// - int64 sums wrap (done in uint64_t; signed overflow is undefined).
//
// Three event readers, one instantiation each on each route: int64 lanes,
// wire32 lanes and wirec. The int64 and wire32 readers have a second,
// TASKS, which also appends each event's transfer and timer tasks to the
// task logs (taskgen.cuh; cadence_replay_tasks). The wirec reader decodes
// the thread's slab row (B bytes) under a profile passed by value
// (wirec.cuh), with each DELTA lane's running value carried in a register
// from the `bases` column the profile names; it decodes EVERY row e < E
// before the id <= 0 skip, padding rows included, because the JAX
// decode_step advances its carry on every column and masks only the output.
//
// Bound. The work per event is a few dozen integer operations and a
// walk of at most one table, so the kernel is bound by memory: the event
// lanes are read once (144 B/event as int64, 80 B as wire32, B bytes of
// slab plus the per-workflow bases and count as wirec) and the state (3,602
// B per workflow at the default layout) is written once. Each thread reads
// its own 144-byte rows, so a warp's loads do not coalesce; on the staged
// route they are issued an event ahead, off the chain.
#pragma once

#include <type_traits>

#include "replay_tables.cuh"

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

// Whether the dense readers load event e + 1's lanes before applying event
// e (chip_smoke.py times the kernel without it).
constexpr bool PREFETCH_LANES = true;

// One event's lanes as the dense readers load them: 18 int64 lanes, or 20
// int32 wire32 lanes widened by widen().
template <int READER>
struct RawEvent {
  static constexpr int N = READER == READ_WIRE32 ? NUM_LANES32 : NUM_LANES;
  using T = typename std::conditional<READER == READ_WIRE32, int32_t, int64_t>::type;
  T v[N];

  __device__ __forceinline__ void load(const void* events, int64_t row) {
    const T* ev = static_cast<const T*>(events) + row * N;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ev[i];
  }
  __device__ __forceinline__ void widen(int64_t* lane) const {
#pragma unroll
    for (int i = 0; i < NUM_LANES; ++i) lane[i] = v[i];
    if constexpr (READER == READ_WIRE32) {
      lane[LANE_TIMESTAMP] = static_cast<int64_t>(
          (static_cast<uint64_t>(static_cast<uint32_t>(v[LANE32_TS_HI])) << 32) |
          static_cast<uint32_t>(v[LANE_TIMESTAMP]));
      lane[LANE_A0 + 4] = static_cast<int64_t>(
          (static_cast<uint64_t>(static_cast<uint32_t>(v[LANE32_A4_HI])) << 32) |
          static_cast<uint32_t>(v[LANE_A0 + 4]));
    }
  }
};

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
// (taskgen.cuh); unused otherwise. Tables and VH are the route's policies
// (replay_tables.cuh): ChipTables with ChipVersionHistory<RegBranches or
// SharedBranches> on the staged route, GlobalTables with
// GlobalVersionHistory on the global route. The block's dynamic shared
// memory holds the staged route's key columns, [slot][blockDim.x], then its
// shared version histories.
template <int READER, bool TASKS, class Tables, class VH>
__global__ void __launch_bounds__(Tables::MAX_THREADS,
                                  READER == READ_WIREC ? Tables::MIN_BLOCKS : 1)
    replay_kernel(StatePtrs S, const void* __restrict__ events, int64_t W,
                              int64_t E, Caps c, WirecArgs wa,
                              const __grid_constant__ WirecProfile prof, TaskLogPtrs L) {
  extern __shared__ int64_t replay_smem[];
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
  const int kv = c.kv;
  Tables tables(S, w, c, replay_smem, threadIdx.x, blockDim.x);
  tables.load();
  VH vh(S, w, c, replay_smem + chip_key_slots(c) * blockDim.x, threadIdx.x, blockDim.x);
  constexpr bool prefetch = PREFETCH_LANES && READER != READ_WIREC;
  RawEvent<READER == READ_WIREC ? READ_INT64 : READER> next;
  if constexpr (prefetch)
    if (E > 0 && r.error == 0) next.load(events, w * E);

  for (int64_t e = 0; e < E; ++e) {
    if (r.error != 0) break;  // sticky: nothing later can change the row
    int64_t lane[NUM_LANES];
    if constexpr (READER == READ_WIREC) {
      read_wirec(static_cast<const uint8_t*>(events) + (w * E + e) * wa.b, prof, acc,
                 e < n_real, lane);
    } else if constexpr (prefetch) {
      const auto now = next;
      if (e + 1 < E) next.load(events, w * E + e + 1);
      now.widen(lane);
    } else {
      next.load(events, w * E + e);
      next.widen(lane);
    }
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
    if (flags & FLAG_RUN_RESET) {
      reset_row(S, w, c, r);
      tables.reset();
      vh.reset();
    }
    const bool vh_only = (flags & FLAG_VH_ONLY) != 0;

    // 1. per-branch version history with fork-inherit
    if (branch >= c.b) {
      r.error = E_BRANCH_OVERFLOW;
      continue;
    }
    const int b = branch < 0 ? 0 : branch;
    const int p = parent < 0 ? 0 : (parent > c.b - 1 ? c.b - 1 : parent);
    int32_t b_count = vh.count(b);
    const int32_t p_count = vh.count(p);

    // the current branch's last version, before this step
    const int cb = r.current_branch < 0 ? 0
                   : (r.current_branch > c.b - 1 ? c.b - 1 : r.current_branch);
    const int64_t cur_last_version = vh.count(cb) > 0 ? vh.last_version(cb) : EMPTY_VERSION;

    if (b_count == 0 && p != b) {  // fork-inherit the parent's prefix
      const int64_t lca = ev_id - 1;
      if (p_count == 0 || lca < 1) {
        r.error = E_BAD_FORK;
        continue;
      }
      b_count = vh.fork(b, p, p_count, lca);
    }

    const bool has_items = b_count > 0;
    const int32_t last_idx = b_count - 1 > 0 ? b_count - 1 : 0;
    const int64_t vh_last_version = has_items ? vh.last_version(b) : EMPTY_VERSION;
    const int64_t vh_last_event = has_items ? vh.last_event(b) : EMPTY_EVENT_ID;

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
    if (append_ok) vh.append(b, b_count, ev_id, ev_version);
    if (update_last && last_idx < kv) vh.update_last(b, last_idx, ev_id);

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
        step_tasks(S, w, c, r, tables, L, cur, ev_id, etype, ev_version, ts, batch_last, a[0],
                   a[2], a[3], a[7]);
    }
  }
  tables.store();
  store_scalars(S, w, r);
  if constexpr (TASKS) {
    L.tr_count[w] = cur.tr;
    L.tm_count[w] = cur.tm;
    L.overflow[w] = cur.overflow ? 1 : 0;
  }
}

using StagedReg = ChipVersionHistory<RegBranches>;
using StagedShared = ChipVersionHistory<SharedBranches>;

}  // namespace
}  // namespace cadence

namespace {

inline cadence::StatePtrs state_from(const void* ptr_table) {
  cadence::StatePtrs S;
  const uint64_t* table = static_cast<const uint64_t*>(ptr_table);
  for (int i = 0; i < cadence::NUM_FIELDS; ++i) S.p[i] = reinterpret_cast<void*>(table[i]);
  return S;
}

constexpr int REPLAY_THREADS = cadence::GlobalTables::MAX_THREADS;  // the global route's block

// The staged route's block width for these capacities (ops/replay.py
// staged_block mirrors it): STAGED_WF, or 0 when a table holds more than
// CHIP_MAX_K slots or the block needs more than SMEM_LIMIT bytes of shared
// memory (the global route's layouts).
inline int staged_block(const cadence::Caps& c) {
  using namespace cadence;
  if (c.ka > CHIP_MAX_K || c.kt > CHIP_MAX_K || c.kc > CHIP_MAX_K || c.kr > CHIP_MAX_K ||
      c.ks > CHIP_MAX_K)
    return 0;
  return int64_t(STAGED_WF) * staged_bytes_per_workflow(c) <= SMEM_LIMIT ? STAGED_WF : 0;
}

// Launch replay_kernel<READER, TASKS, ...> on the route: staged (the layout
// must have a staged block) or GLOBAL.
template <int READER, bool TASKS, bool GLOBAL>
int launch_route(const cadence::StatePtrs& S, const void* events, int64_t W, int64_t E,
                 const cadence::Caps& c, const cadence::WirecArgs& wa,
                 const cadence::WirecProfile& prof, const cadence::TaskLogPtrs& L,
                 void* stream) {
  using namespace cadence;
  if (W <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (GLOBAL) {
    const unsigned blocks = static_cast<unsigned>((W + REPLAY_THREADS - 1) / REPLAY_THREADS);
    replay_kernel<READER, TASKS, GlobalTables, GlobalVersionHistory>
        <<<blocks, REPLAY_THREADS, 0, st>>>(S, events, W, E, c, wa, prof, L);
    return static_cast<int>(cudaGetLastError());
  } else {
    const int nw = staged_block(c);
    if (nw == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = nw * staged_bytes_per_workflow(c);
    const unsigned blocks = static_cast<unsigned>((W + nw - 1) / nw);
    auto kernel = c.b > REG_BRANCHES ? replay_kernel<READER, TASKS, ChipTables, StagedShared>
                                     : replay_kernel<READER, TASKS, ChipTables, StagedReg>;
    if (smem > 48 * 1024) {
      const cudaError_t rc =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    kernel<<<blocks, nw, smem, st>>>(S, events, W, E, c, wa, prof, L);
    return static_cast<int>(cudaGetLastError());
  }
}

// The dense readers' launch, without or with tasks.
template <bool TASKS, bool GLOBAL>
int launch_dense(const void* ptr_table, const void* events, int64_t W, int64_t E, int wire32,
                 const int* caps, int b, int kv, const cadence::TaskLogPtrs& L, void* stream) {
  using namespace cadence;
  const StatePtrs S = state_from(ptr_table);
  const Caps c{caps[0], caps[1], caps[2], caps[3], caps[4], b, kv};
  const WirecArgs none{nullptr, nullptr, 0, 0};
  const WirecProfile no_profile{};
  return wire32 ? launch_route<READ_WIRE32, TASKS, GLOBAL>(S, events, W, E, c, none,
                                                           no_profile, L, stream)
                : launch_route<READ_INT64, TASKS, GLOBAL>(S, events, W, E, c, none,
                                                          no_profile, L, stream);
}

// The 12 task-log pointers (ops/taskgen.py TaskLog order) and capacities.
inline cadence::TaskLogPtrs task_logs(const void* log_table, int64_t tt, int64_t tm,
                                      int64_t retention) {
  const uint64_t* p = static_cast<const uint64_t*>(log_table);
  auto i64 = [&](int i) { return reinterpret_cast<int64_t*>(p[i]); };
  return cadence::TaskLogPtrs{i64(0), i64(1), i64(2), i64(3), i64(4), i64(5),
                              i64(6), i64(7), i64(8), i64(9), i64(10),
                              reinterpret_cast<uint8_t*>(p[11]), tt, tm, retention};
}

template <bool GLOBAL>
int launch_wirec(const void* ptr_table, const void* slab, const void* bases,
                 const void* n_events, int64_t W, int64_t E, int B, int K,
                 const int64_t* profile, const int* caps, int b, int kv, void* stream) {
  using namespace cadence;
  const Caps c{caps[0], caps[1], caps[2], caps[3], caps[4], b, kv};
  const WirecArgs wa{static_cast<const int64_t*>(bases), static_cast<const int32_t*>(n_events),
                     B, K};
  return launch_route<READ_WIREC, false, GLOBAL>(state_from(ptr_table), slab, W, E, c, wa,
                                                 wirec_profile_from(profile), TaskLogPtrs{},
                                                 stream);
}

}  // namespace
