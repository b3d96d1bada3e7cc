// One workflow's stepping thread in kernel A's generator reader
// (replay_gen.cu): the generator step (genkernel.cuh `choose` and `act`)
// fused with the replay step (replay_step.cuh), with everything its
// dependent chain reads held on the chip.
//
// What the chain reads, and where it lives for the whole launch:
// - the scalars and the GenState: registers (as before);
// - the activity, timer and child occupancy: one bitmask a table in
//   registers (K <= 64), loaded once and stored once as the [W, K] bytes;
//   an insert takes the first free slot, __ffsll(~occ), and a lookup walks
//   only the occupied slots (the generator keeps at most 4, 3 and 2 open);
// - the keys those lookups compare (activity schedule id, timer key, child
//   initiated id): a column of the block's shared memory, [slot][workflow],
//   filled once from the occupied slots and written through on insert;
// - branch 0's version-history count, last version and last event id (the
//   generator's events all carry branch 0, parent 0 and version 0), and the
//   current branch's count and last version when that is another branch
//   (which no generated event writes): registers. The last event id is
//   written back when an append moves past it and at the end.
// Every other field an event writes is stored straight to the state at the
// JAX layout, as kernel A stores it, and never read back on the chain.
//
// Semantics: exactly ops/genkernel.py `_fused_scan` on ANY input state (the
// tables may hold slots the generator never made, the version history may
// be full or its current branch another): the version-history block below
// is replay_kernel's with branch = parent = 0, version 0, flags 0; each
// generator action's update is genkernel.cuh's `act` and its event's
// effect replay_step.cuh's `on_*` for the action's event type.
#pragma once

#include "genkernel.cuh"
#include "replay_tables.cuh"

namespace cadence {
namespace {

constexpr int GEN_MAX_K = 64;  // slots a table's occupancy bitmask holds

// The activity, timer and child tables with their occupancy in registers and
// their lookup keys in shared memory (`keys[s * stride]` is slot s, the
// activity slots first, then the timer slots, then the child slots): the
// operations replay_step.cuh's on_* functions call for the generator's
// event types. The request-cancel and signal tables, which generated events
// never touch, stay in device memory untouched.
struct GenTables {
  const StatePtrs& S;
  int64_t w;
  const Caps& c;
  int64_t* keys;
  int stride;
  uint64_t act, tmr, ch;

  __device__ __forceinline__ int64_t& key(int s) { return keys[s * stride]; }

  __device__ __forceinline__ static uint64_t load_occ(const uint8_t* occ, int k) {
    uint64_t m = 0;
    for (int i = 0; i < k; ++i)
      if (occ[i]) m |= 1ull << i;
    return m;
  }
  __device__ __forceinline__ static void store_occ(uint8_t* occ, int k, uint64_t m) {
    for (int i = 0; i < k; ++i) occ[i] = (m >> i) & 1;
  }

  __device__ __forceinline__ void load() {
    act = load_occ(fb(S, F_ACT_OCC) + w * c.ka, c.ka);
    tmr = load_occ(fb(S, F_TMR_OCC) + w * c.kt, c.kt);
    ch = load_occ(fb(S, F_CH_OCC) + w * c.kc, c.kc);
    for (uint64_t m = act; m; m &= m - 1) {
      const int i = __ffsll(m) - 1;
      key(i) = f64(S, F_ACT_SCHEDULE_ID)[w * c.ka + i];
    }
    for (uint64_t m = tmr; m; m &= m - 1) {
      const int i = __ffsll(m) - 1;
      key(c.ka + i) = f64(S, F_TMR_TIMER_KEY)[w * c.kt + i];
    }
    for (uint64_t m = ch; m; m &= m - 1) {
      const int i = __ffsll(m) - 1;
      key(c.ka + c.kt + i) = f64(S, F_CH_INITIATED_ID)[w * c.kc + i];
    }
  }
  __device__ __forceinline__ void store() {
    store_occ(fb(S, F_ACT_OCC) + w * c.ka, c.ka, act);
    store_occ(fb(S, F_TMR_OCC) + w * c.kt, c.kt, tmr);
    store_occ(fb(S, F_CH_OCC) + w * c.kc, c.kc, ch);
  }

  // the first free slot of `occ` among k, or -1
  __device__ __forceinline__ static int free_slot(uint64_t occ, int k) {
    return __ffsll(~occ & slots_mask(k)) - 1;
  }

  __device__ __forceinline__ bool act_insert(int64_t ev_id, int64_t ev_version, int64_t ts,
                                             int64_t batch_first, const int64_t* a) {
    const int slot = free_slot(act, c.ka);
    if (slot < 0) return false;
    act |= 1ull << slot;
    key(slot) = ev_id;
    write_activity(S, w * c.ka + slot, ev_id, ev_version, ts, batch_first, a);
    return true;
  }
  __device__ __forceinline__ bool act_start(int64_t k, int64_t ev_id, int64_t ev_version,
                                            int64_t ts) {
    bool found = false;
    for (uint64_t m = act; m; m &= m - 1) {
      const int i = __ffsll(m) - 1;
      if (key(i) == k) {
        found = true;
        write_activity_started(S, w * c.ka + i, ev_id, ev_version, ts);
      }
    }
    return found;
  }
  __device__ __forceinline__ bool act_close(int64_t k) {
    const uint64_t hit = matches(act, 0, k);
    act &= ~hit;
    return hit != 0;
  }
  __device__ __forceinline__ bool timer_insert(int64_t k, int64_t ev_id, int64_t ev_version,
                                               int64_t ts, int64_t timeout_s) {
    const int slot = free_slot(tmr, c.kt);
    if (slot < 0) return false;
    tmr |= 1ull << slot;
    key(c.ka + slot) = k;
    write_timer(S, w * c.kt + slot, k, ev_id, ev_version, ts, timeout_s);
    return true;
  }
  __device__ __forceinline__ bool timer_close(int64_t k) {
    const uint64_t hit = matches(tmr, c.ka, k);
    tmr &= ~hit;
    return hit != 0;
  }
  __device__ __forceinline__ bool child_insert(int64_t ev_id, int64_t ev_version,
                                               int64_t batch_first) {
    const int slot = free_slot(ch, c.kc);
    if (slot < 0) return false;
    ch |= 1ull << slot;
    key(c.ka + c.kt + slot) = ev_id;
    write_child(S, w * c.kc + slot, ev_id, ev_version, batch_first);
    return true;
  }
  __device__ __forceinline__ bool child_start(int64_t k, int64_t ev_id) {
    const uint64_t hit = matches(ch, c.ka + c.kt, k);
    for (uint64_t m = hit; m; m &= m - 1)
      f64(S, F_CH_STARTED_ID)[w * c.kc + __ffsll(m) - 1] = ev_id;
    return hit != 0;
  }
  __device__ __forceinline__ bool child_close(int64_t k) {
    const uint64_t hit = matches(ch, c.ka + c.kt, k);
    ch &= ~hit;
    return hit != 0;
  }

  // the occupied slots of `occ` whose key (column base + slot) equals k
  __device__ __forceinline__ uint64_t matches(uint64_t occ, int base, int64_t k) {
    uint64_t hit = 0;
    for (uint64_t m = occ; m; m &= m - 1) {
      const int i = __ffsll(m) - 1;
      if (key(base + i) == k) hit |= 1ull << i;
    }
    return hit;
  }
};

// Branch 0's version history in registers, and the current branch's when it
// is another (read only: generated events write branch 0 alone). count0,
// last_version0 and last_event0 are what replay_kernel reads from memory:
// 0 for a last index past Kv.
struct GenVersionHistory {
  int32_t count0, count_c;
  int64_t last_version0, last_event0, last_version_c;
  bool dirty;  // last_event0 is not yet in memory

  __device__ __forceinline__ void load(const StatePtrs& S, int64_t w, const Caps& c,
                                       int32_t current_branch) {
    const int kv = c.kv;
    const int64_t* ids = f64(S, F_VH_EVENT_IDS) + w * c.b * kv;
    const int64_t* vers = f64(S, F_VH_VERSIONS) + w * c.b * kv;
    const int32_t* cnt = f32(S, F_VH_COUNT) + w * c.b;
    count0 = cnt[0];
    const int32_t last = count0 - 1 > 0 ? count0 - 1 : 0;
    last_version0 = last < kv ? vers[last] : 0;
    last_event0 = last < kv ? ids[last] : 0;
    const int cb = current_branch < 0 ? 0 : (current_branch > c.b - 1 ? c.b - 1 : current_branch);
    count_c = cnt[cb];
    last_version_c = count_c > 0 && count_c - 1 < kv ? vers[cb * kv + count_c - 1] : 0;
    dirty = false;
  }
  __device__ __forceinline__ void flush(const StatePtrs& S, int64_t w, const Caps& c) {
    if (dirty) f64(S, F_VH_EVENT_IDS)[w * c.b * c.kv + count0 - 1] = last_event0;
    dirty = false;
  }
};

struct GenStepper {
  Scalars r;
  gen::GenState g;
  GenVersionHistory vh;
  int64_t w;        // row in the state
  int64_t started;  // 600 + die(r2, 6600) of step 0

  // Load row w (global workflow index gw) and fill the key column `t`.
  __device__ __forceinline__ void load(const StatePtrs& S, const Caps& c, GenTables& t,
                                       int64_t row, int64_t seed, int64_t gw) {
    w = row;
    load_scalars(S, w, r);
    gen::init(g, seed, gw);
    started = 600 + gen::die(gen::mix(seed, gw, 0, 3), 6600);
    vh.load(S, w, c, r.current_branch);
    t.load();
  }

  // One generated event of scan step e (of E) with that step's draws `word`;
  // the caller stops once r.error is set. The generator's action (code)
  // picks the event type, so one switch applies both the generator's update
  // (genkernel.cuh act_all, the action a constant in each case) and the
  // replay's (replay_step.cuh on_*). act_all once before the switch, at the
  // step's action, was 12% slower at 16,384 workflows and 2% at 131,072 on
  // the H100 (chip_smoke.py --variants, gen_act_all_once; PERF.md).
  __device__ __forceinline__ void step(const StatePtrs& S, const Caps& c, GenTables& t,
                                       int64_t e, int64_t E, uint64_t word) {
    const gen::PackedDice d{word, started};
    const int code = gen::choose(g, d, e, E);
    const int64_t ev_id = e + 1;
    const int64_t ts = gen::next_ts(g, d);
    constexpr int64_t ev_version = 0;  // version, branch, parent and flags are 0
    const int64_t batch_first = ev_id;  // one event a batch

    // 1. version history: branch 0, parent 0, so never a fork
    const int cb = r.current_branch < 0 ? 0
                   : (r.current_branch > c.b - 1 ? c.b - 1 : r.current_branch);
    int32_t cur_count;
    int64_t cur_last;
    if (cb == 0) {
      cur_count = vh.count0;
      cur_last = vh.last_version0;
    } else {
      cur_count = vh.count_c;
      cur_last = vh.last_version_c;
    }
    const int64_t cur_last_version = cur_count > 0 ? cur_last : EMPTY_VERSION;
    const int32_t b_count = vh.count0;
    const bool has_items = b_count > 0;
    const int32_t last_idx = b_count - 1 > 0 ? b_count - 1 : 0;
    const int64_t vh_last_version = has_items ? vh.last_version0 : EMPTY_VERSION;
    const int64_t vh_last_event = has_items ? vh.last_event0 : EMPTY_EVENT_ID;
    const bool vh_order_bad =
        has_items && (ev_version < vh_last_version || ev_id <= vh_last_event);
    if (vh_order_bad) r.error = E_VERSION_HISTORY_ORDER;
    const bool vh_ok = !vh_order_bad;
    const bool append = vh_ok && (!has_items || ev_version > vh_last_version);
    const bool vh_overflow = append && b_count >= c.kv;
    if (vh_overflow && r.error == 0) r.error = E_VERSION_HISTORY_OVERFLOW;
    if (append && !vh_overflow) {
      vh.flush(S, w, c);
      const int64_t i = w * c.b * c.kv + b_count;
      f64(S, F_VH_EVENT_IDS)[i] = ev_id;
      f64(S, F_VH_VERSIONS)[i] = ev_version;
      f32(S, F_VH_COUNT)[w * c.b] = b_count + 1;
      vh.count0 = b_count + 1;
      vh.last_version0 = ev_version;
      vh.last_event0 = ev_id;
    }
    if (vh_ok && has_items && ev_version == vh_last_version && last_idx < c.kv) {
      vh.last_event0 = ev_id;
      vh.dirty = true;
    }

    // 2. current-branch arbitration and the current version
    const bool ok = vh_ok && !vh_overflow;
    if (ok && r.current_branch != 0 && ev_version > cur_last_version) r.current_branch = 0;
    r.current_version = r.state == WS_COMPLETED ? cur_last_version : ev_version;
    if (!ok) return;  // the error stops the loop: the generator's state no longer matters
    r.last_event_task_id = ev_id + 1000;

    // 3. the action: the generator's update and the event's effect
    int64_t a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    switch (code) {
      case gen::A_STARTED:
        gen::act_all(g, d, ev_id, gen::A_STARTED, a);
        on_workflow_started(r, ev_id, ts, a);
        break;
      case gen::A_DSCHED:
        gen::act_all(g, d, ev_id, gen::A_DSCHED, a);
        on_decision_scheduled(r, ev_id, ev_version, ts, a);
        break;
      case gen::A_DSTART:
        gen::act_all(g, d, ev_id, gen::A_DSTART, a);
        on_decision_started(r, ev_id, ev_version, ts, a);
        break;
      case gen::A_DCOMPLETE:
        gen::act_all(g, d, ev_id, gen::A_DCOMPLETE, a);
        on_decision_completed(r, a);
        break;
      case gen::A_ASCHED:
        gen::act_all(g, d, ev_id, gen::A_ASCHED, a);
        on_activity_scheduled(r, t, ev_id, ev_version, ts, batch_first, a);
        break;
      case gen::A_ASTART:
        gen::act_all(g, d, ev_id, gen::A_ASTART, a);
        on_activity_started(r, t, ev_id, ev_version, ts, a);
        break;
      case gen::A_ACLOSE:
        gen::act_all(g, d, ev_id, gen::A_ACLOSE, a);
        on_activity_closed(r, t, a);
        break;
      case gen::A_TSTART:
        gen::act_all(g, d, ev_id, gen::A_TSTART, a);
        on_timer_started(r, t, ev_id, ev_version, ts, a);
        break;
      case gen::A_TFIRE:
        gen::act_all(g, d, ev_id, gen::A_TFIRE, a);
        on_timer_closed(r, t, a);
        break;
      case gen::A_CINIT:
        gen::act_all(g, d, ev_id, gen::A_CINIT, a);
        on_child_initiated(r, t, ev_id, ev_version, batch_first);
        break;
      case gen::A_CSTART:
        gen::act_all(g, d, ev_id, gen::A_CSTART, a);
        on_child_started(r, t, ev_id, a);
        break;
      case gen::A_CCLOSE:
        gen::act_all(g, d, ev_id, gen::A_CCLOSE, a);
        on_child_closed(r, t, a);
        break;
      case gen::A_SIGNAL:
        on_signaled(r);
        break;
      default:  // A_WFCLOSE: WorkflowExecutionCompleted
        on_workflow_closed(r, CS_COMPLETED, batch_first);
        break;
    }
    g.ts = ts;

    // 4. batch end: every generated event is its own batch
    if (r.error == 0) {
      r.last_first_event_id = batch_first;
      r.next_event_id = wrap_add(ev_id, 1);
    }
  }

  __device__ __forceinline__ void store(const StatePtrs& S, const Caps& c, GenTables& t) {
    vh.flush(S, w, c);
    t.store();
    store_scalars(S, w, r);
  }
};

}  // namespace
}  // namespace cadence
