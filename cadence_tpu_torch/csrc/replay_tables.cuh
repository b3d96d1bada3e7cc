// Where kernel A's lane readers keep what an event's dependent chain reads:
// the pending tables' occupancy and lookup keys, and each branch's
// version-history count, last version and last event id.
//
// Two routes, chosen on the host from the layout before the launch
// (ops/replay.py replay_route), never after a failure:
// - the staged route, for layouts whose every table holds at most
//   CHIP_MAX_K slots: ChipTables keeps each table's occupancy as a 64-bit
//   mask in registers, loaded once from the [W, K] bytes and stored once at
//   the end; an insert takes __ffsll(~occ & slots_mask(k)), a lookup walks
//   only the set bits, and the six key columns a lookup compares (activity
//   schedule id and activity key, timer key, child initiated id,
//   request-cancel and signal initiated ids) are columns of the block's
//   shared memory, [slot][workflow], filled from the occupied slots and
//   written through on insert. ChipVersionHistory keeps each branch's count,
//   last version and last event id in registers (RegBranches, B <= 2) or in
//   shared memory (SharedBranches), written through on every append, update
//   and fork;
// - the global route (GlobalTables in replay_step.cuh, GlobalVersionHistory
//   here): every read goes to device memory, as kernel A always did, for any
//   capacity.
// Every other field an event writes is stored straight to the state at the
// JAX layout on both routes and never read back on the chain, so the state
// in device memory is the same after a launch of either route; the task
// emission (taskgen.cuh) reads the table fields from device memory and the
// occupancy through the policy (act_next / timer_next).
#pragma once

#include "replay_step.cuh"

namespace cadence {
namespace {

constexpr int CHIP_MAX_K = 64;  // slots a table's occupancy mask holds
// Workflows (threads) a staged block holds; a layout whose block needs more
// shared memory than SMEM_LIMIT (state.cuh) takes the global route.
constexpr int STAGED_WF = 32;
constexpr int REG_BRANCHES = 2;     // branches whose version history fits registers
// Warps an SM keeps resident on the staged route's wirec reader
// (__launch_bounds__ caps its registers to fit them): one wave of 40,960
// workflows on 132 SMs needs 9.7.
constexpr int STAGED_MIN_WARPS = 10;

__device__ __forceinline__ uint64_t slots_mask(int k) {
  return k >= 64 ? ~0ull : (1ull << k) - 1;
}

// Key slots a workflow's columns hold: activity schedule ids and activity
// keys, timer keys, child, request-cancel and signal initiated ids.
__host__ __device__ __forceinline__ int chip_key_slots(const Caps& c) {
  return 2 * c.ka + c.kt + c.kc + c.kr + c.ks;
}

// Shared-memory bytes a workflow takes on the staged route.
__host__ __device__ __forceinline__ int staged_bytes_per_workflow(const Caps& c) {
  return 8 * chip_key_slots(c) + (c.b > REG_BRANCHES ? 20 * c.b : 0);
}

// The pending tables with their occupancy in registers and their lookup
// keys in shared memory: key(s) is slot s of the workflow's columns, the
// activity schedule ids first, then the activity keys, the timer keys and
// the child, request-cancel and signal initiated ids.
struct ChipTables {
  // replay_kernel's __launch_bounds__ on this route (the floor of blocks for
  // the wirec reader)
  static constexpr int MAX_THREADS = STAGED_WF;
  static constexpr int MIN_BLOCKS = STAGED_MIN_WARPS * 32 / STAGED_WF;

  const StatePtrs& S;
  int64_t w;
  const Caps& c;
  int64_t* keys;
  int stride;
  uint64_t act = 0, tmr = 0, ch = 0, rc = 0, sg = 0;

  __device__ __forceinline__ ChipTables(const StatePtrs& s, int64_t w_, const Caps& c_,
                                        int64_t* smem, int lane, int stride_)
      : S(s), w(w_), c(c_), keys(smem + lane), stride(stride_) {}

  __device__ __forceinline__ int64_t& key(int s) { return keys[s * stride]; }
  __device__ __forceinline__ int col_akey() const { return c.ka; }
  __device__ __forceinline__ int col_tmr() const { return 2 * c.ka; }
  __device__ __forceinline__ int col_ch() const { return 2 * c.ka + c.kt; }
  __device__ __forceinline__ int col_rc() const { return 2 * c.ka + c.kt + c.kc; }
  __device__ __forceinline__ int col_sg() const { return 2 * c.ka + c.kt + c.kc + c.kr; }

  __device__ __forceinline__ static uint64_t load_occ(const uint8_t* occ, int k) {
    uint64_t m = 0;
    for (int i = 0; i < k; ++i)
      if (occ[i]) m |= 1ull << i;
    return m;
  }
  __device__ __forceinline__ static void store_occ(uint8_t* occ, int k, uint64_t m) {
    for (int i = 0; i < k; ++i) occ[i] = (m >> i) & 1;
  }
  // the key column `col` of the occupied slots of `m` from the [W, k] field f
  __device__ __forceinline__ void fill(uint64_t m, int col, int f, int k) {
    const int64_t* src = f64(S, f) + w * k;
    for (; m; m &= m - 1) {
      const int i = __ffsll(m) - 1;
      key(col + i) = src[i];
    }
  }

  __device__ __forceinline__ void load() {
    act = load_occ(fb(S, F_ACT_OCC) + w * c.ka, c.ka);
    tmr = load_occ(fb(S, F_TMR_OCC) + w * c.kt, c.kt);
    ch = load_occ(fb(S, F_CH_OCC) + w * c.kc, c.kc);
    rc = load_occ(fb(S, F_RC_OCC) + w * c.kr, c.kr);
    sg = load_occ(fb(S, F_SG_OCC) + w * c.ks, c.ks);
    fill(act, 0, F_ACT_SCHEDULE_ID, c.ka);
    fill(act, col_akey(), F_ACT_ACTIVITY_KEY, c.ka);
    fill(tmr, col_tmr(), F_TMR_TIMER_KEY, c.kt);
    fill(ch, col_ch(), F_CH_INITIATED_ID, c.kc);
    fill(rc, col_rc(), F_RC_INITIATED_ID, c.kr);
    fill(sg, col_sg(), F_SG_INITIATED_ID, c.ks);
  }
  __device__ __forceinline__ void store() {
    store_occ(fb(S, F_ACT_OCC) + w * c.ka, c.ka, act);
    store_occ(fb(S, F_TMR_OCC) + w * c.kt, c.kt, tmr);
    store_occ(fb(S, F_CH_OCC) + w * c.kc, c.kc, ch);
    store_occ(fb(S, F_RC_OCC) + w * c.kr, c.kr, rc);
    store_occ(fb(S, F_SG_OCC) + w * c.ks, c.ks, sg);
  }
  // FLAG_RUN_RESET: reset_row has zeroed the tables in memory
  __device__ __forceinline__ void reset() { act = tmr = ch = rc = sg = 0; }

  // the first free slot of `occ` among k, or -1
  __device__ __forceinline__ static int free_slot(uint64_t occ, int k) {
    return __ffsll(~occ & slots_mask(k)) - 1;
  }
  // the occupied slots of `occ` whose key (column `col` + slot) equals k
  __device__ __forceinline__ uint64_t matches(uint64_t occ, int col, int64_t k) {
    uint64_t hit = 0;
    for (uint64_t m = occ; m; m &= m - 1) {
      const int i = __ffsll(m) - 1;
      if (key(col + i) == k) hit |= 1ull << i;
    }
    return hit;
  }
  // the first occupied slot at or after `from`, or -1
  __device__ __forceinline__ static int next(uint64_t occ, int from) {
    const uint64_t m = from >= 64 ? 0 : occ & (~0ull << from);
    return m ? __ffsll(m) - 1 : -1;
  }
  __device__ __forceinline__ int act_next(int from) const { return next(act, from); }
  __device__ __forceinline__ int timer_next(int from) const { return next(tmr, from); }

  __device__ __forceinline__ bool act_insert(int64_t ev_id, int64_t ev_version, int64_t ts,
                                             int64_t batch_first, const int64_t* a) {
    const int slot = free_slot(act, c.ka);
    if (slot < 0) return false;
    act |= 1ull << slot;
    key(slot) = ev_id;
    key(col_akey() + slot) = a[0];
    write_activity(S, w * c.ka + slot, ev_id, ev_version, ts, batch_first, a);
    return true;
  }
  __device__ __forceinline__ bool act_start(int64_t k, int64_t ev_id, int64_t ev_version,
                                            int64_t ts) {
    const uint64_t hit = matches(act, 0, k);
    for (uint64_t m = hit; m; m &= m - 1)
      write_activity_started(S, w * c.ka + __ffsll(m) - 1, ev_id, ev_version, ts);
    return hit != 0;
  }
  __device__ __forceinline__ bool act_close(int64_t k) {
    const uint64_t hit = matches(act, 0, k);
    act &= ~hit;
    return hit != 0;
  }
  __device__ __forceinline__ void act_cancel_request(int64_t k, int64_t ev_id,
                                                     int64_t ev_version) {
    for (uint64_t m = matches(act, col_akey(), k); m; m &= m - 1)
      write_activity_cancel_requested(S, w * c.ka + __ffsll(m) - 1, ev_id, ev_version);
  }
  __device__ __forceinline__ bool timer_insert(int64_t k, int64_t ev_id, int64_t ev_version,
                                               int64_t ts, int64_t timeout_s) {
    const int slot = free_slot(tmr, c.kt);
    if (slot < 0) return false;
    tmr |= 1ull << slot;
    key(col_tmr() + slot) = k;
    write_timer(S, w * c.kt + slot, k, ev_id, ev_version, ts, timeout_s);
    return true;
  }
  __device__ __forceinline__ bool timer_close(int64_t k) {
    const uint64_t hit = matches(tmr, col_tmr(), k);
    tmr &= ~hit;
    return hit != 0;
  }
  __device__ __forceinline__ bool child_insert(int64_t ev_id, int64_t ev_version,
                                               int64_t batch_first) {
    const int slot = free_slot(ch, c.kc);
    if (slot < 0) return false;
    ch |= 1ull << slot;
    key(col_ch() + slot) = ev_id;
    write_child(S, w * c.kc + slot, ev_id, ev_version, batch_first);
    return true;
  }
  __device__ __forceinline__ bool child_start(int64_t k, int64_t ev_id) {
    const uint64_t hit = matches(ch, col_ch(), k);
    for (uint64_t m = hit; m; m &= m - 1)
      f64(S, F_CH_STARTED_ID)[w * c.kc + __ffsll(m) - 1] = ev_id;
    return hit != 0;
  }
  __device__ __forceinline__ bool child_close(int64_t k) {
    const uint64_t hit = matches(ch, col_ch(), k);
    ch &= ~hit;
    return hit != 0;
  }
  // the request-cancel and signal tables: (F_RC_OCC, c.kr) or (F_SG_OCC, c.ks)
  __device__ __forceinline__ void initiated_insert(int f_occ, int k, int64_t ev_id,
                                                   int64_t ev_version, int64_t batch_first,
                                                   int32_t& error) {
    uint64_t& occ = f_occ == F_RC_OCC ? rc : sg;
    const int slot = free_slot(occ, k);
    if (slot < 0) {
      if (error == 0) error = E_TABLE_OVERFLOW;
      return;
    }
    occ |= 1ull << slot;
    key((f_occ == F_RC_OCC ? col_rc() : col_sg()) + slot) = ev_id;
    f64(S, f_occ + 1)[w * k + slot] = ev_id;        // initiated_id
    f64(S, f_occ + 2)[w * k + slot] = ev_version;   // version
    f64(S, f_occ + 3)[w * k + slot] = batch_first;  // batch_id
  }
  __device__ __forceinline__ bool initiated_close(int f_occ, int, int64_t k) {
    uint64_t& occ = f_occ == F_RC_OCC ? rc : sg;
    const uint64_t hit = matches(occ, f_occ == F_RC_OCC ? col_rc() : col_sg(), k);
    occ &= ~hit;
    return hit != 0;
  }
};

// The version history, [B, Kv] rows a workflow, read and written through
// three numbers a branch: its count, its last version and its last event
// id, each last value read as replay_kernel always read it (0 when the
// count runs past Kv). GlobalVersionHistory reads them from device memory at
// every call; ChipVersionHistory holds them on the chip and writes device
// memory through.
struct GlobalVersionHistory {
  int64_t* ids;
  int64_t* vers;
  int32_t* cnt;
  int kv;

  __device__ __forceinline__ GlobalVersionHistory(const StatePtrs& S, int64_t w, const Caps& c,
                                                  int64_t*, int, int)
      : ids(f64(S, F_VH_EVENT_IDS) + w * c.b * c.kv),
        vers(f64(S, F_VH_VERSIONS) + w * c.b * c.kv),
        cnt(f32(S, F_VH_COUNT) + w * c.b),
        kv(c.kv) {}

  __device__ __forceinline__ int32_t count(int b) const { return cnt[b]; }
  __device__ __forceinline__ int64_t last_version(int b) const {
    const int32_t n = cnt[b];
    return n > 0 && n - 1 < kv ? vers[b * kv + n - 1] : 0;
  }
  __device__ __forceinline__ int64_t last_event(int b) const {
    const int32_t n = cnt[b];
    return n > 0 && n - 1 < kv ? ids[b * kv + n - 1] : 0;
  }
  __device__ __forceinline__ void append(int b, int32_t n, int64_t id, int64_t version) {
    ids[b * kv + n] = id;
    vers[b * kv + n] = version;
    cnt[b] = n + 1;
  }
  __device__ __forceinline__ void update_last(int b, int32_t idx, int64_t id) {
    ids[b * kv + idx] = id;
  }
  // Branch b inherits the parent p's prefix before lca (p_count > 0);
  // returns b's new count.
  __device__ __forceinline__ int32_t fork(int b, int p, int32_t p_count, int64_t lca) {
    int32_t n = 0;
    for (int k = 0; k < kv; ++k) {
      const int64_t prev = k == 0 ? 0 : ids[p * kv + k - 1];
      const bool keep = k < p_count && prev < lca;
      const int64_t pid = ids[p * kv + k];
      ids[b * kv + k] = keep ? (pid < lca ? pid : lca) : PAD;
      vers[b * kv + k] = keep ? vers[p * kv + k] : PAD;
      n += keep ? 1 : 0;
    }
    cnt[b] = n;
    return n;
  }
  __device__ __forceinline__ void reset() {}  // reset_row rewrote the rows
};

// Branches 0 and 1 in registers; a branch past them is never asked for
// (the caller clips every branch index to [0, B - 1]).
struct RegBranches {
  int32_t n0 = 0, n1 = 0;
  int64_t v0 = 0, v1 = 0, e0 = 0, e1 = 0;

  __device__ __forceinline__ RegBranches(int64_t*, int, int, int) {}
  __device__ __forceinline__ int32_t count(int b) const { return b ? n1 : n0; }
  __device__ __forceinline__ int64_t version(int b) const { return b ? v1 : v0; }
  __device__ __forceinline__ int64_t event(int b) const { return b ? e1 : e0; }
  __device__ __forceinline__ void set(int b, int32_t n, int64_t v, int64_t e) {
    if (b) {
      n1 = n, v1 = v, e1 = e;
    } else {
      n0 = n, v0 = v, e0 = e;
    }
  }
  __device__ __forceinline__ void set_event(int b, int64_t e) {
    if (b)
      e1 = e;
    else
      e0 = e;
  }
};

// Every branch in three columns of the block's shared memory, after the key
// columns: last versions and last events [B][stride] int64, counts
// [B][stride] int32.
struct SharedBranches {
  int64_t* v;
  int64_t* e;
  int32_t* n;
  int stride;

  __device__ __forceinline__ SharedBranches(int64_t* smem, int lane, int stride_, int nb)
      : v(smem + lane),
        e(smem + nb * stride_ + lane),
        n(reinterpret_cast<int32_t*>(smem + 2 * nb * stride_) + lane),
        stride(stride_) {}
  __device__ __forceinline__ int32_t count(int b) const { return n[b * stride]; }
  __device__ __forceinline__ int64_t version(int b) const { return v[b * stride]; }
  __device__ __forceinline__ int64_t event(int b) const { return e[b * stride]; }
  __device__ __forceinline__ void set(int b, int32_t cnt, int64_t ver, int64_t ev) {
    n[b * stride] = cnt, v[b * stride] = ver, e[b * stride] = ev;
  }
  __device__ __forceinline__ void set_event(int b, int64_t ev) { e[b * stride] = ev; }
};

template <class Branches>
struct ChipVersionHistory {
  int64_t* ids;
  int64_t* vers;
  int32_t* cnt;
  int kv, nb;
  Branches m;

  // smem: the block's shared memory after the key columns
  __device__ __forceinline__ ChipVersionHistory(const StatePtrs& S, int64_t w, const Caps& c,
                                                int64_t* smem, int lane, int stride)
      : ids(f64(S, F_VH_EVENT_IDS) + w * c.b * c.kv),
        vers(f64(S, F_VH_VERSIONS) + w * c.b * c.kv),
        cnt(f32(S, F_VH_COUNT) + w * c.b),
        kv(c.kv),
        nb(c.b),
        m(smem, lane, stride, c.b) {
    for (int b = 0; b < nb; ++b) reload(b, cnt[b]);
  }
  // branch b's cache from its count n and its rows in device memory
  __device__ __forceinline__ void reload(int b, int32_t n) {
    const bool last = n > 0 && n - 1 < kv;
    m.set(b, n, last ? vers[b * kv + n - 1] : 0, last ? ids[b * kv + n - 1] : 0);
  }

  __device__ __forceinline__ int32_t count(int b) const { return m.count(b); }
  __device__ __forceinline__ int64_t last_version(int b) const { return m.version(b); }
  __device__ __forceinline__ int64_t last_event(int b) const { return m.event(b); }
  __device__ __forceinline__ void append(int b, int32_t n, int64_t id, int64_t version) {
    ids[b * kv + n] = id;
    vers[b * kv + n] = version;
    cnt[b] = n + 1;
    m.set(b, n + 1, version, id);
  }
  __device__ __forceinline__ void update_last(int b, int32_t idx, int64_t id) {
    ids[b * kv + idx] = id;
    m.set_event(b, id);
  }
  // The fork reads the parent's rows from device memory (it is rare), and
  // b's new last entry back from what it wrote.
  __device__ __forceinline__ int32_t fork(int b, int p, int32_t p_count, int64_t lca) {
    int32_t n = 0;
    for (int k = 0; k < kv; ++k) {
      const int64_t prev = k == 0 ? 0 : ids[p * kv + k - 1];
      const bool keep = k < p_count && prev < lca;
      const int64_t pid = ids[p * kv + k];
      ids[b * kv + k] = keep ? (pid < lca ? pid : lca) : PAD;
      vers[b * kv + k] = keep ? vers[p * kv + k] : PAD;
      n += keep ? 1 : 0;
    }
    cnt[b] = n;
    reload(b, n);
    return n;
  }
  // FLAG_RUN_RESET: reset_row zeroed every count in memory
  __device__ __forceinline__ void reset() {
    for (int b = 0; b < nb; ++b) m.set(b, 0, 0, 0);
  }
};

}  // namespace
}  // namespace cadence
