// The device generator's step, shared by kernel I (genkernel.cu,
// cadence_gen_lanes) and kernel A's generator reader (replay_gen.cu).
//
// Replaces the JAX package's ops/genkernel.py `gen_step` with `_mix`,
// `_die`, `_first` and `init_gen_state`: a per-workflow workflow simulator
// on a counter-based splitmix64 stream, reproducible from (seed, workflow
// index, step), that emits one engine-shaped event per workflow per step.
//
// Design. One thread per workflow holds its GenState in registers: the
// occupancy and started flags of the 4 activity, 3 timer and 2 child
// slots are bitmasks, and the slot tables are small arrays indexed only
// through unrolled selects, so they stay in registers. A step is `choose`
// (the action, from the state and the step's draws) and `act<action>` (the
// state's update and the event's attribute lanes). Kernel I runs them in
// `step`, which fills the 18 lanes it writes; kernel A's generator reader
// runs them beside each action's replay update, so no event byte exists in
// memory. The draws (`Dice`) are the four counter hashes and the modulos
// of them: made inside the step for kernel I (LazyDice), made ahead by the
// block and packed in one word for kernel A (pack_dice, PackedDice).
//
// Where this must match the JAX package bit for bit:
// - `mix`: adds and multiplies wrap in int64 (done in uint64_t: signed
//   overflow is undefined), and its three shifts are ARITHMETIC shifts of
//   the signed value, as jnp.int64 >> is: not textbook splitmix64's logical
//   shift;
// - `die(r, n) = abs(r) % n` with jnp's floor modulo: abs(INT64_MIN) wraps
//   to INT64_MIN, whose remainder takes the divisor's sign
//   (die(INT64_MIN, 5000) == 4192, where C's signed % gives -808);
// - the first occupied (or free) slot is the lowest index, as argmax of
//   the mask is, and an empty mask selects nothing;
// - the action is chosen as the two-level jnp.select chooses it (the first
//   matching condition wins), then the step 0 and step 1 overrides;
// - the drain test reads the PRE-step occupancy counts;
// - act_count and tmr_count are incremented before they are written out.
#pragma once

#include <cstdint>

namespace cadence {
namespace gen {

constexpr int64_t NANOS_MS = 1000000LL;
constexpr int GEN_LANES = 18;

// action codes (ops/genkernel.py)
enum : int {
  A_STARTED = 0, A_DSCHED = 1, A_DSTART = 2, A_DCOMPLETE = 3,
  A_ASCHED = 4, A_ASTART = 5, A_ACLOSE = 6,
  A_TSTART = 7, A_TFIRE = 8,
  A_CINIT = 9, A_CSTART = 10, A_CCLOSE = 11,
  A_SIGNAL = 12, A_WFCLOSE = 13,
};

// _CODE_TO_TYPE: each action's EventType (core/enums.py)
__device__ __forceinline__ int64_t code_to_type(int code) {
  switch (code) {
    case A_STARTED: return 0;    // WorkflowExecutionStarted
    case A_DSCHED: return 4;     // DecisionTaskScheduled
    case A_DSTART: return 5;     // DecisionTaskStarted
    case A_DCOMPLETE: return 6;  // DecisionTaskCompleted
    case A_ASCHED: return 9;     // ActivityTaskScheduled
    case A_ASTART: return 10;    // ActivityTaskStarted
    case A_ACLOSE: return 11;    // ActivityTaskCompleted
    case A_TSTART: return 17;    // TimerStarted
    case A_TFIRE: return 18;     // TimerFired
    case A_CINIT: return 30;     // StartChildWorkflowExecutionInitiated
    case A_CSTART: return 32;    // ChildWorkflowExecutionStarted
    case A_CCLOSE: return 33;    // ChildWorkflowExecutionCompleted
    case A_SIGNAL: return 27;    // WorkflowExecutionSignaled
    default: return 1;           // WorkflowExecutionCompleted
  }
}

__device__ __forceinline__ uint64_t u(int64_t x) { return static_cast<uint64_t>(x); }

// splitmix64-style counter hash; int64 wraparound is the ring
__device__ __forceinline__ int64_t mix(int64_t seed, int64_t w, int64_t step, int64_t salt) {
  int64_t z = static_cast<int64_t>(u(seed) + u(w) * u(-7046029254386353131LL) +
                                   u(step) * u(6364136223846793005LL) +
                                   u(salt) * u(1442695040888963407LL));
  z = static_cast<int64_t>(u(z ^ (z >> 30)) * u(-4658895280553007687LL));
  z = static_cast<int64_t>(u(z ^ (z >> 27)) * u(-7723592293110705685LL));
  return z ^ (z >> 31);
}

// jnp.abs(r) % n, n > 0: |r| as uint64 (INT64_MIN's is 2^63) and an
// unsigned remainder; abs(INT64_MIN) wraps to INT64_MIN in jnp, whose floor
// modulo is n - 2^63 % n (0 when n divides 2^63)
__device__ __forceinline__ int64_t die(int64_t r, int64_t n) {
  const uint64_t a = r < 0 ? 0ULL - u(r) : u(r);
  const int64_t m = static_cast<int64_t>(a % u(n));
  return r == INT64_MIN && m != 0 ? n - m : m;
}

// the lowest set bit of `mask`, or -1
__device__ __forceinline__ int first_bit(uint32_t mask) { return __ffs(mask) - 1; }

template <int K>
__device__ __forceinline__ int64_t pick(const int64_t (&v)[K], int i) {
  int64_t out = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k == i) out = v[k];
  return out;
}

template <int K>
__device__ __forceinline__ void put(int64_t (&v)[K], int i, int64_t x) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k == i) v[k] = x;
}

constexpr uint32_t ACT_ALL = 0xFu, TMR_ALL = 0x7u, CH_ALL = 0x3u;

// GenState (ops/genkernel.py) of one workflow, the [W, K] bool fields as
// bitmasks
struct GenState {
  int64_t ts, dsched, dstart, act_count, tmr_count;
  int64_t act_sched[4], tmr_key[3], ch_init[2];
  int32_t phase;
  uint32_t act_occ, act_started, tmr_occ, ch_occ, ch_started;
};

// init_gen_state for global workflow index w
__device__ __forceinline__ void init(GenState& g, int64_t seed, int64_t w) {
  const int64_t jitter = die(mix(seed, w, 0, 17), 1000000);
  g.ts = static_cast<int64_t>(u(1700000000000000000LL) + u(jitter * NANOS_MS));
  g.dsched = g.dstart = g.act_count = g.tmr_count = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) g.act_sched[k] = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) g.tmr_key[k] = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) g.ch_init[k] = 0;
  g.phase = 0;
  g.act_occ = g.act_started = g.tmr_occ = g.ch_occ = g.ch_started = 0;
}

// The generator's draws for one (workflow, step): the four counter hashes
// (salts 1-4) and the values `step` takes from them. Kernel I hashes inside
// its step and takes each modulo where the action uses it (LazyDice);
// kernel A's generator reader has them made ahead, off its dependent chain,
// by more threads than there are workflows (pack_dice / PackedDice).
struct LazyDice {
  int64_t r0, r1, r2, r3;
  __device__ __forceinline__ LazyDice(int64_t seed, int64_t w, int64_t step)
      : r0(mix(seed, w, step, 1)), r1(mix(seed, w, step, 2)), r2(mix(seed, w, step, 3)),
        r3(mix(seed, w, step, 4)) {}
  __device__ __forceinline__ int64_t ts_ms() const { return die(r3, 5000) + 1; }
  __device__ __forceinline__ int64_t die1() const { return die(r0, 16); }
  __device__ __forceinline__ int64_t die2() const { return die(r1, 8); }
  __device__ __forceinline__ int64_t started_a0() const { return 600 + die(r2, 6600); }
  __device__ __forceinline__ int64_t sched_to_start() const { return 5 + die(r2, 115); }
  __device__ __forceinline__ int64_t sched_to_close() const { return 30 + die(r2, 570); }
  __device__ __forceinline__ int64_t start_to_close() const { return 10 + die(r3, 290); }
  __device__ __forceinline__ int64_t timer_s() const { return 1 + die(r2, 600); }
};

// The draws of one step packed in 56 bits: die(r3, 5000) + 1 (13 bits),
// die(r0, 16) (4), die(r1, 8) (3), die(r2, 115) (7), die(r2, 570) (10),
// die(r2, 600) (10), die(r3, 290) (9). die(r2, 6600) is used at step 0
// alone (the forced WorkflowExecutionStarted) and travels beside the word.
__device__ __forceinline__ uint64_t pack_dice(int64_t seed, int64_t w, int64_t step) {
  const LazyDice d(seed, w, step);
  return u(d.ts_ms()) | u(d.die1()) << 13 | u(d.die2()) << 17 | u(die(d.r2, 115)) << 20 |
         u(die(d.r2, 570)) << 27 | u(die(d.r2, 600)) << 37 | u(die(d.r3, 290)) << 47;
}

struct PackedDice {
  uint64_t v;
  int64_t started;  // 600 + die(r2, 6600) of step 0
  __device__ __forceinline__ int64_t bits(int lo, int n) const {
    return static_cast<int64_t>((v >> lo) & ((1ull << n) - 1));
  }
  __device__ __forceinline__ int64_t ts_ms() const { return bits(0, 13); }
  __device__ __forceinline__ int64_t die1() const { return bits(13, 4); }
  __device__ __forceinline__ int64_t die2() const { return bits(17, 3); }
  __device__ __forceinline__ int64_t started_a0() const { return started; }
  __device__ __forceinline__ int64_t sched_to_start() const { return 5 + bits(20, 7); }
  __device__ __forceinline__ int64_t sched_to_close() const { return 30 + bits(27, 10); }
  __device__ __forceinline__ int64_t start_to_close() const { return 10 + bits(47, 9); }
  __device__ __forceinline__ int64_t timer_s() const { return 1 + bits(37, 10); }
};

// gen_step for global workflow index w at scan step `step` of `total`, with
// that step's draws `d`: writes the event's 18 lanes and advances g
// The action of scan step `step` of `total`, chosen from the pre-step state
// and the step's draws.
template <class Dice>
__device__ __forceinline__ int choose(const GenState& g, const Dice& d, int64_t step,
                                      int64_t total) {
  const int64_t pending = __popc(g.act_occ) + __popc(g.tmr_occ) + __popc(g.ch_occ);
  const int64_t n_unstarted =
      __popc(g.act_occ & ~g.act_started) + __popc(g.ch_occ & ~g.ch_started);
  const int64_t remaining = total - step;
  const bool drain = remaining <= pending + n_unstarted + 4;

  const int64_t die1 = d.die1();
  const int64_t die2 = d.die2();
  const bool act_free = g.act_occ != ACT_ALL;
  const bool act_unstarted = (g.act_occ & ~g.act_started) != 0;
  const bool act_any = g.act_occ != 0;
  const bool act_started_any = (g.act_occ & g.act_started) != 0;
  const bool tmr_free = g.tmr_occ != TMR_ALL;
  const bool tmr_any = g.tmr_occ != 0;
  const bool ch_free = g.ch_occ != CH_ALL;
  const bool ch_unstarted = (g.ch_occ & ~g.ch_started) != 0;
  const bool ch_any = g.ch_occ != 0;
  const bool ch_started_any = (g.ch_occ & g.ch_started) != 0;

  int code;
  if (drain) {
    code = act_unstarted ? A_ASTART
           : act_any     ? A_ACLOSE
           : ch_unstarted ? A_CSTART
           : tmr_any     ? A_TFIRE
           : ch_any      ? A_CCLOSE
           : remaining > 1 ? A_SIGNAL
                           : A_WFCLOSE;
  } else {
    int external;
    if (die2 <= 1) external = act_free ? A_ASCHED : A_SIGNAL;
    else if (die2 == 2) external = act_unstarted ? A_ASTART : A_SIGNAL;
    else if (die2 == 3) external = act_started_any ? A_ACLOSE : A_SIGNAL;
    else if (die2 == 4) external = tmr_free ? A_TSTART : (tmr_any ? A_TFIRE : A_SIGNAL);
    else if (die2 == 5) external = tmr_any ? A_TFIRE : A_SIGNAL;
    else if (die2 == 6) external = ch_free ? A_CINIT : (ch_started_any ? A_CCLOSE : A_SIGNAL);
    else if (die2 == 7) external = ch_unstarted ? A_CSTART : (ch_started_any ? A_CCLOSE : A_SIGNAL);
    else external = A_SIGNAL;
    if (g.phase == 1) code = die1 < 13 ? A_DSTART : A_SIGNAL;
    else if (g.phase == 2) code = die1 < 6 ? A_DCOMPLETE : external;
    else code = die1 < 8 ? A_DSCHED : external;
  }
  if (step == 0) code = A_STARTED;
  if (step == 1) code = A_DSCHED;
  return code;
}

// Action CODE's update of g (event id eid) and the event's attribute lanes:
// writes the a[] entries the action sets, which start at 0.
template <int CODE, class Dice>
__device__ __forceinline__ void act(GenState& g, const Dice& d, int64_t eid, int64_t* a) {
  if constexpr (CODE == A_STARTED) {
    a[0] = d.started_a0();
    a[1] = 10;
    a[7] = -1;
  } else if constexpr (CODE == A_DSCHED) {
    a[0] = 10;
    g.phase = 1;
    g.dsched = eid;
  } else if constexpr (CODE == A_DSTART) {
    a[0] = g.dsched;
    g.phase = 2;
    g.dstart = eid;
  } else if constexpr (CODE == A_DCOMPLETE) {
    a[0] = g.dsched;
    a[1] = g.dstart;
    g.phase = 0;
  } else if constexpr (CODE == A_ASCHED) {
    const int slot = first_bit(~g.act_occ & ACT_ALL);
    if (slot >= 0) {
      g.act_occ |= 1u << slot;
      put(g.act_sched, slot, eid);
      g.act_started &= ~(1u << slot);
    }
    g.act_count += 1;
    a[0] = g.act_count;  // the interned activity key
    a[1] = d.sched_to_start();
    a[2] = d.sched_to_close();
    a[3] = d.start_to_close();
  } else if constexpr (CODE == A_ASTART) {
    const int sel = first_bit(g.act_occ & ~g.act_started);
    if (sel >= 0) {
      a[0] = pick(g.act_sched, sel);
      g.act_started |= 1u << sel;
    }
  } else if constexpr (CODE == A_ACLOSE) {
    const int sel = first_bit(g.act_occ & g.act_started);
    if (sel >= 0) {
      a[0] = pick(g.act_sched, sel);
      g.act_occ &= ~(1u << sel);
      g.act_started &= ~(1u << sel);
    }
  } else if constexpr (CODE == A_TSTART) {
    g.tmr_count += 1;
    const int slot = first_bit(~g.tmr_occ & TMR_ALL);
    if (slot >= 0) {
      g.tmr_occ |= 1u << slot;
      put(g.tmr_key, slot, g.tmr_count);
    }
    a[0] = g.tmr_count;
    a[1] = d.timer_s();
  } else if constexpr (CODE == A_TFIRE) {
    const int sel = first_bit(g.tmr_occ);
    if (sel >= 0) {
      a[0] = pick(g.tmr_key, sel);
      g.tmr_occ &= ~(1u << sel);
    }
  } else if constexpr (CODE == A_CINIT) {
    const int slot = first_bit(~g.ch_occ & CH_ALL);
    if (slot >= 0) {
      g.ch_occ |= 1u << slot;
      put(g.ch_init, slot, eid);
      g.ch_started &= ~(1u << slot);
    }
  } else if constexpr (CODE == A_CSTART) {
    const int sel = first_bit(g.ch_occ & ~g.ch_started);
    if (sel >= 0) {
      a[0] = pick(g.ch_init, sel);
      g.ch_started |= 1u << sel;
    }
  } else if constexpr (CODE == A_CCLOSE) {
    const int sel = first_bit(g.ch_occ & g.ch_started);
    if (sel >= 0) {
      a[0] = pick(g.ch_init, sel);
      g.ch_occ &= ~(1u << sel);
      g.ch_started &= ~(1u << sel);
    }
  }
  // A_SIGNAL, A_WFCLOSE: no attributes, no state
}

// The timestamp of the event a step emits (the generator's clock after it).
template <class Dice>
__device__ __forceinline__ int64_t next_ts(const GenState& g, const Dice& d) {
  return static_cast<int64_t>(u(g.ts) + u(d.ts_ms() * NANOS_MS));
}

// gen_step at scan step `step` of `total`, with that step's draws `d`:
// writes the event's 18 lanes and advances g
template <class Dice>
__device__ __forceinline__ void step_with(GenState& g, const Dice& d, int64_t step,
                                          int64_t total, int64_t* lane) {
  const int64_t eid = step + 1;
  const int64_t ts = next_ts(g, d);
  const int code = choose(g, d, step, total);
  int64_t a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  switch (code) {
    case A_STARTED: act<A_STARTED>(g, d, eid, a); break;
    case A_DSCHED: act<A_DSCHED>(g, d, eid, a); break;
    case A_DSTART: act<A_DSTART>(g, d, eid, a); break;
    case A_DCOMPLETE: act<A_DCOMPLETE>(g, d, eid, a); break;
    case A_ASCHED: act<A_ASCHED>(g, d, eid, a); break;
    case A_ASTART: act<A_ASTART>(g, d, eid, a); break;
    case A_ACLOSE: act<A_ACLOSE>(g, d, eid, a); break;
    case A_TSTART: act<A_TSTART>(g, d, eid, a); break;
    case A_TFIRE: act<A_TFIRE>(g, d, eid, a); break;
    case A_CINIT: act<A_CINIT>(g, d, eid, a); break;
    case A_CSTART: act<A_CSTART>(g, d, eid, a); break;
    case A_CCLOSE: act<A_CCLOSE>(g, d, eid, a); break;
    default: break;  // A_SIGNAL, A_WFCLOSE
  }
  g.ts = ts;

  // -- the lanes (ops/encode.py): one event per batch, version, branch,
  // parent and flags 0 (the generator never sets FLAG_RUN_RESET)
  lane[0] = eid;
  lane[1] = code_to_type(code);
  lane[2] = 0;
  lane[3] = ts;
  lane[4] = eid + 1000;
  lane[5] = eid;
  lane[6] = 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) lane[7 + i] = a[i];
  lane[15] = 0;
  lane[16] = 0;
  lane[17] = 0;
}

// gen_step for global workflow index w at scan step `step` of `total`:
// writes the event's 18 lanes and advances g
__device__ __forceinline__ void step(GenState& g, int64_t seed, int64_t w, int64_t step,
                                     int64_t total, int64_t* lane) {
  step_with(g, LazyDice(seed, w, step), step, total, lane);
}

}  // namespace gen
}  // namespace cadence
