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
// (the action, from the state and the step's draws) and `act_all` (the
// state's update and the event's attribute lanes). Kernel I runs
// `step_with`, which fills the 18 lanes it writes. Kernel A's generator
// reader runs the two beside each action's replay update, so no event byte
// exists in memory; it calls act_all in each case of its switch on the
// action, with the action a constant. The draws (`Dice`) are the four
// counter hashes and the modulos of them (LazyDice defines them), made
// ahead by the block and packed in one word for both kernels (pack_dice,
// PackedDice).
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

// _CODE_TO_TYPE: each action's EventType (core/enums.py), a byte each in
// code order, packed in two words so that the lookup takes no branch:
// WorkflowExecutionStarted 0, DecisionTaskScheduled 4, DecisionTaskStarted 5,
// DecisionTaskCompleted 6, ActivityTaskScheduled 9, ActivityTaskStarted 10,
// ActivityTaskCompleted 11, TimerStarted 17, TimerFired 18,
// StartChildWorkflowExecutionInitiated 30, ChildWorkflowExecutionStarted 32,
// ChildWorkflowExecutionCompleted 33, WorkflowExecutionSignaled 27,
// WorkflowExecutionCompleted 1
__device__ __forceinline__ int64_t code_to_type(int code) {
  constexpr unsigned long long LO = 0ull | 4ull << 8 | 5ull << 16 | 6ull << 24 | 9ull << 32 |
                                    10ull << 40 | 11ull << 48 | 17ull << 56;  // codes 0-7
  constexpr unsigned long long HI = 18ull | 30ull << 8 | 32ull << 16 | 33ull << 24 |
                                    27ull << 32 | 1ull << 40;  // codes 8-13
  return static_cast<int64_t>(((code < 8 ? LO : HI) >> (8 * (code & 7))) & 0xffull);
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
// (salts 1-4) and the three draws every step takes from them (pack_dice
// takes the attribute draws). Both kernels have them made ahead, off the
// stepping thread's dependent chain, by more threads than there are
// workflows (pack_dice / PackedDice).
struct LazyDice {
  int64_t r0, r1, r2, r3;
  __device__ __forceinline__ LazyDice(int64_t seed, int64_t w, int64_t step)
      : r0(mix(seed, w, step, 1)), r1(mix(seed, w, step, 2)), r2(mix(seed, w, step, 3)),
        r3(mix(seed, w, step, 4)) {}
  __device__ __forceinline__ int64_t ts_ms() const { return die(r3, 5000) + 1; }
  __device__ __forceinline__ int64_t die1() const { return die(r0, 16); }
  __device__ __forceinline__ int64_t die2() const { return die(r1, 8); }
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

// The lowest set bit of `m` as a mask (0 for none).
__device__ __forceinline__ uint32_t low_bit(uint32_t m) { return m & (0u - m); }

// The entry of v whose bit is set in `one` (a mask of at most one bit), or
// 0 for none.
template <int K>
__device__ __forceinline__ int64_t pick_bit(const int64_t (&v)[K], uint32_t one) {
  int64_t out = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) out = (one >> k) & 1u ? v[k] : out;
  return out;
}

// Action `code`'s update of g (event id eid) and the event's attribute
// lanes: writes the a[] entries the action sets, which start at 0. Every
// action's update and attribute lanes are computed from the pre-step state
// and kept under the action's predicate, so there is no branch on the code:
// a warp whose workflows took different actions runs one instruction
// stream, and the actions' independent work overlaps (the one stepping warp
// of kernel I's parity-leg launch otherwise runs each distinct action's
// short dependent chain in turn). With a constant code the compiler keeps
// that action's update alone.
template <class Dice>
__device__ __forceinline__ void act_all(GenState& g, const Dice& d, int64_t eid, int code,
                                        int64_t* a) {
  const bool started = code == A_STARTED, dsched = code == A_DSCHED, dstart = code == A_DSTART;
  const bool dcomplete = code == A_DCOMPLETE, asched = code == A_ASCHED;
  const bool astart = code == A_ASTART, aclose = code == A_ACLOSE, tstart = code == A_TSTART;
  const bool tfire = code == A_TFIRE, cinit = code == A_CINIT, cstart = code == A_CSTART;
  const bool cclose = code == A_CCLOSE;
  // the slots each action takes: an insert the first free, a start the
  // first occupied unstarted, a close the first occupied started, a fire
  // the first occupied
  const uint32_t a_ins = asched ? low_bit(~g.act_occ & ACT_ALL) : 0u;
  const uint32_t a_unstarted = low_bit(g.act_occ & ~g.act_started);
  const uint32_t a_started = low_bit(g.act_occ & g.act_started);
  const uint32_t a_start = astart ? a_unstarted : 0u, a_close = aclose ? a_started : 0u;
  const uint32_t t_ins = tstart ? low_bit(~g.tmr_occ & TMR_ALL) : 0u;
  const uint32_t t_first = low_bit(g.tmr_occ);
  const uint32_t t_fire = tfire ? t_first : 0u;
  const uint32_t c_ins = cinit ? low_bit(~g.ch_occ & CH_ALL) : 0u;
  const uint32_t c_unstarted = low_bit(g.ch_occ & ~g.ch_started);
  const uint32_t c_started = low_bit(g.ch_occ & g.ch_started);
  const uint32_t c_start = cstart ? c_unstarted : 0u, c_close = cclose ? c_started : 0u;
  const int64_t act_count = g.act_count + (asched ? 1 : 0);
  const int64_t tmr_count = g.tmr_count + (tstart ? 1 : 0);

  a[0] = started               ? d.started_a0()
         : dsched              ? 10
         : dstart || dcomplete ? g.dsched
         : asched              ? act_count
         : astart              ? pick_bit(g.act_sched, a_unstarted)
         : aclose              ? pick_bit(g.act_sched, a_started)
         : tstart              ? tmr_count
         : tfire               ? pick_bit(g.tmr_key, t_first)
         : cstart              ? pick_bit(g.ch_init, c_unstarted)
         : cclose              ? pick_bit(g.ch_init, c_started)
                               : 0;
  a[1] = started ? 10 : dcomplete ? g.dstart : asched ? d.sched_to_start()
         : tstart ? d.timer_s() : 0;
  a[2] = asched ? d.sched_to_close() : 0;
  a[3] = asched ? d.start_to_close() : 0;
  a[7] = started ? -1 : 0;

  g.phase = dsched ? 1 : dstart ? 2 : dcomplete ? 0 : g.phase;
  g.dsched = dsched ? eid : g.dsched;
  g.dstart = dstart ? eid : g.dstart;
#pragma unroll
  for (int k = 0; k < 4; ++k) g.act_sched[k] = (a_ins >> k) & 1u ? eid : g.act_sched[k];
  g.act_occ = (g.act_occ | a_ins) & ~a_close;
  g.act_started = ((g.act_started & ~a_ins) | a_start) & ~a_close;
  g.act_count = act_count;
#pragma unroll
  for (int k = 0; k < 3; ++k) g.tmr_key[k] = (t_ins >> k) & 1u ? tmr_count : g.tmr_key[k];
  g.tmr_occ = (g.tmr_occ | t_ins) & ~t_fire;
  g.tmr_count = tmr_count;
#pragma unroll
  for (int k = 0; k < 2; ++k) g.ch_init[k] = (c_ins >> k) & 1u ? eid : g.ch_init[k];
  g.ch_occ = (g.ch_occ | c_ins) & ~c_close;
  g.ch_started = ((g.ch_started & ~c_ins) | c_start) & ~c_close;
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
  act_all(g, d, eid, code, a);
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

}  // namespace gen
}  // namespace cadence
