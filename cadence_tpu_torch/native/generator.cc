// Native north-star corpus generator: distinct 1k-event histories at
// device feed rates.
//
// The Python corpus generator (gen/corpus.py) produces ~250k events/s —
// three orders of magnitude short of feeding a 1M-workflow x 1k-event
// north-star run (BASELINE.md) with DISTINCT histories. This generator
// emits the packed [W, E, L] lane tensor DIRECTLY (schema of
// ops/encode.py; no wire round-trip), multithreaded over workflows, with
// a per-workflow splitmix64 stream seeded by (seed, workflow_index) so
// every history is structurally distinct yet exactly reproducible.
//
// History shape (the "mixed" north-star composition): decision cycles
// interleaved with randomized activity schedule/start/close chains, user
// timers, child workflows, and signals — the same building blocks the
// bench/canary suites exercise (bench/load/basic/stressWorkflow.go chain
// + canary signal/timer/childworkflow shapes) — closing with a final
// decision and WorkflowExecutionCompleted. Pending-entity concurrency
// stays below the kernel's table capacities.
//
// Spot-parity contract: ops/encode.py decode_lanes() reconstructs these
// rows into oracle-replayable events; the bench cross-checks sampled
// workflows' canonical payloads device-vs-oracle.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// lane indices (ops/encode.py)
constexpr int64_t kLaneEventId = 0;
constexpr int64_t kLaneEventType = 1;
constexpr int64_t kLaneVersion = 2;
constexpr int64_t kLaneTimestamp = 3;
constexpr int64_t kLaneTaskId = 4;
constexpr int64_t kLaneBatchFirst = 5;
constexpr int64_t kLaneBatchLast = 6;
constexpr int64_t kLaneA0 = 7;

// event types (core/enums.py)
constexpr int64_t kStarted = 0;
constexpr int64_t kCompleted = 1;
constexpr int64_t kDTSched = 4;
constexpr int64_t kDTStart = 5;
constexpr int64_t kDTComplete = 6;
constexpr int64_t kASched = 9;
constexpr int64_t kAStart = 10;
constexpr int64_t kAComplete = 11;
constexpr int64_t kAFailed = 12;
constexpr int64_t kATimedOut = 13;
constexpr int64_t kTimerStarted = 17;
constexpr int64_t kTimerFired = 18;
constexpr int64_t kSignaled = 27;
constexpr int64_t kChildInitiated = 30;
constexpr int64_t kChildStarted = 32;
constexpr int64_t kChildCompleted = 33;

constexpr int64_t kNanos = 1000000000LL;

struct Rng {
  uint64_t s;
  uint64_t next() {
    s += 0x9E3779B97F4A7C15ULL;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  int64_t range(int64_t lo, int64_t hi) {  // inclusive
    return lo + static_cast<int64_t>(next() % static_cast<uint64_t>(hi - lo + 1));
  }
};

class Writer {
 public:
  Writer(int64_t* out, int64_t max_events, int64_t num_lanes)
      : out_(out), max_events_(max_events), L_(num_lanes) {}

  bool full(int64_t needed) const { return row_ + needed > max_events_; }
  int64_t emitted() const { return row_; }
  int64_t next_id() const { return next_id_; }

  // emit one event; returns its id
  int64_t emit(int64_t type, int64_t ts, const int64_t a[8]) {
    int64_t* r = out_ + row_ * L_;
    std::memset(r, 0, sizeof(int64_t) * L_);
    int64_t id = next_id_++;
    r[kLaneEventId] = id;
    r[kLaneEventType] = type;
    r[kLaneVersion] = 0;
    r[kLaneTimestamp] = ts;
    r[kLaneTaskId] = 1000 + id;
    r[kLaneBatchFirst] = batch_first_ ? batch_first_ : id;
    if (!batch_first_) batch_first_ = id;
    r[kLaneBatchLast] = 0;
    if (a != nullptr)
      for (int i = 0; i < 8; ++i) r[kLaneA0 + i] = a[i];
    last_row_ = row_;
    ++row_;
    return id;
  }

  void end_batch() {
    out_[last_row_ * L_ + kLaneBatchLast] = 1;
    batch_first_ = 0;
  }

  void pad_tail() {
    for (int64_t e = row_; e < max_events_; ++e) {
      int64_t* r = out_ + e * L_;
      std::memset(r, 0, sizeof(int64_t) * L_);
      r[kLaneEventType] = -1;
    }
  }

 private:
  int64_t* out_;
  int64_t max_events_;
  int64_t L_;
  int64_t row_ = 0;
  int64_t last_row_ = 0;
  int64_t next_id_ = 1;
  int64_t batch_first_ = 0;
};

struct Pending {
  int64_t ids[8];
  int64_t n = 0;
  void push(int64_t v) { if (n < 8) ids[n++] = v; }
};

// generate one workflow's history into out[max_events, L]
void GenerateOne(uint64_t seed, int64_t index, int64_t max_events,
                 int64_t L, int64_t* out) {
  Rng rng{seed * 0x9E3779B97F4A7C15ULL + static_cast<uint64_t>(index) + 1};
  Writer w(out, max_events, L);
  int64_t ts = 1700000000LL * kNanos + rng.range(0, 1000000) * 1000000LL;
  int64_t act_key = 0, timer_key = 0;
  Pending acts, timers, timer_keys, children;

  int64_t a[8];

  // start batch: WorkflowExecutionStarted + first DecisionTaskScheduled
  std::memset(a, 0, sizeof(a));
  a[0] = rng.range(600, 7200);  // execution timeout
  a[1] = 10;                    // task timeout
  a[7] = -1;                    // no initiator
  w.emit(kStarted, ts, a);
  std::memset(a, 0, sizeof(a));
  a[0] = 10;  // decision start-to-close
  int64_t dsched = w.emit(kDTSched, ts, a);
  w.end_batch();

  std::memset(a, 0, sizeof(a));
  a[0] = dsched;
  ts += rng.range(1, 50) * 1000000LL;
  int64_t dstart = w.emit(kDTStart, ts, a);
  w.end_batch();

  // main loop: complete the decision with commands, resolve pending work,
  // schedule the next decision — until the budget forces the close
  while (true) {
    // closing needs: resolutions (2/act started-close, 1/timer, 2/child)
    // + final decision completion batch (2 events)
    int64_t reserve = acts.n * 2 + timers.n + children.n * 2 + 2 + 8;
    if (w.full(reserve + 32)) break;

    // decision completes; commands ride the same batch
    ts += rng.range(1, 2000) * 1000000LL;
    std::memset(a, 0, sizeof(a));
    a[0] = dsched;
    a[1] = dstart;
    w.emit(kDTComplete, ts, a);
    int64_t n_acts = rng.range(0, 3);
    for (int64_t i = 0; i < n_acts && acts.n < 4; ++i) {
      std::memset(a, 0, sizeof(a));
      a[0] = ++act_key;                 // interned activity key
      a[1] = rng.range(5, 120);         // schedule-to-start
      a[2] = rng.range(30, 600);        // schedule-to-close
      a[3] = rng.range(10, 300);        // start-to-close
      a[4] = (rng.next() & 3) == 0 ? rng.range(5, 60) : 0;  // heartbeat
      int64_t id = w.emit(kASched, ts, a);
      acts.push(id);
    }
    if ((rng.next() & 3) == 0 && timers.n < 3) {
      std::memset(a, 0, sizeof(a));
      a[0] = ++timer_key;
      a[1] = rng.range(1, 600);  // start-to-fire
      int64_t id = w.emit(kTimerStarted, ts, a);
      timers.push(id);
      timer_keys.push(a[0]);
      // parallel arrays: keep slots aligned (pop uses same rng order —
      // instead store key alongside id by popping by index pairs below)
    }
    if ((rng.next() & 7) == 0 && children.n < 2) {
      int64_t id = w.emit(kChildInitiated, ts, nullptr);
      children.push(id);
    }
    w.end_batch();

    // external progress between decisions, each its own batch
    int64_t moves = rng.range(1, 4);
    for (int64_t mv = 0; mv < moves; ++mv) {
      if (w.full(acts.n * 2 + timers.n + children.n * 2 + 16)) break;
      uint64_t pick = rng.next() % 8;
      ts += rng.range(1, 5000) * 1000000LL;
      if (pick < 3 && acts.n > 0) {
        // start + close one activity
        int64_t i = rng.range(0, acts.n - 1);
        int64_t sched = acts.ids[i];
        acts.ids[i] = acts.ids[--acts.n];
        std::memset(a, 0, sizeof(a));
        a[0] = sched;
        w.emit(kAStart, ts, a);
        w.end_batch();
        ts += rng.range(1, 3000) * 1000000LL;
        std::memset(a, 0, sizeof(a));
        a[0] = sched;
        uint64_t c = rng.next() % 10;
        int64_t close = c < 7 ? kAComplete : (c < 9 ? kAFailed : kATimedOut);
        w.emit(close, ts, a);
        w.end_batch();
      } else if (pick == 3 && timers.n > 0) {
        int64_t i = rng.range(0, timers.n - 1);
        timers.ids[i] = timers.ids[--timers.n];
        int64_t key = timer_keys.ids[i];
        timer_keys.ids[i] = timer_keys.ids[--timer_keys.n];
        std::memset(a, 0, sizeof(a));
        a[0] = key;
        w.emit(kTimerFired, ts, a);
        w.end_batch();
      } else if (pick == 4 && children.n > 0) {
        int64_t i = rng.range(0, children.n - 1);
        int64_t init = children.ids[i];
        children.ids[i] = children.ids[--children.n];
        std::memset(a, 0, sizeof(a));
        a[0] = init;
        w.emit(kChildStarted, ts, a);
        w.end_batch();
        ts += rng.range(1, 2000) * 1000000LL;
        std::memset(a, 0, sizeof(a));
        a[0] = init;
        w.emit(kChildCompleted, ts, a);
        w.end_batch();
      } else {
        w.emit(kSignaled, ts, nullptr);
        w.end_batch();
      }
    }

    // next decision cycle
    ts += rng.range(1, 100) * 1000000LL;
    std::memset(a, 0, sizeof(a));
    a[0] = 10;
    dsched = w.emit(kDTSched, ts, a);
    w.end_batch();
    std::memset(a, 0, sizeof(a));
    a[0] = dsched;
    ts += rng.range(1, 50) * 1000000LL;
    dstart = w.emit(kDTStart, ts, a);
    w.end_batch();
  }

  // resolve every pending entity so the close is clean
  while (acts.n > 0) {
    int64_t sched = acts.ids[--acts.n];
    ts += 1000000LL;
    std::memset(a, 0, sizeof(a));
    a[0] = sched;
    w.emit(kAStart, ts, a);
    w.end_batch();
    std::memset(a, 0, sizeof(a));
    a[0] = sched;
    w.emit(kAComplete, ts, a);
    w.end_batch();
  }
  while (timers.n > 0) {
    --timers.n;
    int64_t key = timer_keys.ids[--timer_keys.n];
    ts += 1000000LL;
    std::memset(a, 0, sizeof(a));
    a[0] = key;
    w.emit(kTimerFired, ts, a);
    w.end_batch();
  }
  while (children.n > 0) {
    int64_t init = children.ids[--children.n];
    ts += 1000000LL;
    std::memset(a, 0, sizeof(a));
    a[0] = init;
    w.emit(kChildStarted, ts, a);
    w.end_batch();
    std::memset(a, 0, sizeof(a));
    a[0] = init;
    w.emit(kChildCompleted, ts, a);
    w.end_batch();
  }

  // final decision completion + close (one batch)
  ts += 1000000LL;
  std::memset(a, 0, sizeof(a));
  a[0] = dsched;
  a[1] = dstart;
  w.emit(kDTComplete, ts, a);
  w.emit(kCompleted, ts, nullptr);
  w.end_batch();

  w.pad_tail();
}

}  // namespace

extern "C" {

// Fill out[num_workflows, max_events, num_lanes] with distinct histories
// for global workflow indices [first_index, first_index + num_workflows).
// Returns total real events generated.
int64_t cadence_generate_corpus(uint64_t seed, int64_t first_index,
                                int64_t num_workflows, int64_t max_events,
                                int64_t num_lanes, int64_t* out,
                                int64_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<int64_t> totals(static_cast<size_t>(num_threads), 0);
  auto work = [&](int64_t t) {
    int64_t count = 0;
    for (int64_t w = t; w < num_workflows; w += num_threads) {
      int64_t* base = out + w * max_events * num_lanes;
      GenerateOne(seed, first_index + w, max_events, num_lanes, base);
      for (int64_t e = 0; e < max_events; ++e)
        if (base[e * num_lanes + kLaneEventId] > 0) ++count;
    }
    totals[static_cast<size_t>(t)] = count;
  };
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < num_threads; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t v : totals) total += v;
  return total;
}

}  // extern "C"
