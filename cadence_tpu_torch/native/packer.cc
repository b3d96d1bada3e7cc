// Native event-batch packer: wire bytes -> [W, E, L] int64 lane tensor.
//
// The reference does its hot host-side work (event decode, thriftrw
// deserialization) in compiled Go (common/persistence/serialization/); this
// framework's equivalent is the host boundary that feeds the TPU: decoding
// serialized history batches (core/codec.py wire format v1) into the packed
// lane schema of ops/encode.py at >= the north-star feed rate (SURVEY.md §7
// hard part 6: sustaining >=16.7M events/s decode+pack is why this is C++,
// not Python).
//
// Semantics are exactly ops/encode.py: per-workflow string interning for
// activity/timer IDs (first-use order, keys starting at 1, one namespace
// with "act:"/"timer:" kinds), per-event-type attribute lane placement, and
// batch-first/batch-last bookkeeping lanes. tests/test_native_packer.py
// asserts byte-identical output against the Python packer.
//
// Build: native/build.py (g++ -O3 -shared); loaded via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// lane indices (ops/encode.py)
constexpr int kLaneEventId = 0;
constexpr int kLaneEventType = 1;
constexpr int kLaneVersion = 2;
constexpr int kLaneTimestamp = 3;
constexpr int kLaneTaskId = 4;
constexpr int kLaneBatchFirst = 5;
constexpr int kLaneBatchLast = 6;
constexpr int kLaneA0 = 7;

// event types (core/enums.py, reference iota order)
enum EventType : int64_t {
  kWorkflowExecutionStarted = 0,
  kDecisionTaskScheduled = 4,
  kDecisionTaskStarted = 5,
  kDecisionTaskCompleted = 6,
  kDecisionTaskTimedOut = 7,
  kActivityTaskScheduled = 9,
  kActivityTaskStarted = 10,
  kActivityTaskCompleted = 11,
  kActivityTaskFailed = 12,
  kActivityTaskTimedOut = 13,
  kActivityTaskCancelRequested = 14,
  kActivityTaskCanceled = 16,
  kTimerStarted = 17,
  kTimerFired = 18,
  kTimerCanceled = 20,
  kStartChildWorkflowExecutionFailed = 31,
  kChildWorkflowExecutionStarted = 32,
};

// attribute wire codes (core/codec.py — keep in lockstep)
enum AttrCode : uint8_t {
  kAExecTimeout = 1,
  kATaskTimeout = 2,
  kABackoff = 3,
  kAAttempt = 4,
  kAExpirationTs = 5,
  // code 6 reserved
  kAHasRetry = 7,
  kAInitiator = 8,
  kASchedEventId = 9,
  kAStartedEventId = 10,
  kATimeoutType = 11,
  kAActivityId = 12,  // string
  kAS2S = 13,
  kAS2C = 14,
  kASTC = 15,
  kAHeartbeat = 16,
  kARetryExpiration = 17,
  kATimerId = 18,  // string
  kAStartToFire = 19,
  kAInitiatedEventId = 20,
  kAParentWorkflowId = 21,  // string
  kAParentRunId = 22,       // string
  kAParentDomainId = 23,    // string
  kAParentInitiatedId = 24,
  kARetryInitInterval = 25,
  kARetryCoeffMilli = 26,
  kARetryMaxInterval = 27,
  kARetryMaxAttempts = 28,
  // routing/lineage strings (codec.py round 2): carried for host-side
  // fidelity, not lane material — skipped after length read
  kATaskList = 29,        // string
  kAWorkflowType = 30,    // string
  kACronSchedule = 31,    // string
  kAFirstExecRunId = 32,  // string
  kARequestId = 33,       // string
  kATargetWorkflowId = 34,  // string
  kATargetRunId = 35,       // string
  kATargetDomainId = 36,    // string
  kASignalName = 37,        // string
  kANewRunId = 38,          // string
  kAParentClosePolicy = 39,
  kAChildWfOnly = 40,
  kALastFailureReason = 41,  // string
  kMaxAttrCode = 42,
};

inline bool IsStringCode(uint8_t code) {
  return code == kAActivityId || code == kATimerId ||
         code == kAParentWorkflowId || code == kAParentRunId ||
         code == kAParentDomainId || code == kALastFailureReason ||
         (code >= kATaskList && code <= kANewRunId);
}

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T read() {
    if (p + sizeof(T) > end) { ok = false; return T{}; }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
};

// Per-workflow string interner ("<kind>:<id>" -> dense key from 1) as a
// flat vector with first-use order: histories hold dozens of distinct IDs
// at most, so a length-first linear scan beats unordered_map's hashing +
// temporary-string construction on the per-event hot path.
struct Interner {
  struct Entry {
    uint8_t kind;
    const char* data;  // points into the wire blob (outlives the pack)
    uint16_t len;
  };
  std::vector<Entry> entries;

  int64_t key(uint8_t kind, const char* data, uint16_t len) {
    for (size_t i = 0; i < entries.size(); ++i) {
      const Entry& e = entries[i];
      if (e.kind == kind && e.len == len &&
          std::memcmp(e.data, data, len) == 0) {
        return static_cast<int64_t>(i) + 1;
      }
    }
    entries.push_back(Entry{kind, data, len});
    return static_cast<int64_t>(entries.size());
  }
};

// wire32 extra lanes (ops/encode.py NUM_LANES32 schema): the two 64-bit
// values (timestamp nanos, Started-event expiration nanos in attr lane 4)
// ship split lo/hi; everything else must fit int32
constexpr int kLane32TsHi = 18;
constexpr int kLane32A4Hi = 19;

template <typename OutT, bool kWire32>
inline bool WriteLane(OutT* r, int lane, int64_t v) {
  if (kWire32) {
    if (v < INT32_MIN || v > INT32_MAX) return false;
  }
  r[lane] = static_cast<OutT>(v);
  return true;
}

// one workflow's history -> rows [E, L]; returns events packed or -errcode
template <typename OutT, bool kWire32>
int64_t PackOne(const uint8_t* blob, int64_t size, int64_t max_events,
                int64_t L, OutT* out) {
  Cursor c{blob, blob + size};
  Interner intern;
  auto intern_key = [&intern](uint8_t kind, const char* data, uint16_t len) {
    return intern.key(kind, data, len);
  };

  int64_t row = 0;
  uint32_t n_batches = c.read<uint32_t>();
  for (uint32_t b = 0; b < n_batches && c.ok; ++b) {
    uint16_t n_events = c.read<uint16_t>();
    int64_t batch_first = 0;
    for (uint16_t i = 0; i < n_events && c.ok; ++i) {
      int64_t id = c.read<int64_t>();
      uint8_t type = c.read<uint8_t>();
      int64_t version = c.read<int64_t>();
      int64_t ts = c.read<int64_t>();
      int64_t task_id = c.read<int64_t>();
      uint8_t n_attrs = c.read<uint8_t>();
      if (i == 0) batch_first = id;

      int64_t attrs[kMaxAttrCode];
      bool present[kMaxAttrCode];
      // each wire attr code appears at most once per event, so kMaxAttrCode
      // bounds the list (a loaded child-workflow Started event carries 20)
      uint8_t seen[kMaxAttrCode];
      int n_seen = 0;
      for (uint8_t a = 0; a < n_attrs && c.ok; ++a) {
        uint8_t code = c.read<uint8_t>();
        if (code >= kMaxAttrCode) return -2;  // unknown attr: refuse
        if (n_seen >= kMaxAttrCode) return -2;  // duplicate codes: malformed
        attrs[code] = 0;
        present[code] = true;
        seen[n_seen++] = code;
        if (IsStringCode(code)) {
          uint16_t len = c.read<uint16_t>();
          if (c.p + len > c.end) { c.ok = false; break; }
          if (code == kAActivityId || code == kATimerId) {
            attrs[code] = intern_key(code,
                                     reinterpret_cast<const char*>(c.p), len);
          }
          // parent-linkage strings don't become lanes; presence suffices
          c.p += len;
        } else {
          attrs[code] = c.read<int64_t>();
        }
      }
      if (!c.ok) return -1;
      if (row >= max_events) return -3;  // history longer than E
      // lazily ensure unwritten codes read as 0/absent: clear only what
      // the per-type switch can touch (cheaper than zeroing 42 slots/event)
      auto miss = [&](uint8_t code) {
        if (!std::count(seen, seen + n_seen, code)) {
          attrs[code] = 0;
          present[code] = false;
        }
      };
      for (uint8_t code : {static_cast<uint8_t>(kAExecTimeout),
                           static_cast<uint8_t>(kATaskTimeout),
                           static_cast<uint8_t>(kABackoff),
                           static_cast<uint8_t>(kAAttempt),
                           static_cast<uint8_t>(kAExpirationTs),
                           static_cast<uint8_t>(kAHasRetry),
                           static_cast<uint8_t>(kAInitiator),
                           static_cast<uint8_t>(kASchedEventId),
                           static_cast<uint8_t>(kAStartedEventId),
                           static_cast<uint8_t>(kATimeoutType),
                           static_cast<uint8_t>(kAActivityId),
                           static_cast<uint8_t>(kAS2S),
                           static_cast<uint8_t>(kAS2C),
                           static_cast<uint8_t>(kASTC),
                           static_cast<uint8_t>(kAHeartbeat),
                           static_cast<uint8_t>(kARetryExpiration),
                           static_cast<uint8_t>(kATimerId),
                           static_cast<uint8_t>(kAStartToFire),
                           static_cast<uint8_t>(kAInitiatedEventId),
                           static_cast<uint8_t>(kAParentWorkflowId)})
        miss(code);

      OutT* r = out + row * L;
      // real rows are fully written: header lanes below, attr lanes cleared
      // here then filled by the per-type switch (supports buffer reuse)
      std::memset(r + kLaneA0, 0, sizeof(OutT) * (L - kLaneA0));
      bool fit = true;
      fit &= WriteLane<OutT, kWire32>(r, kLaneEventId, id);
      r[kLaneEventType] = static_cast<OutT>(type);
      fit &= WriteLane<OutT, kWire32>(r, kLaneVersion, version);
      if (kWire32) {
        r[kLaneTimestamp] = static_cast<OutT>(static_cast<uint32_t>(ts));
        r[kLane32TsHi] = static_cast<OutT>(ts >> 32);
      } else {
        r[kLaneTimestamp] = static_cast<OutT>(ts);
      }
      fit &= WriteLane<OutT, kWire32>(r, kLaneTaskId, task_id);
      fit &= WriteLane<OutT, kWire32>(r, kLaneBatchFirst, batch_first);
      r[kLaneBatchLast] = (i == n_events - 1) ? 1 : 0;
      if (!fit) return -4;  // a narrow lane exceeds int32: int64 path only
      int64_t a0_vals[8] = {0};
      int64_t* a0 = a0_vals;

      // per-type attribute placement (ops/encode.py _encode_attrs)
      switch (type) {
        case kWorkflowExecutionStarted:
          a0[0] = attrs[kAExecTimeout];
          a0[1] = attrs[kATaskTimeout];
          a0[2] = attrs[kABackoff];
          a0[3] = attrs[kAAttempt];
          a0[4] = attrs[kAExpirationTs];
          a0[5] = present[kAParentWorkflowId] ? 1 : 0;
          a0[6] = attrs[kAHasRetry];
          a0[7] = present[kAInitiator] ? attrs[kAInitiator] : -1;
          break;
        case kDecisionTaskScheduled:
          a0[0] = attrs[kASTC];
          a0[1] = attrs[kAAttempt];
          break;
        case kDecisionTaskStarted:
        case kActivityTaskStarted:
        case kActivityTaskCompleted:
        case kActivityTaskFailed:
        case kActivityTaskTimedOut:
        case kActivityTaskCanceled:
          a0[0] = attrs[kASchedEventId];
          break;
        case kDecisionTaskCompleted:
          a0[0] = attrs[kASchedEventId];
          a0[1] = attrs[kAStartedEventId];
          break;
        case kDecisionTaskTimedOut:
          a0[0] = attrs[kATimeoutType];
          break;
        case kActivityTaskScheduled:
          a0[0] = attrs[kAActivityId];
          a0[1] = attrs[kAS2S];
          a0[2] = attrs[kAS2C];
          a0[3] = attrs[kASTC];
          a0[4] = attrs[kAHeartbeat];
          a0[5] = attrs[kAHasRetry];
          a0[6] = attrs[kARetryExpiration];
          break;
        case kActivityTaskCancelRequested:
          a0[0] = attrs[kAActivityId];
          break;
        case kTimerStarted:
          a0[0] = attrs[kATimerId];
          a0[1] = attrs[kAStartToFire];
          break;
        case kTimerFired:
        case kTimerCanceled:
          a0[0] = attrs[kATimerId];
          break;
        default:
          // child/external resolution events + no-attr events all read the
          // initiated-event lane (0 when absent)
          a0[0] = attrs[kAInitiatedEventId];
          break;
      }
      // flush attr lanes to the row; wire32 splits a4 (expiration nanos)
      for (int k = 0; k < 8; ++k) {
        if (kWire32 && k == 4) {
          r[kLaneA0 + 4] =
              static_cast<OutT>(static_cast<uint32_t>(a0_vals[4]));
          r[kLane32A4Hi] = static_cast<OutT>(a0_vals[4] >> 32);
        } else if (!WriteLane<OutT, kWire32>(r, kLaneA0 + k, a0_vals[k])) {
          return -4;
        }
      }
      ++row;
    }
  }
  if (!c.ok) return -1;
  // padding tail: zero lanes, event type -1
  for (int64_t e = row; e < max_events; ++e) {
    std::memset(out + e * L, 0, sizeof(OutT) * L);
    out[e * L + kLaneEventType] = static_cast<OutT>(-1);
  }
  return row;
}

template <typename OutT, bool kWire32>
int64_t PackCorpus(const uint8_t* blob, const int64_t* offsets,
                   int64_t num_workflows, int64_t max_events,
                   int64_t num_lanes, OutT* out, int64_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<int64_t> totals(static_cast<size_t>(num_threads), 0);
  std::vector<int64_t> errs(static_cast<size_t>(num_threads), 0);

  auto work = [&](int64_t t) {
    for (int64_t w = t; w < num_workflows; w += num_threads) {
      int64_t n = PackOne<OutT, kWire32>(
          blob + offsets[w], offsets[w + 1] - offsets[w], max_events,
          num_lanes, out + w * max_events * num_lanes);
      if (n < 0) {
        errs[static_cast<size_t>(t)] = -(w + 1) * 1000 + n;
        return;
      }
      totals[static_cast<size_t>(t)] += n;
    }
  };

  if (num_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < num_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  for (int64_t e : errs) {
    if (e != 0) return e;
  }
  int64_t total = 0;
  for (int64_t t : totals) total += t;
  return total;
}

}  // namespace

extern "C" {

// Pack W serialized histories into out[W, E, L] int64. offsets has W+1
// entries into blob. Returns total events packed, or
// -(workflow_index+1)*1000 - err on the first failing workflow.
int64_t cadence_pack_corpus(const uint8_t* blob, const int64_t* offsets,
                            int64_t num_workflows, int64_t max_events,
                            int64_t num_lanes, int64_t* out,
                            int64_t num_threads) {
  return PackCorpus<int64_t, false>(blob, offsets, num_workflows, max_events,
                                    num_lanes, out, num_threads);
}

// wire32 variant: out[W, E, L32] int32 (ops/encode.py NUM_LANES32 schema,
// timestamp + expiration split lo/hi). err -4: a narrow lane exceeds int32.
int64_t cadence_pack_corpus32(const uint8_t* blob, const int64_t* offsets,
                              int64_t num_workflows, int64_t max_events,
                              int64_t num_lanes, int32_t* out,
                              int64_t num_threads) {
  return PackCorpus<int32_t, true>(blob, offsets, num_workflows, max_events,
                                   num_lanes, out, num_threads);
}

}  // extern "C"
