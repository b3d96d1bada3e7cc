// Kernel B: payload.
//
// Replaces the JAX package's ops/payload.py `payload_rows_narrow` (with
// `_sorted_ids` and `payload_rows`): the canonical [W, width] int64
// checksum row of each workflow's ReplayState, projected to an output
// layout no wider than the state's (the escalation ladder's base-width
// readback), plus the narrow-overflow flag.
//
// Row: 11 scalars, the current branch's version-history count and
// (event_id, version) pairs, then the five pending-ID lists (timers,
// activities, children, signals, request-cancels), each count-prefixed
// and sorted ascending with PAD for free slots, cut to the output
// capacity.
//
// Design. One thread per workflow writes its own row. The sort is a rank
// sort over the K slots of each table: slot i goes to position
// #{j : v_j < v_i, or v_j == v_i and j < i} where v is the ID or PAD,
// which is the stable ascending order `jnp.sort` gives, with no scratch
// memory and K taken at run time.
//
// Bound. Bytes: the table IDs and occupancies, the current branch's
// version-history row and the scalars are read once, and 8 * width bytes
// are written per workflow. The O(K^2) compares (256 per table at K = 16)
// run in registers on data the thread has just read, far below the
// integer rate; the uncoalesced per-thread rows are what this first
// version pays for.
#include "state.cuh"

namespace cadence {
namespace {

struct OutCaps {
  int kt, ka, kc, ks, kr;  // in row order: timers, activities, children, signals, cancels
  int kv;
};

__device__ __forceinline__ int sorted_list(const uint8_t* occ, const int64_t* ids, int k,
                                           int cap, int64_t* out, bool& overflow) {
  int cnt = 0;
  for (int i = 0; i < k; ++i) cnt += occ[i] ? 1 : 0;
  if (cnt > cap) overflow = true;
  out[0] = cnt;
  for (int i = 0; i < k; ++i) {
    const int64_t v = occ[i] ? ids[i] : PAD;
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const int64_t u = occ[j] ? ids[j] : PAD;
      rank += (u < v || (u == v && j < i)) ? 1 : 0;
    }
    if (rank < cap) out[1 + rank] = v;
  }
  return 1 + cap;
}

__global__ void payload_kernel(StatePtrs S, int64_t* __restrict__ rows,
                               uint8_t* __restrict__ overflow_out, int64_t W, Caps c,
                               OutCaps o, int width) {
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int64_t* row = rows + w * width;
  row[0] = fb(S, F_CANCEL_REQUESTED)[w] ? 1 : 0;
  row[1] = f32(S, F_STATE)[w];
  row[2] = f64(S, F_LAST_FIRST_EVENT_ID)[w];
  row[3] = f64(S, F_NEXT_EVENT_ID)[w];
  row[4] = f64(S, F_LAST_PROCESSED_EVENT)[w];
  row[5] = f64(S, F_SIGNAL_COUNT)[w];
  row[6] = f64(S, F_DECISION_ATTEMPT)[w];
  row[7] = f64(S, F_DECISION_SCHEDULE_ID)[w];
  row[8] = f64(S, F_DECISION_STARTED_ID)[w];
  row[9] = f64(S, F_DECISION_VERSION)[w];
  row[10] = 0;  // sticky task list: cleared on replay, hashes to 0

  int cb = f32(S, F_CURRENT_BRANCH)[w];
  cb = cb < 0 ? 0 : (cb > c.b - 1 ? c.b - 1 : cb);
  const int64_t vrow = (w * c.b + cb) * int64_t(c.kv);
  const int32_t count = f32(S, F_VH_COUNT)[w * c.b + cb];
  bool overflow = count > o.kv;
  row[11] = count;
  for (int k = 0; k < o.kv; ++k) {
    row[12 + 2 * k] = f64(S, F_VH_EVENT_IDS)[vrow + k];
    row[13 + 2 * k] = f64(S, F_VH_VERSIONS)[vrow + k];
  }
  int off = 12 + 2 * o.kv;
  off += sorted_list(fb(S, F_TMR_OCC) + w * c.kt, f64(S, F_TMR_STARTED_ID) + w * c.kt, c.kt,
                     o.kt, row + off, overflow);
  off += sorted_list(fb(S, F_ACT_OCC) + w * c.ka, f64(S, F_ACT_SCHEDULE_ID) + w * c.ka, c.ka,
                     o.ka, row + off, overflow);
  off += sorted_list(fb(S, F_CH_OCC) + w * c.kc, f64(S, F_CH_INITIATED_ID) + w * c.kc, c.kc,
                     o.kc, row + off, overflow);
  off += sorted_list(fb(S, F_SG_OCC) + w * c.ks, f64(S, F_SG_INITIATED_ID) + w * c.ks, c.ks,
                     o.ks, row + off, overflow);
  sorted_list(fb(S, F_RC_OCC) + w * c.kr, f64(S, F_RC_INITIATED_ID) + w * c.kr, c.kr, o.kr,
              row + off, overflow);
  overflow_out[w] = overflow ? 1 : 0;
}

}  // namespace
}  // namespace cadence

// caps / out_caps are in state-layout order: activities, timers, children,
// request-cancels, signals.
extern "C" int cadence_payload(const void* ptr_table, void* rows, void* overflow, int64_t W,
                               const int* caps, int b, int kv, const int* out_caps, int out_kv,
                               int width, void* stream) {
  using namespace cadence;
  StatePtrs S;
  const uint64_t* table = static_cast<const uint64_t*>(ptr_table);
  for (int i = 0; i < NUM_FIELDS; ++i) S.p[i] = reinterpret_cast<void*>(table[i]);
  Caps c{caps[0], caps[1], caps[2], caps[3], caps[4], b, kv};
  OutCaps o{out_caps[1], out_caps[0], out_caps[2], out_caps[4], out_caps[3], out_kv};
  if (W <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((W + threads - 1) / threads);
  payload_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      S, static_cast<int64_t*>(rows), static_cast<uint8_t*>(overflow), W, c, o, width);
  return static_cast<int>(cudaGetLastError());
}
