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
// capacity. The flag is set when the count or a table's occupancy exceeds
// its output capacity.
//
// Design. A block holds up to PAYLOAD_MAX_WF workflows and
// PAYLOAD_THREADS threads, in three phases:
// 1. it stages its workflows' contiguous [Wb, K] occupancy and ID slabs of
//    the five tables into shared memory with coalesced loads (16 bytes a
//    thread where the slab is aligned), while one thread a workflow reads
//    its scalars, its current branch and that branch's version-history
//    pairs into the workflow's row in shared memory;
// 2. one thread a (workflow, slot) ranks the slot with the stable rule
//    slot i goes to position #{j : v_j < v_i, or v_j == v_i and j < i}
//    (v = the ID, or PAD for a free slot), the order `jnp.sort` gives, and
//    writes it into the row if the position is under the output capacity;
//    one thread a (workflow, table) counts the occupied slots;
// 3. the block stores its [Wb, width] rows, contiguous in the output, with
//    coalesced stores.
// Wb is the largest power of two up to PAYLOAD_MAX_WF whose shared memory
// fits PAYLOAD_SMEM_TARGET (payload_block); K is taken at run time.
//
// Bound. Bytes: the table IDs and occupancies, the current branch's
// version-history row and the scalars are read once, and 8 * width + 1
// bytes are written a workflow (about 725 B read and 712 B written at the
// default layout); the K^2 compares of the ranks run on shared memory.
#include "state.cuh"

namespace cadence {
namespace {

constexpr int PAYLOAD_THREADS = 256;
constexpr int PAYLOAD_MAX_WF = 32;
constexpr int PAYLOAD_SMEM_TARGET = 48 * 1024;
constexpr int NUM_TABLES = 5;

// The five tables in row order: timers, activities, children, signals,
// request-cancels; the state field of each one's occupancy and listed ID.
__device__ __forceinline__ int table_occ(int t) {
  return t == 0 ? F_TMR_OCC : t == 1 ? F_ACT_OCC : t == 2 ? F_CH_OCC : t == 3 ? F_SG_OCC
                                                                               : F_RC_OCC;
}
__device__ __forceinline__ int table_ids(int t) {
  return t == 0   ? F_TMR_STARTED_ID
         : t == 1 ? F_ACT_SCHEDULE_ID
         : t == 2 ? F_CH_INITIATED_ID
         : t == 3 ? F_SG_INITIATED_ID
                  : F_RC_INITIATED_ID;
}

struct PayloadArgs {
  int k[NUM_TABLES];    // the state's capacities, in row order
  int cap[NUM_TABLES];  // the output's capacities, in row order
  int b, kv, out_kv, width;
  int nw;               // workflows a block
};

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// Shared memory of a block of nw workflows: the ID slabs (sum K x nw int64),
// the rows (width x nw int64), the occupancy slabs (sum K x nw bytes), the
// flags (nw int32).
__host__ __device__ __forceinline__ int payload_smem(const PayloadArgs& a, int nw) {
  int slots = 0;
  for (int t = 0; t < NUM_TABLES; ++t) slots += a.k[t];
  return 8 * slots * nw + 8 * a.width * nw + align16(slots * nw) + 4 * nw;
}

// Copy n bytes from global to shared memory with the block's threads, 16
// bytes a thread where both ends allow it, else 8, else 1.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src, int n) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                       static_cast<uintptr_t>(n);
  if ((al & 15) == 0) {
    for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  } else if ((al & 7) == 0) {
    for (int i = threadIdx.x; i < n / 8; i += blockDim.x)
      reinterpret_cast<int64_t*>(dst)[i] = reinterpret_cast<const int64_t*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void payload_kernel(StatePtrs S, int64_t* __restrict__ rows,
                               uint8_t* __restrict__ overflow_out, int64_t W, PayloadArgs a) {
  extern __shared__ __align__(16) int64_t payload_smem_raw[];
  const int64_t w0 = int64_t(blockIdx.x) * a.nw;
  const int nw = W - w0 < a.nw ? static_cast<int>(W - w0) : a.nw;
  int slots = 0, off[NUM_TABLES], row_off[NUM_TABLES];
  int r = 12 + 2 * a.out_kv;
  for (int t = 0; t < NUM_TABLES; ++t) {
    off[t] = slots;
    slots += a.k[t];
    row_off[t] = r;
    r += 1 + a.cap[t];
  }
  int64_t* ids = payload_smem_raw;                   // table t: [nw][k[t]] at off[t] * a.nw
  int64_t* out = ids + slots * a.nw;                 // [nw][width]
  uint8_t* occ = reinterpret_cast<uint8_t*>(out + a.width * a.nw);  // like ids
  int32_t* flag = reinterpret_cast<int32_t*>(occ + align16(slots * a.nw));

  // 1. stage the tables; the scalars and current branch, a thread a workflow
  for (int t = 0; t < NUM_TABLES; ++t) {
    const int k = a.k[t];
    stage(reinterpret_cast<uint8_t*>(ids + off[t] * a.nw),
          reinterpret_cast<const uint8_t*>(f64(S, table_ids(t)) + w0 * k), 8 * k * nw);
    stage(occ + off[t] * a.nw, fb(S, table_occ(t)) + w0 * k, k * nw);
  }
  for (int x = threadIdx.x; x < nw; x += blockDim.x) {
    const int64_t w = w0 + x;
    int64_t* row = out + x * a.width;
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
    cb = cb < 0 ? 0 : (cb > a.b - 1 ? a.b - 1 : cb);
    const int32_t count = f32(S, F_VH_COUNT)[w * a.b + cb];
    row[11] = count;
    flag[x] = count > a.out_kv ? 1 : 0;
    const int64_t vrow = (w * a.b + cb) * int64_t(a.kv);
    for (int k = 0; k < a.out_kv; ++k) {
      row[12 + 2 * k] = f64(S, F_VH_EVENT_IDS)[vrow + k];
      row[13 + 2 * k] = f64(S, F_VH_VERSIONS)[vrow + k];
    }
  }
  __syncthreads();

  // 2. the counts and the ranks, a thread an entry
  for (int j = threadIdx.x; j < nw * NUM_TABLES; j += blockDim.x) {
    const int x = j / NUM_TABLES, t = j % NUM_TABLES, k = a.k[t];
    const uint8_t* o = occ + off[t] * a.nw + x * k;
    int cnt = 0;
    for (int i = 0; i < k; ++i) cnt += o[i] ? 1 : 0;
    out[x * a.width + row_off[t]] = cnt;
    if (cnt > a.cap[t]) flag[x] = 1;
  }
  for (int t = 0; t < NUM_TABLES; ++t) {
    const int k = a.k[t];
    const int64_t* v_ids = ids + off[t] * a.nw;
    const uint8_t* v_occ = occ + off[t] * a.nw;
    for (int j = threadIdx.x; j < nw * k; j += blockDim.x) {
      const int x = j / k, i = j % k;
      const int64_t* id = v_ids + x * k;
      const uint8_t* oc = v_occ + x * k;
      const int64_t v = oc[i] ? id[i] : PAD;
      int rank = 0;
      for (int q = 0; q < k; ++q) {
        const int64_t u = oc[q] ? id[q] : PAD;
        rank += (u < v || (u == v && q < i)) ? 1 : 0;
      }
      if (rank < a.cap[t]) out[x * a.width + row_off[t] + 1 + rank] = v;
    }
  }
  __syncthreads();

  // 3. the rows and flags, contiguous in the output
  for (int i = threadIdx.x; i < nw * a.width; i += blockDim.x) rows[w0 * a.width + i] = out[i];
  for (int x = threadIdx.x; x < nw; x += blockDim.x) overflow_out[w0 + x] = flag[x] ? 1 : 0;
}

// The block's workflows for these capacities: the largest power of two up
// to PAYLOAD_MAX_WF whose shared memory fits PAYLOAD_SMEM_TARGET, else 1;
// 0 when even one workflow needs more than SMEM_LIMIT.
int payload_block(const PayloadArgs& a) {
  int nw = PAYLOAD_MAX_WF;
  while (nw > 1 && payload_smem(a, nw) > PAYLOAD_SMEM_TARGET) nw /= 2;
  return payload_smem(a, nw) <= SMEM_LIMIT ? nw : 0;
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
  PayloadArgs a{{caps[1], caps[0], caps[2], caps[4], caps[3]},
                {out_caps[1], out_caps[0], out_caps[2], out_caps[4], out_caps[3]},
                b, kv, out_kv, width, 0};
  if (W <= 0) return 0;
  a.nw = payload_block(a);
  if (a.nw == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = payload_smem(a, a.nw);
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(payload_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned blocks = static_cast<unsigned>((W + a.nw - 1) / a.nw);
  payload_kernel<<<blocks, PAYLOAD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      S, static_cast<int64_t*>(rows), static_cast<uint8_t*>(overflow), W, a);
  return static_cast<int>(cudaGetLastError());
}
