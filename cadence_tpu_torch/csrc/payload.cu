// Kernel B: payload, with its fit and counts epilogues.
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
// fits PAYLOAD_SMEM_TARGET (block_workflows); K is taken at run time.
//
// The three phases are one schedule, payload_block, whose step visitor
// runs each phase's threads and then meets them at a barrier: the kernel's
// runs its thread's part and __syncthreads(), a host build's (the CPU
// tests) the block's threads in turn.
//
// Epilogues. Two more outputs, each asked for by the launch (its pointer
// null when not, the same for every block of a launch), take the place of
// the kernels each path launched on the same state just after this one:
// - fit, [W] bool: the JAX package's ops/state.py `narrow_ok` against the
//   output layout (kernel H's function). Its branch part (state.cuh
//   `branches_fit`) is the workflow's thread's in phase 1, beside the
//   current branch it reads already; its table part (no occupied slot at
//   or past the output capacity) the (workflow, table) thread's in phase 2,
//   from the occupancy staged in shared memory. It is not the overflow
//   flag: overflow tests counts, fit tests slot positions and every branch.
// - counts, [2] int64: rows with error != 0 and rows with close_status !=
//   0, the JAX package's parallel/mesh.py per-shard stats (kernel F's
//   function). Phase 1 reads the two [W] int32 fields; in phase 3 thread 0
//   sums its block's pair, adds it to a running total in `scratch` (one
//   64-bit atomic, the errors in the low half), then takes a ticket; the
//   block that takes the last ticket writes the [2] and leaves the total
//   and the ticket at 0 for the next launch. The wrapper keeps one scratch
//   a device and stream, so launches on a stream never share one at once:
//   no memset and no second launch.
//
// Bound. Bytes: the table IDs and occupancies, the current branch's
// version-history row and the scalars are read once, and 8 * width + 1
// bytes are written a workflow (about 725 B read and 712 B written at the
// default layout); the K^2 compares of the ranks run on shared memory. The
// fit epilogue reads the other branches' counts (4 B a branch) and writes
// a byte, the counts epilogue reads 8 B a workflow and writes 16 B.
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
  int b, kv, out_b, out_kv, width;
  int nw;               // workflows a block
};

// What a launch reads and writes; fit, and counts with its scratch, are
// null when their epilogue is not asked for.
struct PayloadIO {
  StatePtrs S;
  int64_t* rows;                // [W, width]
  uint8_t* overflow;            // [W] bool
  uint8_t* fit;                 // [W] bool
  int64_t* counts;              // [2]: rows with an error, rows closed
  unsigned long long* scratch;  // [2]: the running total, the ticket; 0 between launches
  int64_t W;
};

// A workflow's four flag bytes in shared memory.
enum Flag { FLAG_OVERFLOW = 0, FLAG_UNFIT, FLAG_ERROR, FLAG_CLOSED, FLAGS };

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// Shared memory of a block of nw workflows: the ID slabs (sum K x nw int64),
// the rows (width x nw int64), the occupancy slabs (sum K x nw bytes), the
// flags (FLAGS x nw bytes).
__host__ __device__ __forceinline__ int payload_smem(const PayloadArgs& a, int nw) {
  int slots = 0;
  for (int t = 0; t < NUM_TABLES; ++t) slots += a.k[t];
  return 8 * slots * nw + 8 * a.width * nw + align16(slots * nw) + FLAGS * nw;
}

// The block's workflows for these capacities: the largest power of two up
// to PAYLOAD_MAX_WF whose shared memory fits PAYLOAD_SMEM_TARGET, else 1;
// 0 when even one workflow needs more than SMEM_LIMIT.
int block_workflows(const PayloadArgs& a) {
  int nw = PAYLOAD_MAX_WF;
  while (nw > 1 && payload_smem(a, nw) > PAYLOAD_SMEM_TARGET) nw /= 2;
  return payload_smem(a, nw) <= SMEM_LIMIT ? nw : 0;
}

// caps / out_caps are in state-layout order: activities, timers, children,
// request-cancels, signals.
PayloadArgs payload_args(const int* caps, int b, int kv, const int* out_caps, int out_b,
                         int out_kv, int width) {
  PayloadArgs a{{caps[1], caps[0], caps[2], caps[4], caps[3]},
                {out_caps[1], out_caps[0], out_caps[2], out_caps[4], out_caps[3]},
                b, kv, out_b, out_kv, width, 0};
  a.nw = block_workflows(a);
  return a;
}

StatePtrs state_ptrs(const void* ptr_table) {
  StatePtrs S;
  const uint64_t* table = static_cast<const uint64_t*>(ptr_table);
  for (int i = 0; i < NUM_FIELDS; ++i) S.p[i] = reinterpret_cast<void*>(table[i]);
  return S;
}

// Copy n bytes from global to shared memory with the block's threads (this
// one is tid), 16 bytes a thread where both ends allow it, else 8, else 1.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src, int n, int tid) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                       static_cast<uintptr_t>(n);
  if ((al & 15) == 0) {
    for (int i = tid; i < n / 16; i += PAYLOAD_THREADS)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  } else if ((al & 7) == 0) {
    for (int i = tid; i < n / 8; i += PAYLOAD_THREADS)
      reinterpret_cast<int64_t*>(dst)[i] = reinterpret_cast<const int64_t*>(src)[i];
  } else {
    for (int i = tid; i < n; i += PAYLOAD_THREADS) dst[i] = src[i];
  }
}

// A block's workflows and where their slabs, rows and flags lie in its
// shared memory.
struct Block {
  int64_t w0;
  int nw;
  int off[NUM_TABLES], row_off[NUM_TABLES];
  int64_t* ids;  // table t: [nw][k[t]] at off[t] * a.nw
  int64_t* out;  // [nw][width]
  uint8_t* occ;  // like ids
  uint8_t* flag;  // [nw][FLAGS]
};

__device__ __forceinline__ Block block_of(const PayloadArgs& a, int64_t W, int64_t block,
                                          int64_t* smem) {
  Block k;
  k.w0 = block * a.nw;
  k.nw = W - k.w0 < a.nw ? static_cast<int>(W - k.w0) : a.nw;
  int slots = 0, r = 12 + 2 * a.out_kv;
  for (int t = 0; t < NUM_TABLES; ++t) {
    k.off[t] = slots;
    slots += a.k[t];
    k.row_off[t] = r;
    r += 1 + a.cap[t];
  }
  k.ids = smem;
  k.out = k.ids + slots * a.nw;
  k.occ = reinterpret_cast<uint8_t*>(k.out + a.width * a.nw);
  k.flag = k.occ + align16(slots * a.nw);
  return k;
}

// 1. Stage the tables; the scalars, the current branch and its
// version-history pairs and the flags, a thread a workflow.
__device__ inline void stage_phase(const PayloadIO& io, const PayloadArgs& a, const Block& k,
                                   int tid) {
  const StatePtrs& S = io.S;
  for (int t = 0; t < NUM_TABLES; ++t) {
    const int kt = a.k[t];
    stage(reinterpret_cast<uint8_t*>(k.ids + k.off[t] * a.nw),
          reinterpret_cast<const uint8_t*>(f64(S, table_ids(t)) + k.w0 * kt), 8 * kt * k.nw, tid);
    stage(k.occ + k.off[t] * a.nw, fb(S, table_occ(t)) + k.w0 * kt, kt * k.nw, tid);
  }
  for (int x = tid; x < k.nw; x += PAYLOAD_THREADS) {
    const int64_t w = k.w0 + x;
    int64_t* row = k.out + x * a.width;
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
    const int32_t branch = f32(S, F_CURRENT_BRANCH)[w];
    const int cb = branch < 0 ? 0 : (branch > a.b - 1 ? a.b - 1 : branch);
    const int32_t* vh_count = f32(S, F_VH_COUNT) + w * a.b;
    const int32_t count = vh_count[cb];
    row[11] = count;
    uint8_t* flag = k.flag + FLAGS * x;
    flag[FLAG_OVERFLOW] = count > a.out_kv ? 1 : 0;
    flag[FLAG_UNFIT] = io.fit && !branches_fit(branch, vh_count, a.b, a.out_b, a.out_kv);
    flag[FLAG_ERROR] = io.counts && f32(S, F_ERROR)[w] != 0;
    flag[FLAG_CLOSED] = io.counts && f32(S, F_CLOSE_STATUS)[w] != 0;
    const int64_t vrow = (w * a.b + cb) * int64_t(a.kv);
    for (int j = 0; j < a.out_kv; ++j) {
      row[12 + 2 * j] = f64(S, F_VH_EVENT_IDS)[vrow + j];
      row[13 + 2 * j] = f64(S, F_VH_VERSIONS)[vrow + j];
    }
  }
}

// 2. The counts (and the fit epilogue's table part), a thread a (workflow,
// table); the ranks, a thread an entry.
__device__ inline void rank_phase(const PayloadIO& io, const PayloadArgs& a, const Block& k,
                                  int tid) {
  for (int j = tid; j < k.nw * NUM_TABLES; j += PAYLOAD_THREADS) {
    const int x = j / NUM_TABLES, t = j % NUM_TABLES, kt = a.k[t];
    const uint8_t* o = k.occ + k.off[t] * a.nw + x * kt;
    int cnt = 0;
    for (int i = 0; i < kt; ++i) cnt += o[i] ? 1 : 0;
    k.out[x * a.width + k.row_off[t]] = cnt;
    if (cnt > a.cap[t]) k.flag[FLAGS * x + FLAG_OVERFLOW] = 1;
    if (io.fit)
      for (int i = a.cap[t]; i < kt; ++i)
        if (o[i]) k.flag[FLAGS * x + FLAG_UNFIT] = 1;
  }
  for (int t = 0; t < NUM_TABLES; ++t) {
    const int kt = a.k[t];
    const int64_t* v_ids = k.ids + k.off[t] * a.nw;
    const uint8_t* v_occ = k.occ + k.off[t] * a.nw;
    for (int j = tid; j < k.nw * kt; j += PAYLOAD_THREADS) {
      const int x = j / kt, i = j % kt;
      const int64_t* id = v_ids + x * kt;
      const uint8_t* oc = v_occ + x * kt;
      const int64_t v = oc[i] ? id[i] : PAD;
      int rank = 0;
      for (int q = 0; q < kt; ++q) {
        const int64_t u = oc[q] ? id[q] : PAD;
        rank += (u < v || (u == v && q < i)) ? 1 : 0;
      }
      if (rank < a.cap[t]) k.out[x * a.width + k.row_off[t] + 1 + rank] = v;
    }
  }
}

// The counts epilogue's last step, thread 0 of each block: add the block's
// pair (errors low, closed high) to the running total, then take a ticket;
// the block that takes the last one writes the [2] counts and leaves the
// total and the ticket at 0.
__device__ inline void add_counts(const PayloadIO& io, unsigned long long pair, int64_t blocks) {
  atomicAdd(io.scratch, pair);
  __threadfence();  // the total before the ticket, as the last block reads them
  if (atomicAdd(io.scratch + 1, 1ull) + 1 == static_cast<unsigned long long>(blocks)) {
    __threadfence();
    const unsigned long long total = atomicExch(io.scratch, 0ull);
    io.counts[0] = static_cast<int64_t>(total & 0xffffffffull);
    io.counts[1] = static_cast<int64_t>(total >> 32);
    atomicExch(io.scratch + 1, 0ull);
  }
}

// 3. The rows and flags, contiguous in the output; the block's counts.
__device__ inline void store_phase(const PayloadIO& io, const PayloadArgs& a, const Block& k,
                                   int64_t blocks, int tid) {
  for (int i = tid; i < k.nw * a.width; i += PAYLOAD_THREADS)
    io.rows[k.w0 * a.width + i] = k.out[i];
  for (int x = tid; x < k.nw; x += PAYLOAD_THREADS) {
    io.overflow[k.w0 + x] = k.flag[FLAGS * x + FLAG_OVERFLOW];
    if (io.fit) io.fit[k.w0 + x] = k.flag[FLAGS * x + FLAG_UNFIT] ? 0 : 1;
  }
  if (io.counts && tid == 0) {
    unsigned long long pair = 0;
    for (int x = 0; x < k.nw; ++x)
      pair += k.flag[FLAGS * x + FLAG_ERROR] |
              static_cast<unsigned long long>(k.flag[FLAGS * x + FLAG_CLOSED]) << 32;
    add_counts(io, pair, blocks);
  }
}

// Block `block` of `blocks`, the same schedule on the card and in a host
// build: step(fn) runs fn(tid) for each of the block's PAYLOAD_THREADS
// threads, then meets them at a barrier.
template <class Step>
__device__ inline void payload_block(const PayloadIO& io, const PayloadArgs& a, int64_t* smem,
                                     int64_t block, int64_t blocks, Step step) {
  const Block k = block_of(a, io.W, block, smem);
  step([&](int tid) { stage_phase(io, a, k, tid); });
  step([&](int tid) { rank_phase(io, a, k, tid); });
  step([&](int tid) { store_phase(io, a, k, blocks, tid); });
}

// The kernel and its launcher (nvcc only).

// A step of payload_block on the card: this thread's part, then the barrier.
struct BlockStep {
  template <class F>
  __device__ void operator()(F fn) const {
    fn(static_cast<int>(threadIdx.x));
    __syncthreads();
  }
};

// The parameters are __grid_constant__: the schedule takes them by
// reference, which would otherwise copy them to each thread's stack.
__global__ void payload_kernel(const __grid_constant__ PayloadIO io,
                               const __grid_constant__ PayloadArgs a) {
  extern __shared__ __align__(16) int64_t payload_smem_raw[];
  payload_block(io, a, payload_smem_raw, blockIdx.x, gridDim.x, BlockStep{});
}

}  // namespace
}  // namespace cadence

// caps / out_caps are in state-layout order: activities, timers, children,
// request-cancels, signals. fit ([W] bool) and counts ([2] int64, with its
// [2] scratch, zero between launches) are null when not asked for.
extern "C" int cadence_payload(const void* ptr_table, void* rows, void* overflow, int64_t W,
                               const int* caps, int b, int kv, const int* out_caps, int out_kv,
                               int width, int out_b, void* fit, void* counts, void* scratch,
                               void* stream) {
  using namespace cadence;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts != nullptr && (scratch == nullptr || W > int64_t(0xffffffff)))
    return static_cast<int>(cudaErrorInvalidValue);  // the running total packs two 32-bit counts
  if (W <= 0)
    return counts == nullptr ? 0 : static_cast<int>(cudaMemsetAsync(counts, 0, 16, s));
  const PayloadArgs a = payload_args(caps, b, kv, out_caps, out_b, out_kv, width);
  if (a.nw == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = payload_smem(a, a.nw);
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(payload_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const PayloadIO io{state_ptrs(ptr_table), static_cast<int64_t*>(rows),
                     static_cast<uint8_t*>(overflow), static_cast<uint8_t*>(fit),
                     static_cast<int64_t*>(counts), static_cast<unsigned long long*>(scratch), W};
  const unsigned blocks = static_cast<unsigned>((W + a.nw - 1) / a.nw);
  payload_kernel<<<blocks, PAYLOAD_THREADS, smem, s>>>(io, a);
  return static_cast<int>(cudaGetLastError());
}
