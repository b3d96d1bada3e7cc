// Kernel G: rehome.  Kernel H: narrow_ok.
//
// Kernel G replaces every re-homing of ReplayState rows in the JAX package
// (row 10 of PERF.md's kernel table): ops/state.py `widen_state` and
// `narrow_state`, engine/resident.py `_stack_states` and `_slice_row`
// (`extract_row`), and engine/ladder.py's pad concatenate and survivor
// gather in `escalate_resident`. Each of those is one jitted pytree
// program over the 66 state tensors there; here it is one launch that
// writes, for every out row i, dst[dst_rows[i]] from src[src_rows[i]]:
//   - a slot whose index is below the source capacity on every axis
//     copies the source value;
//   - any other slot (past the source capacity: a widen), and every slot
//     of a row whose source is -1 (an init row), gets the field's value in
//     ops/state.init_state: occupancy false, PAD for version-history
//     items, 0 for counts and table fields, the scalar defaults;
//   - slots past the destination capacity are dropped (a narrow).
// The resident pool's slabs (engine/resident.py) are destinations and
// sources of the same launch: admit scatters rows into slab slots,
// append gathers them into a batch, growth copies a slab into one twice
// its size.
//
// Design: one warp per out row (eight rows a block), whose lanes stride
// over each field's elements of that row in field order, so a warp's
// loads and stores of one field are contiguous. The per-field element size
// and init value come from the wrapper (ops/rehome.py, derived from
// init_state); which capacity shapes each field comes from csrc/state.cuh's
// field order. Simple on purpose: most fields hold 1 to 16 elements, so
// many lanes idle; making it fast is later work.
//
// Bound: bytes. Each out row reads at most its source row and writes its
// destination row (3,602 B each at the base layout); no arithmetic to
// speak of.
//
// Kernel H computes ops/state.py `narrow_ok` exactly: one thread per
// workflow, a [W] bool that the row fits the narrow layout (current
// branch below B, no version history on a branch at or past B, no
// branch with more than Kv items, no occupied table slot at or past the
// narrow capacity). It reads about 70 bytes a row. It stays out of kernel
// A's epilogue, which runs at 136-152 registers.
#include <cstdint>
#include <cuda_runtime.h>

#include "state.cuh"

namespace {

using namespace cadence;

constexpr int ROWS_PER_BLOCK = 8;
constexpr int H_THREADS = 256;

// Per-field constants the wrapper derives from init_state.
struct FieldTable {
  int64_t init[NUM_FIELDS];
  int8_t size[NUM_FIELDS];  // bytes per element: 1 (bool), 4 or 8
};

// A field's per-row shape as [a, b]: scalars [1, 1], tables [1, K],
// version-history items [B, Kv], vh_count [1, B].
__device__ __forceinline__ void dims(int f, const Caps& c, int& a, int& b) {
  a = 1;
  b = 1;
  if (f == F_VH_EVENT_IDS || f == F_VH_VERSIONS) {
    a = c.b;
    b = c.kv;
  } else if (f == F_VH_COUNT) {
    b = c.b;
  } else if (f >= F_ACT_OCC && f < F_TMR_OCC) {
    b = c.ka;
  } else if (f >= F_TMR_OCC && f < F_CH_OCC) {
    b = c.kt;
  } else if (f >= F_CH_OCC && f < F_RC_OCC) {
    b = c.kc;
  } else if (f >= F_RC_OCC && f < F_SG_OCC) {
    b = c.kr;
  } else if (f >= F_SG_OCC && f < F_ERROR) {
    b = c.ks;
  }
}

__device__ __forceinline__ int64_t load(const void* p, int size, int64_t i) {
  if (size == 8) return static_cast<const int64_t*>(p)[i];
  if (size == 4) return static_cast<const int32_t*>(p)[i];
  return static_cast<const uint8_t*>(p)[i];
}

__device__ __forceinline__ void store(void* p, int size, int64_t i, int64_t v) {
  if (size == 8)
    static_cast<int64_t*>(p)[i] = v;
  else if (size == 4)
    static_cast<int32_t*>(p)[i] = static_cast<int32_t>(v);
  else
    static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(v);
}

__global__ void rehome_kernel(StatePtrs src, Caps cin, StatePtrs dst, Caps cout,
                              const int64_t* __restrict__ src_rows,
                              const int64_t* __restrict__ dst_rows, int64_t n, FieldTable ft) {
  const int lane = threadIdx.x & 31;
  const int64_t i = int64_t(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t s = src_rows[i];
  const int64_t d = dst_rows[i];
  for (int f = 0; f < NUM_FIELDS; ++f) {
    int a_in, b_in, a_out, b_out;
    dims(f, cin, a_in, b_in);
    dims(f, cout, a_out, b_out);
    const int size = ft.size[f];
    const int n_out = a_out * b_out;
    const int64_t in_base = s * int64_t(a_in) * b_in;
    const int64_t out_base = d * int64_t(n_out);
    for (int e = lane; e < n_out; e += 32) {
      const int x = e / b_out;
      const int y = e - x * b_out;
      int64_t v = ft.init[f];
      if (s >= 0 && x < a_in && y < b_in) v = load(src.p[f], size, in_base + x * b_in + y);
      store(dst.p[f], size, out_base + e, v);
    }
  }
}

__device__ __forceinline__ bool occupied_past(const StatePtrs& S, int f, int64_t w, int k_in,
                                              int k_out) {
  const uint8_t* occ = fb(S, f) + w * k_in;
  for (int k = k_out; k < k_in; ++k)
    if (occ[k]) return true;
  return false;
}

__global__ void narrow_ok_kernel(StatePtrs S, Caps cin, Caps cout, uint8_t* __restrict__ out,
                                 int64_t W) {
  const int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= W) return;
  bool ok = f32(S, F_CURRENT_BRANCH)[w] < cout.b;
  const int32_t* count = f32(S, F_VH_COUNT) + w * cin.b;
  for (int b = 0; b < cin.b; ++b) {
    const int32_t c = count[b];
    if ((b >= cout.b && c != 0) || c > cout.kv) ok = false;
  }
  if (occupied_past(S, F_ACT_OCC, w, cin.ka, cout.ka) ||
      occupied_past(S, F_TMR_OCC, w, cin.kt, cout.kt) ||
      occupied_past(S, F_CH_OCC, w, cin.kc, cout.kc) ||
      occupied_past(S, F_RC_OCC, w, cin.kr, cout.kr) ||
      occupied_past(S, F_SG_OCC, w, cin.ks, cout.ks))
    ok = false;
  out[w] = ok ? 1 : 0;
}

StatePtrs state_from(const void* ptr_table) {
  StatePtrs S;
  const uint64_t* table = static_cast<const uint64_t*>(ptr_table);
  for (int i = 0; i < NUM_FIELDS; ++i) S.p[i] = reinterpret_cast<void*>(table[i]);
  return S;
}

Caps caps_from(const int* k, int b, int kv) { return Caps{k[0], k[1], k[2], k[3], k[4], b, kv}; }

}  // namespace

// Kernel G. src/dst: state pointer tables (csrc/state.cuh order) at the
// capacities cin (K[5], b, kv) and cout; src_rows/dst_rows: n int64 device
// indices (src -1: an init row; dst rows distinct); init/sizes: the field
// table, NUM_FIELDS entries each.
extern "C" int cadence_rehome(const void* src_table, const int* cin, int cin_b, int cin_kv,
                              const void* dst_table, const int* cout, int cout_b, int cout_kv,
                              const void* src_rows, const void* dst_rows, int64_t n,
                              const int64_t* init, const int* sizes, void* stream) {
  FieldTable ft;
  for (int f = 0; f < cadence::NUM_FIELDS; ++f) {
    ft.init[f] = init[f];
    ft.size[f] = static_cast<int8_t>(sizes[f]);
  }
  if (n <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  rehome_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      state_from(src_table), caps_from(cin, cin_b, cin_kv), state_from(dst_table),
      caps_from(cout, cout_b, cout_kv), static_cast<const int64_t*>(src_rows),
      static_cast<const int64_t*>(dst_rows), n, ft);
  return static_cast<int>(cudaGetLastError());
}

// Kernel H. The state at capacities cin, the narrow capacities cout; out:
// [W] bool.
extern "C" int cadence_narrow_ok(const void* ptr_table, const int* cin, int cin_b, int cin_kv,
                                 const int* cout, int cout_b, int cout_kv, void* out, int64_t W,
                                 void* stream) {
  if (W <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((W + H_THREADS - 1) / H_THREADS);
  narrow_ok_kernel<<<blocks, H_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      state_from(ptr_table), caps_from(cin, cin_b, cin_kv), caps_from(cout, cout_b, cout_kv),
      static_cast<uint8_t*>(out), W);
  return static_cast<int>(cudaGetLastError());
}
