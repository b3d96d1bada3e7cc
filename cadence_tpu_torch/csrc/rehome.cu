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
// Design. The work is flattened to (field, row, unit), so that no memory
// operation waits on another field's. The host (cadence_rehome) derives from
// the two layouts each field's units a row and its first block, a prefix of
// the 66 fields passed by value with the field table; each block finds its
// field by a binary search of that prefix, and its threads walk (row, unit)
// of that field, a row's units contiguous, so a warp's loads and stores of
// one field coalesce. A field copied at the same capacity (the serving
// gather and write-back, a slab's growth) moves whole rows in units of 16
// bytes where its row bytes and both pointers allow (8, 4, 2 or 1 where
// they do not); a field whose capacity changes (a widen or a narrow) moves
// an element a unit, slots past the source capacity taking the init value.
// A thread moves G_ITEMS units (one: more blocks, each shorter, were
// faster on the H100 than four a thread), each unit's load issued before
// any store, through __restrict__ pointers, so at up to a few hundred rows
// the launch is one wave of about two dependent memory round trips (the
// row index, then the data), whatever the number of fields. Source and
// destination never overlap (no caller re-homes a state into itself).
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

constexpr int G_THREADS = 128;              // threads a block
constexpr int G_ITEMS = 1;                  // units a thread
constexpr int G_UNITS = G_THREADS * G_ITEMS;  // units a block
constexpr int H_THREADS = 256;

// Per-field constants: the init value and element bytes the wrapper derives
// from init_state, and the work table the host derives from the layouts.
struct FieldTable {
  int64_t init[NUM_FIELDS];
  int32_t first_block[NUM_FIELDS + 1];  // a prefix: field f's blocks start here
  int32_t units[NUM_FIELDS];            // units an out row
  int8_t size[NUM_FIELDS];              // element bytes: 1 (bool), 4 or 8
  int8_t unit[NUM_FIELDS];              // unit bytes: 1, 2, 4, 8 or 16
  int8_t whole[NUM_FIELDS];             // 1: same capacity, rows move whole
};

// A field's per-row shape as [a, b]: scalars [1, 1], tables [1, K],
// version-history items [B, Kv], vh_count [1, B].
__host__ __device__ __forceinline__ void dims(int f, const Caps& c, int& a, int& b) {
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

// `init` cut to `size` bytes and repeated over 8 bytes (little-endian).
__device__ __forceinline__ uint64_t repeat(int64_t init, int size) {
  const uint64_t v = static_cast<uint64_t>(init);
  if (size == 1) return (v & 0xffull) * 0x0101010101010101ull;
  if (size == 2) return (v & 0xffffull) * 0x0001000100010001ull;
  if (size == 4) return (v & 0xffffffffull) * 0x0000000100000001ull;
  return v;
}

template <class T>
__device__ __forceinline__ T unit_of(uint64_t rep);
template <>
__device__ __forceinline__ uint4 unit_of<uint4>(uint64_t rep) {
  const unsigned lo = static_cast<unsigned>(rep), hi = static_cast<unsigned>(rep >> 32);
  return make_uint4(lo, hi, lo, hi);
}
template <>
__device__ __forceinline__ unsigned long long unit_of<unsigned long long>(uint64_t rep) {
  return rep;
}
template <>
__device__ __forceinline__ unsigned unit_of<unsigned>(uint64_t rep) {
  return static_cast<unsigned>(rep);
}
template <>
__device__ __forceinline__ unsigned short unit_of<unsigned short>(uint64_t rep) {
  return static_cast<unsigned short>(rep);
}
template <>
__device__ __forceinline__ unsigned char unit_of<unsigned char>(uint64_t rep) {
  return static_cast<unsigned char>(rep);
}

// The block's units of field f, [base, base + G_UNITS) of its n * units:
// unit u is row r = u / units, unit k = u % units of that row. T is the
// unit's type (its bytes are ft.unit[f]).
template <class T>
__device__ __forceinline__ void move_units(const StatePtrs& src, const Caps& cin,
                                           const StatePtrs& dst, const Caps& cout,
                                           const int64_t* __restrict__ src_rows,
                                           const int64_t* __restrict__ dst_rows, uint32_t n,
                                           const FieldTable& ft, int f, uint32_t base) {
  const T* __restrict__ in = static_cast<const T*>(src.p[f]);
  T* __restrict__ out = static_cast<T*>(dst.p[f]);
  const uint32_t units = static_cast<uint32_t>(ft.units[f]);
  const uint32_t total = n * units;
  const T init = unit_of<T>(repeat(ft.init[f], ft.size[f]));
  const bool whole = ft.whole[f] != 0;
  int a_in, b_in, a_out, b_out;
  dims(f, cin, a_in, b_in);
  dims(f, cout, a_out, b_out);
  T v[G_ITEMS];
  int64_t at[G_ITEMS];
#pragma unroll
  for (int j = 0; j < G_ITEMS; ++j) {
    const uint32_t u = base + threadIdx.x + j * G_THREADS;
    v[j] = init;
    at[j] = -1;
    if (u < total) {
      const uint32_t r = u / units;
      const uint32_t k = u - r * units;
      const int64_t s = src_rows[r];
      at[j] = dst_rows[r] * units + k;
      if (whole) {
        if (s >= 0) v[j] = in[s * units + k];
      } else {
        const int x = static_cast<int>(k) / b_out;
        const int y = static_cast<int>(k) - x * b_out;
        if (s >= 0 && x < a_in && y < b_in) v[j] = in[(s * a_in + x) * b_in + y];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G_ITEMS; ++j)
    if (at[j] >= 0) out[at[j]] = v[j];
}

__global__ void __launch_bounds__(G_THREADS)
    rehome_kernel(StatePtrs src, Caps cin, StatePtrs dst, Caps cout,
                  const int64_t* __restrict__ src_rows, const int64_t* __restrict__ dst_rows,
                  uint32_t n, FieldTable ft) {
  // this block's field: the last f whose first block is at most blockIdx.x
  int lo = 0, hi = NUM_FIELDS - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ft.first_block[mid] <= static_cast<int>(blockIdx.x))
      lo = mid;
    else
      hi = mid - 1;
  }
  const int f = lo;
  const uint32_t base = (blockIdx.x - static_cast<uint32_t>(ft.first_block[f])) * G_UNITS;
  switch (ft.unit[f]) {
    case 16:
      move_units<uint4>(src, cin, dst, cout, src_rows, dst_rows, n, ft, f, base);
      break;
    case 8:
      move_units<unsigned long long>(src, cin, dst, cout, src_rows, dst_rows, n, ft, f, base);
      break;
    case 4:
      move_units<unsigned>(src, cin, dst, cout, src_rows, dst_rows, n, ft, f, base);
      break;
    case 2:
      move_units<unsigned short>(src, cin, dst, cout, src_rows, dst_rows, n, ft, f, base);
      break;
    default:
      move_units<unsigned char>(src, cin, dst, cout, src_rows, dst_rows, n, ft, f, base);
      break;
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

// Kernel G's work table: for each field, its unit (16 bytes where a row
// copied whole at the same capacity and both pointers allow, else the
// largest of 8, 4, 2 and 1 that does; the element where the capacity
// changes), its units an out row and its first block. Returns the blocks of
// the launch, or -1 when a field's units pass 2^32 (the kernel counts them
// in 32 bits).
int64_t work_table(const StatePtrs& S, const Caps& ci, const StatePtrs& D, const Caps& co,
                   int64_t n, FieldTable& ft) {
  int64_t blocks = 0;
  for (int f = 0; f < NUM_FIELDS; ++f) {
    int ai, bi, ao, bo;
    dims(f, ci, ai, bi);
    dims(f, co, ao, bo);
    const int size = ft.size[f];
    const int64_t row = int64_t(ao) * bo * size;
    const bool whole = ai == ao && bi == bo;
    int unit = size;
    if (whole) {
      const uint64_t sp = reinterpret_cast<uint64_t>(S.p[f]);
      const uint64_t dp = reinterpret_cast<uint64_t>(D.p[f]);
      for (int ub = 16; ub > size; ub >>= 1)
        if (row % ub == 0 && sp % ub == 0 && dp % ub == 0) {
          unit = ub;
          break;
        }
    }
    const int64_t units = whole ? row / unit : int64_t(ao) * bo;
    if (units * n >= (int64_t(1) << 32)) return -1;
    ft.unit[f] = static_cast<int8_t>(unit);
    ft.whole[f] = whole ? 1 : 0;
    ft.units[f] = static_cast<int32_t>(units);
    ft.first_block[f] = static_cast<int32_t>(blocks);
    blocks += (units * n + G_UNITS - 1) / G_UNITS;
  }
  ft.first_block[NUM_FIELDS] = static_cast<int32_t>(blocks);
  return blocks;
}

}  // namespace

// Kernel G. src/dst: state pointer tables (csrc/state.cuh order) at the
// capacities cin (K[5], b, kv) and cout; src_rows/dst_rows: n int64 device
// indices (src -1: an init row; dst rows distinct); init/sizes: the field
// table, NUM_FIELDS entries each.
extern "C" int cadence_rehome(const void* src_table, const int* cin, int cin_b, int cin_kv,
                              const void* dst_table, const int* cout, int cout_b, int cout_kv,
                              const void* src_rows, const void* dst_rows, int64_t n,
                              const int64_t* init, const int* sizes, void* stream) {
  if (n <= 0) return 0;
  FieldTable ft;
  for (int f = 0; f < cadence::NUM_FIELDS; ++f) {
    ft.init[f] = init[f];
    ft.size[f] = static_cast<int8_t>(sizes[f]);
  }
  const StatePtrs S = state_from(src_table), D = state_from(dst_table);
  const Caps ci = caps_from(cin, cin_b, cin_kv), co = caps_from(cout, cout_b, cout_kv);
  const int64_t blocks = work_table(S, ci, D, co, n, ft);
  if (blocks < 0 || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rehome_kernel<<<static_cast<unsigned>(blocks), G_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(S, ci, D, co,
                                                       static_cast<const int64_t*>(src_rows),
                                                       static_cast<const int64_t*>(dst_rows),
                                                       static_cast<uint32_t>(n), ft);
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
