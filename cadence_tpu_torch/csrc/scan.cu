// Kernel J: vis_mask.  Kernel K: vis_topk.  Kernel L: vis_apply.
//
// The device visibility scans (row 14 of PERF.md's kernel table), which
// replace the JAX package's ops/scan.py:
//   - kernel J, `build_count` (:260) and `build_bitmap` (:273) with
//     `_tree_mask` (:228) and `_leaf_mask` (:201): the plan's predicate per
//     row, & valid, summed, and optionally packed 1 bit a row in numpy's
//     big bit order (row 8j is bit 7 of byte j);
//   - kernel K, `build_topk` (:288): lexsort((arange, -start, ~mask))[:k]
//     and the count: matching rows first, then -start ascending (the
//     negation wraps: a row with start INT64_MIN sorts first), then row
//     ascending;
//   - kernel L, `build_apply` (:310): `c.at[idx].set(v, mode="drop")` per
//     column, valid included.
//
// Kernel J design (redesigned for the H100 at the device view's launch
// shapes: a Count of 2^21 rows after each write of a burst, where the
// launch floor and dependent round trips, not bytes, set the time).
//   - The plan leaves the row's chain. The host decodes the postfix program
//     (ops/scan.py `program`) once: one entry a leaf instruction (its
//     column pointer, kind | op << 8 and parameter bits) and one byte an
//     instruction (tag | entry << 3). Up to J_PLAN_LEAVES leaves and
//     J_PLAN_INS instructions the plan is a __grid_constant__ kernel
//     parameter (ValuePlan): no table is copied to the card per query, and
//     a row's only loads are its valid byte and one value a leaf. A larger
//     plan takes the same kernel with the decoded plan as a device table
//     (TablePlan), a route ops/scan.py chooses before the launch.
//   - More bytes in flight. A warp takes tiles of 32 x J_ROWS rows; lane l
//     takes rows tile + l + 32 j (j < J_ROWS), so each j is one coalesced
//     warp load and one ballot, which is the bitmap's word. A lane loads
//     its J_ROWS valid bytes, then a leaf's J_ROWS values at its valid rows
//     as one batch, J_AHEAD leaves before it tests them (leaves are tested
//     in program order); a row that is not valid reads no column, as one
//     thread a row with `valid[row] && eval_row(...)` did before (the
//     view's capacity is half empty after a doubling). The tests are
//     branch-free (& not &&).
//   - One wave: the grid is the occupancy query's blocks a multiprocessor
//     times the multiprocessors (computed once a device), at most the
//     tiles, and a warp walks its tiles in a grid-stride loop.
//   - No memset: each block adds its count and a ticket to one scratch
//     word in one atomic (MaskScratch, zeroed once by its owner), and the
//     block whose ticket is the last writes the count and puts the word
//     back to 0, so a query is one launch and its last block waits for one
//     round trip. The sums are integers: deterministic.
//   - The evaluation stack is one uint64 a row (ops/scan.py `program` runs a
//     node's deeper child first, so 64 entries cover any plan of fewer
//     than 2^63 leaves); OP_FALSE and OP_TRUE are constant bits. Float
//     comparisons follow IEEE (NaN matches nothing; NE and PRESENT test
//     x == x): this file is compiled without --use_fast_math.
//   - The phases (a lane's rows, a warp's words and count, a block's
//     count and ticket, the last block's count out) are device functions above the
//     kernels, so that a host build runs them lane by lane
//     (tests/test_torch_scan.py -k host).
// Bound: bytes. N valid bytes and (valid rows) x 8 x distinct plan columns
// read, N/8 written for the bitmap; a dozen operations a leaf a row.
//
// Kernel K design: select, then sort. The order is the composite
// (!mask, key, row) with key = (uint64)(-start) ^ sign bit (-start negated
// in uint64_t, so unsigned order is the signed order of the wrapped
// negation). The k-th row lies in one part (the matches when k <= count,
// else the rest), and a radix select finds a composite bound H such that
// the rows of that part at or below H number at least k' (its rank there)
// and at most k' - 1 + K_CAP; the candidates are those rows, and every
// match when the k-th row is not one. Passes:
//   1. topk_scan_kernel, one streaming pass, one row a thread: the plan per
//      row (eval_row), the match count, a bitmap of the mask (a warp's ballot, N/8
//      bytes) and the least and greatest key of each part. Its last block
//      (a ticket counter) picks the part, k' and the first composite bit
//      that differs inside the part (real start times share their high
//      bits, so a fixed top digit would put every row in one bucket; equal
//      keys go straight to the row bits, which are distinct).
//   2. topk_hist_kernel, up to K_PASSES times: a K_DIGIT-bit digit of the
//      composite below the fixed prefix, histogrammed over the part's rows
//      that share the prefix (shared-memory bins, merged by atomics); its
//      last block finds the bucket that holds rank k', fixes the digit and
//      stops the passes once that bucket holds at most K_CAP rows. A pass
//      after that returns at once. Ties split by row, since the row is the
//      composite's low 32 bits.
//   3. topk_compact_kernel: the candidates (key, tag) into a buffer, a
//      warp's ballot and one atomic a warp (their order there is free: the
//      sort's order is total).
//   4. topk_sort_kernel, one block: a bitonic sort of the candidates in
//      shared memory (at most K_SORT_MAX), with `less`, and the first k ids.
// k above K_SELECT_MAX takes the full sort below (N a power of two): every
// row gets its (key, tag) pair, a bitonic sort of all N pairs, strides below
// a tile of 2,048 pairs in shared memory, larger ones one global pass each,
// and the first k tags are the ids.
// Bound: bytes, N x (8 x distinct plan columns + 1 + 8) read and k x 8
// written; the select's own passes re-read the start column and the bitmap
// (8.125 B a row each).
//
// Kernel K takes kernel J's decoded plan by the same two routes (ValuePlan
// by value, TablePlan past it) and tests it one row a thread (`eval_row`,
// with J's `leaf_test`).
//
// Kernel L design: a grid of (row blocks, columns); blockIdx.y is the
// column, so a block's column pointer and element size (8 or 1 bytes) are
// uniform and no thread divides. The delta comes as one packed block (the
// indices, then each column's values, 8-byte columns before 1-byte ones),
// which the view stages in one copy from one page-locked buffer; the
// columns' pointer table [C pointers][C element sizes][C value offsets]
// stays on the card until the columns change. A negative index wraps once,
// then an index outside [0, N) is dropped, as jnp's mode="drop" does. It
// writes the columns IN PLACE (at 2^24 rows the view's 24 columns hold 3.1
// GB, a copy per delta batch would double that); the JAX version returns
// new arrays. Duplicate indices are not taken: which value lands would be a
// race. The view never passes one (it scatters a set of changed rows).
// Bound: bytes, B x 8 index bytes read, and B x (element size) read and
// written for each column (a written row costs a 32-byte sector a column).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T_FALSE = 0, T_TRUE = 1, T_LEAF = 2, T_AND = 3, T_OR = 4;
constexpr int KIND_ID = 0, KIND_F64 = 2;
constexpr int OP_EQ = 2, OP_NE = 3, OP_LT = 4, OP_LE = 5, OP_GT = 6, OP_GE = 7;
constexpr int64_t NULL_ID = -1;

constexpr int J_THREADS = 256;
constexpr int J_ROWS = 4;           // rows a lane takes in a tile: lane + 32 j
constexpr int J_PLAN_LEAVES = 32;   // leaf instructions a by-value plan holds
constexpr int J_PLAN_INS = 64;      // instructions a by-value plan holds
constexpr int J_AHEAD = 1;          // leaves whose loads a lane has in flight
constexpr int J_TICKET_SHIFT = 40;  // the scratch word: tickets << 40 | count
constexpr int J_WARPS = J_THREADS / 32;
constexpr int J_TILE = 32 * J_ROWS;
constexpr int L_THREADS = 256;

// ---------------------------------------------------------------------------
// Kernel J's phases

// A plan decoded for the card, passed by value: entry e is the e-th leaf
// instruction's column, parameter (int64, or float64 bits) and kind | op << 8;
// instruction i is tag | entry << 3.
struct ValuePlan {
  int64_t col[J_PLAN_LEAVES];
  int64_t param[J_PLAN_LEAVES];
  int32_t code[J_PLAN_LEAVES];
  int32_t n_ins, n_entries;
  uint8_t ins[J_PLAN_INS];
  __device__ __forceinline__ int n() const { return n_ins; }
  __device__ __forceinline__ int entries() const { return n_entries; }
  __device__ __forceinline__ int instruction(int i) const { return ins[i]; }
  __device__ __forceinline__ const int64_t* column(int e) const {
    return reinterpret_cast<const int64_t*>(col[e]);
  }
  __device__ __forceinline__ int64_t parameter(int e) const { return param[e]; }
  __device__ __forceinline__ int kind_op(int e) const { return code[e]; }
};

// The same plan as a device table, for plans past ValuePlan's capacity:
// [entries columns][entries parameters][entries codes][n_ins instructions].
struct TablePlan {
  const int64_t* t;
  int n_entries, n_ins;
  __device__ __forceinline__ int n() const { return n_ins; }
  __device__ __forceinline__ int entries() const { return n_entries; }
  __device__ __forceinline__ int instruction(int i) const {
    return static_cast<int>(__ldg(t + 3 * n_entries + i));
  }
  __device__ __forceinline__ const int64_t* column(int e) const {
    return reinterpret_cast<const int64_t*>(__ldg(t + e));
  }
  __device__ __forceinline__ int64_t parameter(int e) const { return __ldg(t + n_entries + e); }
  __device__ __forceinline__ int kind_op(int e) const {
    return static_cast<int>(__ldg(t + 2 * n_entries + e));
  }
};

// One leaf's test of one value (its 64 bits), branch-free across lanes:
// the kind and op are the same for every row.
__device__ __forceinline__ bool leaf_test(int code, int64_t x, int64_t p) {
  const int kind = code & 0xff, op = code >> 8;
  if (kind == KIND_F64) {
    const double xf = __longlong_as_double(x), pf = __longlong_as_double(p);
    switch (op) {
      case OP_EQ: return xf == pf;
      case OP_NE: return (xf == xf) & (xf != pf);  // x == x: not NaN
      case OP_LT: return xf < pf;
      case OP_LE: return xf <= pf;
      case OP_GT: return xf > pf;
      case OP_GE: return xf >= pf;
      default: return xf == xf;  // OP_PRESENT
    }
  }
  if (kind == KIND_ID) {
    if (op == OP_EQ) return x == p;
    if (op == OP_NE) return (x != NULL_ID) & (x != p);
    return x != NULL_ID;  // OP_PRESENT
  }
  switch (op) {
    case OP_EQ: return x == p;
    case OP_NE: return x != p;
    case OP_LT: return x < p;
    case OP_LE: return x <= p;
    case OP_GT: return x > p;
    default: return x >= p;  // OP_GE
  }
}

// Entry e's values at a lane's live rows r0 + 32 j into x, when the plan
// has that entry (0 where the row is not valid: nothing is read there).
template <class Plan>
__device__ __forceinline__ void load_entry(const Plan& P, int e, int64_t r0,
                                           const uint32_t (&v)[J_ROWS], int64_t (&x)[J_ROWS]) {
  if (e >= P.entries()) return;
  const long long* col = reinterpret_cast<const long long*>(P.column(e));
#pragma unroll
  for (int j = 0; j < J_ROWS; ++j) x[j] = v[j] ? __ldg(col + r0 + 32 * j) : 0;
}

// A lane's rows r0 + 32 j (j < J_ROWS): the plan's predicate & valid. A row
// at or past N is false (N is a multiple of 64, so a warp's 32 rows of one
// j are all in or all out), and a row that is not valid reads no column
// (the view's capacity past its rows costs one byte a row). The e-th leaf
// instruction tests entry e, whose loads were issued J_AHEAD leaves before
// (at 1, right after the previous leaf's test: more entries in flight
// cost registers and, on the H100 at 2^21 rows, time; PERF.md).
template <class Plan>
__device__ __forceinline__ void lane_rows(const Plan& P, const uint8_t* __restrict__ valid,
                                          int64_t N, int64_t r0, bool (&m)[J_ROWS]) {
  uint32_t v[J_ROWS];
  uint64_t st[J_ROWS];
  int64_t x[J_AHEAD][J_ROWS];
#pragma unroll
  for (int j = 0; j < J_ROWS; ++j) {
    v[j] = r0 + 32 * j < N ? __ldg(valid + r0 + 32 * j) : 0u;
    st[j] = 0;
  }
#pragma unroll
  for (int a = 0; a < J_AHEAD; ++a) load_entry(P, a, r0, v, x[a]);
  const int n = P.n();
  int e = 0;
  for (int i = 0; i < n; ++i) {
    const int tag = P.instruction(i) & 7;
    if (tag == T_LEAF) {
      const int64_t p = P.parameter(e);
      const int code = P.kind_op(e);
#pragma unroll
      for (int j = 0; j < J_ROWS; ++j)
        st[j] = (st[j] << 1) | uint64_t(leaf_test(code, x[0][j], p));
#pragma unroll
      for (int a = 0; a + 1 < J_AHEAD; ++a)
#pragma unroll
        for (int j = 0; j < J_ROWS; ++j) x[a][j] = x[a + 1][j];
      load_entry(P, e + J_AHEAD, r0, v, x[J_AHEAD - 1]);
      ++e;
    } else if (tag == T_AND || tag == T_OR) {
#pragma unroll
      for (int j = 0; j < J_ROWS; ++j) {
        const uint64_t b = st[j] & 1;
        st[j] >>= 1;
        st[j] = tag == T_AND ? (st[j] & (~1ull | b)) : (st[j] | b);
      }
    } else {
#pragma unroll
      for (int j = 0; j < J_ROWS; ++j) st[j] = (st[j] << 1) | uint64_t(tag == T_TRUE);
    }
  }
#pragma unroll
  for (int j = 0; j < J_ROWS; ++j) m[j] = (v[j] != 0) & ((st[j] & 1) != 0);
}

// The plan's predicate on one row (valid not applied): kernel K's test, one
// row a thread, leaf by leaf in program order.
template <class Plan>
__device__ __forceinline__ bool eval_row(const Plan& P, int64_t row) {
  uint64_t st = 0;
  int e = 0;
  for (int i = 0; i < P.n(); ++i) {
    const int tag = P.instruction(i) & 7;
    if (tag == T_AND || tag == T_OR) {
      const uint64_t b = st & 1;
      st >>= 1;
      st = tag == T_AND ? (st & (~1ull | b)) : (st | b);
    } else {
      bool v = tag == T_TRUE;
      if (tag == T_LEAF) {
        const long long* col = reinterpret_cast<const long long*>(P.column(e));
        v = leaf_test(P.kind_op(e), __ldg(col + row), P.parameter(e));
        ++e;
      }
      st = (st << 1) | uint64_t(v);
    }
  }
  return st & 1;
}

// A warp's ballot of 32 rows as the bitmap's word, in numpy's big bit
// order: its bits reversed, its bytes swapped.
__device__ __forceinline__ uint32_t bitmap_word(unsigned bits) {
  return __byte_perm(__brev(bits), 0, 0x0123);
}

// A lane's share of its warp's tile (rows t0 .. t0 + J_TILE): lane j <
// J_ROWS stores word j of the bitmap, when there is one; returns the
// tile's count (the same in every lane).
__device__ __forceinline__ unsigned tile_out(const unsigned (&bits)[J_ROWS],
                                             uint32_t* __restrict__ bitmap, int64_t t0,
                                             int64_t N, int lane) {
  unsigned c = 0;
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < J_ROWS; ++j) {
    c += __popc(bits[j]);
    if (lane == j) mine = bitmap_word(bits[j]);
  }
  if (bitmap != nullptr && lane < J_ROWS && t0 + 32 * lane < N) bitmap[(t0 >> 5) + lane] = mine;
  return c;
}

// The tiles of warp w of block b in a grid of g blocks: w + J_WARPS b,
// then every J_WARPS g.
__device__ __forceinline__ int64_t first_tile(int b, int w) { return int64_t(b) * J_WARPS + w; }
__device__ __forceinline__ int64_t tile_step(int g) { return int64_t(g) * J_WARPS; }

// Blocks of a launch over N rows: one a J_WARPS tiles, at most max_blocks
// (one wave on the card).
__host__ __device__ inline int j_grid(int64_t N, int max_blocks) {
  int64_t b = (N + int64_t(J_TILE) * J_WARPS - 1) / (int64_t(J_TILE) * J_WARPS);
  if (b > max_blocks) b = max_blocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

// The count's scratch: one word, the blocks done << J_TICKET_SHIFT | their
// count so far (N < 2^31 rows, a grid under 2^24 blocks). Zeroed once by
// its owner (ops/scan.py); the last block puts it back to 0.
struct MaskScratch {
  unsigned long long word;
};

// Thread 0 of a block of a g-block grid: add its count and its ticket in
// one atomic; true in the block that finishes last, with the grid's total.
__device__ __forceinline__ bool block_partial(MaskScratch* s, int g, unsigned long long partial,
                                              unsigned long long* total) {
  const unsigned long long old = atomicAdd(&s->word, (1ull << J_TICKET_SHIFT) | partial);
  if ((old >> J_TICKET_SHIFT) != static_cast<unsigned long long>(g - 1)) return false;
  *total = (old & ((1ull << J_TICKET_SHIFT) - 1)) + partial;
  return true;
}

// The last block's thread 0: the count out, the scratch back to 0.
__device__ __forceinline__ void last_block_out(MaskScratch* s, unsigned long long total,
                                               unsigned long long* count) {
  *count = total;
  s->word = 0;
}

// ---------------------------------------------------------------------------
// Kernel L's unit: row b of the delta into column c. table: [C column
// pointers][C element sizes][C value offsets, bytes a row before column c];
// packed: [B int64 indices][each column's B values].
__device__ __forceinline__ void apply_unit(const int64_t* __restrict__ table, int C,
                                           const uint8_t* __restrict__ packed, int64_t B,
                                           int64_t N, int c, int64_t b) {
  if (b >= B) return;
  int64_t r = __ldg(reinterpret_cast<const long long*>(packed) + b);
  if (r < 0) r += N;
  if (r < 0 || r >= N) return;
  void* col = reinterpret_cast<void*>(__ldg(table + c));
  const uint8_t* val = packed + 8 * B + B * __ldg(table + 2 * C + c);
  if (__ldg(table + C + c) == 8)
    static_cast<long long*>(col)[r] = __ldg(reinterpret_cast<const long long*>(val) + b);
  else
    static_cast<uint8_t*>(col)[r] = __ldg(val + b);
}

// ---------------------------------------------------------------------------
// The kernels and their launchers (nvcc alone compiles what follows)

__global__ void __launch_bounds__(L_THREADS)
    vis_apply_kernel(const int64_t* __restrict__ table, int C, const uint8_t* __restrict__ packed,
                     int64_t B, int64_t N) {
  apply_unit(table, C, packed, B, N, blockIdx.y, int64_t(blockIdx.x) * L_THREADS + threadIdx.x);
}

template <class Plan>
__global__ void __launch_bounds__(J_THREADS)
    vis_mask_kernel(const __grid_constant__ Plan P, const uint8_t* __restrict__ valid, int64_t N,
                    MaskScratch* scratch, unsigned long long* count,
                    uint32_t* __restrict__ bitmap) {
  __shared__ unsigned long long warp_sum[J_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long c = 0;
  for (int64_t tile = first_tile(blockIdx.x, warp); tile * J_TILE < N;
       tile += tile_step(gridDim.x)) {
    const int64_t t0 = tile * J_TILE;
    bool m[J_ROWS];
    lane_rows(P, valid, N, t0 + lane, m);
    unsigned bits[J_ROWS];
#pragma unroll
    for (int j = 0; j < J_ROWS; ++j) bits[j] = __ballot_sync(0xffffffffu, m[j]);
    c += tile_out(bits, bitmap, t0, N, lane);
  }
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0, total = 0;
    for (int w = 0; w < J_WARPS; ++w) s += warp_sum[w];
    if (block_partial(scratch, gridDim.x, s, &total)) last_block_out(scratch, total, count);
  }
}

// Adds each warp's popcount (held by lane 0) into *count, one atomic a block.
__device__ __forceinline__ void add_block_count(unsigned long long c,
                                                unsigned long long* count) {
  __shared__ unsigned long long block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(&block_sum, c);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum) atomicAdd(count, block_sum);
}

constexpr int K_SCAN_THREADS = 256;
constexpr int K_SCAN_MAX_BLOCKS = 132 * 16;
constexpr int TILE = 2048;  // pairs sorted in shared memory by one block
constexpr uint64_t SIGN = 0x8000000000000000ull;
constexpr int K_DIGIT = 12;              // composite bits a histogram pass fixes
constexpr int K_BINS = 1 << K_DIGIT;
constexpr int64_t K_CAP = 4096;          // the boundary bucket the passes may leave
constexpr int K_SORT_MAX = 16384;        // candidates one block sorts
constexpr int64_t K_SELECT_MAX = K_SORT_MAX - K_CAP;  // larger k: the full sort
constexpr int K_PASSES = 8;              // ceil(96 / K_DIGIT): pos reaches 0
constexpr int K_SORT_THREADS = 1024;

// Kernel K's keys: ukey = (uint64)(-start) with the sign bit flipped,
// tag = (!mask) << 31 | row; and the match count.
template <class Plan>
__global__ void vis_keys_kernel(const __grid_constant__ Plan P,
                                const uint8_t* __restrict__ valid,
                                const int64_t* __restrict__ start, int64_t N,
                                uint64_t* __restrict__ ukey, uint32_t* __restrict__ tag,
                                unsigned long long* __restrict__ count) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  unsigned long long c = 0;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; row < N; row += stride) {
    const bool m = valid[row] && eval_row(P, row);
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) c += __popc(bits);
    ukey[row] = (0ull - static_cast<uint64_t>(start[row])) ^ SIGN;
    tag[row] = (m ? 0u : 0x80000000u) | static_cast<uint32_t>(row);
  }
  add_block_count(c, count);
}

// (mask bit, key, row) order: the tag's top bit is !mask, its low bits the row.
__device__ __forceinline__ bool less(uint64_t ua, uint32_t ta, uint64_t ub, uint32_t tb) {
  if ((ta ^ tb) >> 31) return ta < tb;
  if (ua != ub) return ua < ub;
  return ta < tb;
}

__device__ __forceinline__ void compare_swap(uint64_t& ua, uint32_t& ta, uint64_t& ub,
                                             uint32_t& tb, bool ascending) {
  if (less(ub, tb, ua, ta) == ascending) {
    const uint64_t u = ua;
    ua = ub;
    ub = u;
    const uint32_t t = ta;
    ta = tb;
    tb = t;
  }
}

// Bitonic steps inside tiles of `tile` pairs (one block a tile, tile/2
// threads): sizes size_from..size_to, each from stride min(size, tile)/2
// down to 1.
__global__ void bitonic_tile_kernel(uint64_t* __restrict__ ukey, uint32_t* __restrict__ tag,
                                    int tile, int64_t size_from, int64_t size_to) {
  __shared__ uint64_t su[TILE];
  __shared__ uint32_t st[TILE];
  const int64_t base = int64_t(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    su[i] = ukey[base + i];
    st[i] = tag[base + i];
  }
  for (int64_t size = size_from; size <= size_to; size <<= 1) {
    for (int stride = int((size < tile ? size : tile) / 2); stride > 0; stride >>= 1) {
      __syncthreads();
      const int t = threadIdx.x;
      const int i = 2 * t - (t & (stride - 1));
      compare_swap(su[i], st[i], su[i + stride], st[i + stride], ((base + i) & size) == 0);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    ukey[base + i] = su[i];
    tag[base + i] = st[i];
  }
}

// One bitonic step of `size` at `stride` (>= the tile) over all N pairs.
__global__ void bitonic_global_kernel(uint64_t* __restrict__ ukey, uint32_t* __restrict__ tag,
                                      int64_t half_n, int64_t size, int64_t stride) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= half_n) return;
  const int64_t i = 2 * t - (t & (stride - 1));
  const int64_t j = i + stride;
  uint64_t ua = ukey[i], ub = ukey[j];
  uint32_t ta = tag[i], tb = tag[j];
  const bool ascending = (i & size) == 0;
  if (less(ub, tb, ua, ta) == ascending) {
    ukey[i] = ub;
    ukey[j] = ua;
    tag[i] = tb;
    tag[j] = ta;
  }
}

__global__ void first_k_kernel(const uint32_t* __restrict__ tag, int64_t k,
                               int64_t* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < k) out[i] = tag[i] & 0x7fffffffu;
}

// ---------------------------------------------------------------------------
// Kernel K's select route

// The select's state, zeroed before pass 1 (a least key is kept as the
// greatest complement, so that zero starts every field).
struct Select {
  unsigned long long kmax[2], kmin_inv[2];  // per part: 0 the matches, 1 the rest
  unsigned long long pk;                    // the prefix's key bits
  long long need;                           // rank (from 1) of the k-th row in the bucket
  unsigned int pr;                          // the prefix's row bits
  unsigned int ticket;                      // blocks done with the current pass
  unsigned int n_cand;                      // candidates written
  int done, part, pos;                      // composite bits below pos are free
  unsigned int hist[K_BINS];
};

constexpr int K_HIST_THREADS = 1024;
constexpr int K_HIST_BLOCKS = 264;  // two a streaming multiprocessor of the H100
constexpr int K_HIST_PER = K_BINS / K_HIST_THREADS;

__device__ __forceinline__ uint64_t topk_key(const int64_t* start, int64_t row) {
  return (0ull - static_cast<uint64_t>(start[row])) ^ SIGN;
}

// Bits [lo, lo + d) of the composite key << 32 | row (d <= 32).
__device__ __forceinline__ uint32_t digit_of(uint64_t key, uint32_t row, int lo, int d) {
  const uint64_t v = lo >= 32 ? key >> (lo - 32) : (key << (32 - lo)) | (row >> lo);
  return static_cast<uint32_t>(v) & ((1u << d) - 1);
}

// Whether the composite agrees with the prefix (pk, pr) on every bit at or
// above pos.
__device__ __forceinline__ bool in_prefix(uint64_t key, uint32_t row, uint64_t pk,
                                          uint32_t pr, int pos) {
  if (pos >= 96) return true;
  if (pos >= 32) return (key >> (pos - 32)) == (pk >> (pos - 32));
  return key == pk && (row >> pos) == (pr >> pos);
}

// Whether the composite is at most the prefix with every free bit set.
__device__ __forceinline__ bool at_most(uint64_t key, uint32_t row, uint64_t pk, uint32_t pr,
                                        int pos) {
  const uint64_t hk = pos >= 96 ? ~0ull : pos > 32 ? pk | ((1ull << (pos - 32)) - 1) : pk;
  const uint32_t hr = pos >= 32 ? 0xffffffffu : pr | ((1u << pos) - 1);
  return key < hk || (key == hk && row <= hr);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(0xffffffffu, v, o);
    v = x > v ? x : v;
  }
  return v;
}

__device__ __forceinline__ unsigned long long volatile_read(const unsigned long long* p) {
  return *static_cast<const volatile unsigned long long*>(p);
}

// Pass 1: the plan per row, the count, the mask bitmap (bit j of word i is
// row 32i + j) and each part's least and greatest key; the last block
// starts the select.
template <class Plan>
__global__ void topk_scan_kernel(const __grid_constant__ Plan P,
                                 const uint8_t* __restrict__ valid,
                                 const int64_t* __restrict__ start, int64_t N, int64_t k,
                                 Select* sel, uint32_t* __restrict__ bits,
                                 unsigned long long* count) {
  __shared__ unsigned long long red[5];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 5) red[threadIdx.x] = 0;
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  unsigned long long c = 0, max0 = 0, max1 = 0, inv0 = 0, inv1 = 0;
  // N is a multiple of 64: a warp's 32 rows are all in range or all out
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; row < N; row += stride) {
    const bool m = valid[row] && eval_row(P, row);
    const unsigned b = __ballot_sync(0xffffffffu, m);
    if (lane == 0) {
      c += __popc(b);
      bits[row >> 5] = b;
    }
    const uint64_t key = topk_key(start, row);
    if (m) {
      max0 = key > max0 ? key : max0;
      inv0 = ~key > inv0 ? ~key : inv0;
    } else {
      max1 = key > max1 ? key : max1;
      inv1 = ~key > inv1 ? ~key : inv1;
    }
  }
  max0 = warp_max(max0);
  max1 = warp_max(max1);
  inv0 = warp_max(inv0);
  inv1 = warp_max(inv1);
  if (lane == 0) {
    atomicMax(&red[0], max0);
    atomicMax(&red[1], max1);
    atomicMax(&red[2], inv0);
    atomicMax(&red[3], inv1);
    if (c) atomicAdd(&red[4], c);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMax(&sel->kmax[0], red[0]);
    atomicMax(&sel->kmax[1], red[1]);
    atomicMax(&sel->kmin_inv[0], red[2]);
    atomicMax(&sel->kmin_inv[1], red[3]);
    if (red[4]) atomicAdd(count, red[4]);
    __threadfence();
    last = atomicAdd(&sel->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const long long cnt = static_cast<long long>(volatile_read(count));
  const int part = k <= cnt ? 0 : 1;
  const long long n_part = part ? N - cnt : cnt;
  const uint64_t lo = ~volatile_read(&sel->kmin_inv[part]);
  const uint64_t hi = volatile_read(&sel->kmax[part]);
  int pos;
  uint64_t pk;
  if (lo != hi) {  // the first differing key bit; the bits above it are fixed
    const int hb = 64 - __clzll(static_cast<long long>(lo ^ hi));
    pos = 32 + hb;
    pk = hb >= 64 ? 0 : lo & ~((1ull << hb) - 1);
  } else {  // one key: the row bits alone differ
    pos = N > 1 ? 32 - __clz(static_cast<int>(N - 1)) : 0;
    pk = lo;
  }
  sel->part = part;
  sel->need = part ? k - cnt : k;
  sel->pos = pos;
  sel->pk = pk;
  sel->pr = 0;
  sel->done = n_part <= K_CAP || pos == 0;
  sel->ticket = 0;
}

// Pass 2: one digit's histogram over the part's rows in the bucket; the
// last block fixes the digit of the bucket that holds rank `need`.
__global__ void __launch_bounds__(K_HIST_THREADS)
    topk_hist_kernel(const int64_t* __restrict__ start, const uint32_t* __restrict__ bits,
                     int64_t N, Select* sel) {
  __shared__ unsigned int h[K_BINS];
  __shared__ long long wsum[K_HIST_THREADS / 32];
  __shared__ bool last;
  if (sel->done) return;
  const int part = sel->part, pos = sel->pos;
  const uint64_t pk = sel->pk;
  const uint32_t pr = sel->pr;
  const int d = pos < K_DIGIT ? pos : K_DIGIT, lo = pos - d;
  for (int i = threadIdx.x; i < K_BINS; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; row < N; row += stride) {
    const bool m = (__ldg(bits + (row >> 5)) >> (row & 31)) & 1u;
    if (m != (part == 0)) continue;
    const uint64_t key = topk_key(start, row);
    if (in_prefix(key, static_cast<uint32_t>(row), pk, pr, pos))
      atomicAdd(&h[digit_of(key, static_cast<uint32_t>(row), lo, d)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K_BINS; i += blockDim.x)
    if (h[i]) atomicAdd(&sel->hist[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sel->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: an inclusive scan of the bins, K_HIST_PER a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned int v[K_HIST_PER];
  long long mine = 0;
#pragma unroll
  for (int j = 0; j < K_HIST_PER; ++j) {
    v[j] = __ldcg(sel->hist + threadIdx.x * K_HIST_PER + j);
    mine += v[j];
  }
  long long x = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long y = wsum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    wsum[lane] = y;
  }
  __syncthreads();
  const long long incl = x + (warp ? wsum[warp - 1] : 0);
  const long long need = sel->need;
  if (incl - mine < need && need <= incl) {  // one thread: its bins hold rank `need`
    long long below = incl - mine;
    int j = 0;
    while (below + v[j] < need) below += v[j++];
    const uint32_t b = static_cast<uint32_t>(threadIdx.x * K_HIST_PER + j);
    uint64_t npk = pk;
    uint32_t npr = pr;
    if (lo >= 32) {
      npk |= static_cast<uint64_t>(b) << (lo - 32);
    } else {
      npr |= static_cast<uint32_t>(static_cast<uint64_t>(b) << lo);
      npk |= static_cast<uint64_t>(b) >> (32 - lo);
    }
    sel->pk = npk;
    sel->pr = npr;
    sel->need = need - below;
    sel->pos = lo;
    sel->done = v[j] <= K_CAP || lo == 0;
  }
  for (int i = threadIdx.x; i < K_BINS; i += blockDim.x) sel->hist[i] = 0;
  if (threadIdx.x == 0) sel->ticket = 0;
}

// Pass 3: the candidates' (key, tag) pairs, tag = (!mask) << 31 | row.
__global__ void topk_compact_kernel(const int64_t* __restrict__ start,
                                    const uint32_t* __restrict__ bits, int64_t N, Select* sel,
                                    uint64_t* __restrict__ ckey, uint32_t* __restrict__ ctag) {
  const int lane = threadIdx.x & 31;
  const int part = sel->part, pos = sel->pos;
  const uint64_t pk = sel->pk;
  const uint32_t pr = sel->pr;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; row < N; row += stride) {
    const bool m = (__ldg(bits + (row >> 5)) >> (row & 31)) & 1u;
    uint64_t key = 0;
    bool cand = false;
    if (m || part == 1) {
      key = topk_key(start, row);
      cand = (m && part == 1) ||
             (m == (part == 0) && at_most(key, static_cast<uint32_t>(row), pk, pr, pos));
    }
    const unsigned b = __ballot_sync(0xffffffffu, cand);
    if (!b) continue;
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(&sel->n_cand, static_cast<unsigned>(__popc(b)));
    base = __shfl_sync(0xffffffffu, base, 0);
    const unsigned i = base + __popc(b & ((1u << lane) - 1));
    if (cand && i < K_SORT_MAX) {  // the select leaves at most k - 1 + K_CAP
      ckey[i] = key;
      ctag[i] = (m ? 0u : 0x80000000u) | static_cast<uint32_t>(row);
    }
  }
}

// Pass 4: sort the candidates in shared memory; the first k tags' rows out.
__global__ void __launch_bounds__(K_SORT_THREADS)
    topk_sort_kernel(const Select* sel, const uint64_t* __restrict__ ckey,
                     const uint32_t* __restrict__ ctag, int64_t k, int64_t* __restrict__ out) {
  extern __shared__ uint64_t sort_smem[];
  uint64_t* su = sort_smem;
  uint32_t* st = reinterpret_cast<uint32_t*>(sort_smem + K_SORT_MAX);
  const int n = sel->n_cand < K_SORT_MAX ? static_cast<int>(sel->n_cand) : K_SORT_MAX;
  int np = 2;
  while (np < n) np <<= 1;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    su[i] = i < n ? ckey[i] : ~0ull;  // pads sort after every row
    st[i] = i < n ? ctag[i] : ~0u;
  }
  for (int size = 2; size <= np; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < np / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        compare_swap(su[i], st[i], su[i + stride], st[i + stride], (i & size) == 0);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) out[i] = st[i] & 0x7fffffffu;
}

// Kernel K's streaming passes: one row a thread, at most
// K_SCAN_MAX_BLOCKS blocks in a grid-stride loop.
unsigned k_scan_blocks(int64_t N) {
  const int64_t blocks = (N + K_SCAN_THREADS - 1) / K_SCAN_THREADS;
  return static_cast<unsigned>(blocks < K_SCAN_MAX_BLOCKS ? blocks : K_SCAN_MAX_BLOCKS);
}

// Kernel J's grid bound on the current device: the occupancy query's blocks
// a multiprocessor times the multiprocessors (one wave), asked once a
// device and instance.
template <class Plan>
cudaError_t j_max_blocks(int* out) {
  static int cache[64];  // 0: not asked yet
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return rc;
    if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vis_mask_kernel<Plan>,
                                                            J_THREADS, 0)) != cudaSuccess)
      return rc;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cache[dev];
  return cudaSuccess;
}

template <class Plan>
int launch_mask(const Plan& P, const void* valid, int64_t N, void* count, void* bitmap,
                void* scratch, void* stream) {
  if (N <= 0 || N % 64) return static_cast<int>(cudaErrorInvalidValue);
  int max_blocks = 0;
  cudaError_t rc = j_max_blocks<Plan>(&max_blocks);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  vis_mask_kernel<Plan><<<j_grid(N, max_blocks), J_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const uint8_t*>(valid), N, static_cast<MaskScratch*>(scratch),
      static_cast<unsigned long long*>(count), static_cast<uint32_t*>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

// Whether a host ValuePlan is one decode_plan made: within its capacity,
// its leaf instructions naming entries 0, 1, ... in order.
bool value_plan_ok(const ValuePlan& P) {
  if (P.n_ins <= 0 || P.n_ins > J_PLAN_INS || P.n_entries < 0 || P.n_entries > J_PLAN_LEAVES)
    return false;
  int e = 0;
  for (int i = 0; i < P.n_ins; ++i)
    if ((P.ins[i] & 7) == T_LEAF && (P.ins[i] >> 3) != e++) return false;
  return e == P.n_entries;
}

// Kernel K's passes, by the route k takes, for a plan of either form.
template <class Plan>
int launch_topk(const Plan& P, const void* valid, const void* start, int64_t N, int64_t k,
                void* scratch, void* out, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int64_t), s);
  if (rc != cudaSuccess || N <= 0) return static_cast<int>(rc);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int64_t* st = static_cast<const int64_t*>(start);
  if (k <= K_SELECT_MAX) {
    Select* sel = static_cast<Select*>(scratch);
    uint32_t* bits = reinterpret_cast<uint32_t*>(sel + 1);
    uint64_t* ckey = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(bits) + N / 8);
    uint32_t* ctag = reinterpret_cast<uint32_t*>(ckey + K_SORT_MAX);
    if ((rc = cudaMemsetAsync(sel, 0, sizeof(Select), s)) != cudaSuccess)
      return static_cast<int>(rc);
    const int sort_smem = K_SORT_MAX * static_cast<int>(sizeof(uint64_t) + sizeof(uint32_t));
    rc = cudaFuncSetAttribute(topk_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sort_smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    topk_scan_kernel<Plan><<<k_scan_blocks(N), K_SCAN_THREADS, 0, s>>>(
        P, v, st, N, k, sel, bits, static_cast<unsigned long long*>(count));
    for (int pass = 0; pass < K_PASSES; ++pass)
      topk_hist_kernel<<<K_HIST_BLOCKS, K_HIST_THREADS, 0, s>>>(st, bits, N, sel);
    topk_compact_kernel<<<k_scan_blocks(N), K_SCAN_THREADS, 0, s>>>(st, bits, N, sel, ckey,
                                                                   ctag);
    topk_sort_kernel<<<1, K_SORT_THREADS, sort_smem, s>>>(sel, ckey, ctag, k,
                                                          static_cast<int64_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  uint64_t* u = static_cast<uint64_t*>(scratch);
  uint32_t* t = reinterpret_cast<uint32_t*>(u + N);
  vis_keys_kernel<Plan><<<k_scan_blocks(N), K_SCAN_THREADS, 0, s>>>(
      P, v, st, N, u, t, static_cast<unsigned long long*>(count));
  const int tile = static_cast<int>(N < TILE ? N : TILE);
  const unsigned tiles = static_cast<unsigned>(N / tile);
  bitonic_tile_kernel<<<tiles, tile / 2, 0, s>>>(u, t, tile, 2, tile);
  const int64_t half = N / 2;
  const unsigned gblocks = static_cast<unsigned>((half + 255) / 256);
  for (int64_t size = int64_t(tile) * 2; size <= N; size <<= 1) {
    for (int64_t stride = size / 2; stride >= tile; stride >>= 1)
      bitonic_global_kernel<<<gblocks, 256, 0, s>>>(u, t, half, size, stride);
    bitonic_tile_kernel<<<tiles, tile / 2, 0, s>>>(u, t, tile, size, size);
  }
  first_k_kernel<<<static_cast<unsigned>((k + 255) / 256), 256, 0, s>>>(
      t, k, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel J, the plan by value. plan: a host ValuePlan (copied into the
// launch); valid: [N] bool; N a multiple of 64; count: int64 scalar;
// bitmap: [N/8] uint8, or null for a count alone; scratch: a MaskScratch
// (8 bytes) zeroed once, used by one stream at a time.
extern "C" int cadence_vis_mask(const void* plan, const void* valid, int64_t N, void* count,
                                void* bitmap, void* scratch, void* stream) {
  const ValuePlan& P = *static_cast<const ValuePlan*>(plan);
  if (!value_plan_ok(P)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mask(P, valid, N, count, bitmap, scratch, stream);
}

// Kernel J, the plan as a device table (TablePlan: entries leaf entries,
// n_ins instructions); the rest as cadence_vis_mask.
extern "C" int cadence_vis_mask_table(const void* table, int entries, int n_ins,
                                      const void* valid, int64_t N, void* count, void* bitmap,
                                      void* scratch, void* stream) {
  if (n_ins <= 0 || entries < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mask(TablePlan{static_cast<const int64_t*>(table), entries, n_ins}, valid, N,
                     count, bitmap, scratch, stream);
}

// Kernel K's scratch bytes for N rows and k: the select's state, the mask
// bitmap and the candidates; or, above K_SELECT_MAX, a key and a tag a row.
extern "C" int64_t cadence_vis_topk_scratch(int64_t N, int64_t k) {
  if (k > K_SELECT_MAX) return N * (sizeof(uint64_t) + sizeof(uint32_t));
  return sizeof(Select) + N / 8 + K_SORT_MAX * (sizeof(uint64_t) + sizeof(uint32_t));
}

// Kernel K, the plan by value (a host ValuePlan, as cadence_vis_mask).
// start: [N] int64; N a multiple of 64 (a power of two for k above
// K_SELECT_MAX); k in [1, N]; scratch: the bytes cadence_vis_topk_scratch
// gives, 8-byte aligned; out: [k] int64 row ids; count: int64 scalar.
extern "C" int cadence_vis_topk(const void* plan, const void* valid, const void* start, int64_t N,
                                int64_t k, void* scratch, void* out, void* count, void* stream) {
  const ValuePlan& P = *static_cast<const ValuePlan*>(plan);
  if (!value_plan_ok(P)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_topk(P, valid, start, N, k, scratch, out, count, stream);
}

// Kernel K, the plan as a device table (as cadence_vis_mask_table); the
// rest as cadence_vis_topk.
extern "C" int cadence_vis_topk_table(const void* table, int entries, int n_ins,
                                      const void* valid, const void* start, int64_t N, int64_t k,
                                      void* scratch, void* out, void* count, void* stream) {
  if (n_ins <= 0 || entries < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_topk(TablePlan{static_cast<const int64_t*>(table), entries, n_ins}, valid, start,
                     N, k, scratch, out, count, stream);
}

// Kernel L. table: [C column pointers][C element sizes, 8 or 1][C value
// offsets, bytes a row before each column's values] on the card; packed:
// [B int64 indices, distinct once wrapped][each column's B values] on the
// card; N: column length.
extern "C" int cadence_vis_apply(const void* table, int C, const void* packed, int64_t B,
                                 int64_t N, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (C > 65535 || (B + L_THREADS - 1) / L_THREADS > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((B + L_THREADS - 1) / L_THREADS),
                  static_cast<unsigned>(C));
  vis_apply_kernel<<<grid, L_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), C, static_cast<const uint8_t*>(packed), B, N);
  return static_cast<int>(cudaGetLastError());
}
