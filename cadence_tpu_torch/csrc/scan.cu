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
// The plan (ops/scan.py `program`) arrives as one int64 table on the card:
// the column pointers, then one word per postfix instruction
// (T_LEAF | kind << 8 | op << 16 | slot << 24 | leaf << 40, or a constant,
// AND or OR tag), then the leaves' int64 parameters and float64
// parameters (as bits). Every thread reads the same words, so the loads
// are broadcasts that stay in L1.
//
// Kernel J design: one thread a row, a grid-stride loop in which each warp
// takes 32 consecutive rows. The evaluation stack is one uint64 register
// (ops/scan.py `program` orders each node's deeper child first, so 64 entries cover
// any plan of fewer than 2^63 leaves); OP_FALSE and OP_TRUE are constant
// bits, so `_tree_mask`'s None/True folding is plain boolean algebra. The
// warp's __ballot_sync of its 32 mask bits is the bitmap word: its bits
// reversed (__brev) and its bytes swapped give numpy's order, and lane 0
// stores it as one uint32. The count is the ballots' __popc summed per
// block in shared memory and one 64-bit atomicAdd a block into a counter
// zeroed first on the same stream: integers, so deterministic. Float
// comparisons follow IEEE (NaN matches nothing; NE and PRESENT test
// x == x): this file is compiled without --use_fast_math.
// Bound: bytes. N x (8 x distinct plan columns + 1) read, N/8 written for
// the bitmap; a dozen operations a leaf a row.
//
// Kernel K design, the simple route that is right: every row gets a sort
// key (mask bit, -start, row) as a uint64 (-start negated in uint64_t,
// sign bit flipped, so unsigned order is the signed order of the wrapped
// negation) and a uint32 tag ((!mask) << 31 | row); N is a power of two,
// so a bitonic sort of all N pairs orders them, and the first k tags give
// the ids. Strides below a tile of 2,048 pairs run in shared memory, larger
// ones as one global pass each (91 global and 14 tile passes at N = 2^24),
// then the first k tags are written out. Sorting all N rows to keep k is
// the slowness a later PR removes (a per-tile top-k and merge).
// Bound: bytes, N x (8 x distinct plan columns + 1 + 8) read and k x 8
// written; the sort's traffic is the kernel's own.
//
// Kernel L design: one thread per (index, column), the columns' element
// sizes (8 or 1 bytes) from the table. A negative index wraps once, then an
// index outside [0, N) is dropped, as jnp's mode="drop" does. It writes the
// columns IN PLACE (at 2^24 rows the view's 24 columns hold 3.1 GB, a copy
// per delta batch would double that); the JAX version returns new arrays.
// Duplicate indices are not taken: which value lands would be a race. The
// view never passes one (it scatters a set of changed rows).
// Bound: bytes, B x 8 index bytes read, and B x (element size) read and
// written for each column.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T_FALSE = 0, T_TRUE = 1, T_LEAF = 2, T_AND = 3, T_OR = 4;
constexpr int KIND_ID = 0, KIND_F64 = 2;
constexpr int OP_EQ = 2, OP_NE = 3, OP_LT = 4, OP_LE = 5, OP_GT = 6, OP_GE = 7;
constexpr int64_t NULL_ID = -1;

constexpr int J_THREADS = 256;
constexpr int J_MAX_BLOCKS = 132 * 16;
constexpr int TILE = 2048;  // pairs sorted in shared memory by one block
constexpr uint64_t SIGN = 0x8000000000000000ull;

struct Program {
  const int64_t* cols;  // column pointers
  const int64_t* ins;   // postfix words
  const int64_t* ip;    // int64 parameters, one a leaf
  const double* fp;     // float64 parameters, one a leaf
  int n_ins;
};

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

Program program_from(const void* table, int n_cols, int n_ins, int n_leaves) {
  const int64_t* t = static_cast<const int64_t*>(table);
  return Program{t, t + n_cols, t + n_cols + n_ins,
                 reinterpret_cast<const double*>(t + n_cols + n_ins + n_leaves), n_ins};
}

__device__ __forceinline__ bool leaf(const Program& P, int64_t w, int64_t row) {
  const int kind = int((w >> 8) & 0xff);
  const int op = int((w >> 16) & 0xff);
  const int slot = int((w >> 24) & 0xffff);
  const int64_t li = w >> 40;
  const void* col = reinterpret_cast<const void*>(ld64(P.cols + slot));
  if (kind == KIND_F64) {
    const double x = __ldg(static_cast<const double*>(col) + row);
    const double p = __ldg(P.fp + li);
    switch (op) {
      case OP_EQ: return x == p;
      case OP_NE: return x == x && x != p;  // x == x: not NaN
      case OP_LT: return x < p;
      case OP_LE: return x <= p;
      case OP_GT: return x > p;
      case OP_GE: return x >= p;
      default: return x == x;  // OP_PRESENT
    }
  }
  const int64_t x = ld64(static_cast<const int64_t*>(col) + row);
  const int64_t p = ld64(P.ip + li);
  if (kind == KIND_ID) {
    if (op == OP_EQ) return x == p;
    if (op == OP_NE) return x != NULL_ID && x != p;
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

// The plan's predicate on one row (valid not applied).
__device__ __forceinline__ bool eval_row(const Program& P, int64_t row) {
  uint64_t st = 0;
  for (int i = 0; i < P.n_ins; ++i) {
    const int64_t w = ld64(P.ins + i);
    const int tag = int(w & 0xff);
    if (tag == T_AND || tag == T_OR) {
      const uint64_t b = st & 1;
      st >>= 1;
      st = tag == T_AND ? (st & (~1ull | b)) : (st | b);
    } else {
      const bool v = tag == T_LEAF ? leaf(P, w, row) : tag == T_TRUE;
      st = (st << 1) | uint64_t(v);
    }
  }
  return st & 1;
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

__global__ void vis_mask_kernel(Program P, const uint8_t* __restrict__ valid, int64_t N,
                                unsigned long long* __restrict__ count,
                                uint32_t* __restrict__ bitmap) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  unsigned long long c = 0;
  // N is a multiple of 64: a warp's 32 rows are all in range or all out
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; row < N; row += stride) {
    const bool m = valid[row] && eval_row(P, row);
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if (lane == 0) {
      c += __popc(bits);
      if (bitmap) bitmap[row >> 5] = __byte_perm(__brev(bits), 0, 0x0123);
    }
  }
  add_block_count(c, count);
}

// Kernel K's keys: ukey = (uint64)(-start) with the sign bit flipped,
// tag = (!mask) << 31 | row; and the match count.
__global__ void vis_keys_kernel(Program P, const uint8_t* __restrict__ valid,
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

__global__ void vis_apply_kernel(const int64_t* __restrict__ table, int C,
                                 const int64_t* __restrict__ idx, int64_t B, int64_t N) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * C) return;
  const int c = int(t / B);
  const int64_t b = t - c * B;
  int64_t r = idx[b];
  if (r < 0) r += N;
  if (r < 0 || r >= N) return;
  void* col = reinterpret_cast<void*>(table[c]);
  const void* val = reinterpret_cast<const void*>(table[C + c]);
  if (table[2 * C + c] == 8)
    static_cast<int64_t*>(col)[r] = static_cast<const int64_t*>(val)[b];
  else
    static_cast<uint8_t*>(col)[r] = static_cast<const uint8_t*>(val)[b];
}

unsigned mask_blocks(int64_t N) {
  const int64_t blocks = (N + J_THREADS - 1) / J_THREADS;
  return static_cast<unsigned>(blocks < J_MAX_BLOCKS ? blocks : J_MAX_BLOCKS);
}

}  // namespace

// Kernel J. table: the program (see above); valid: [N] bool; N a multiple
// of 64; count: int64 scalar; bitmap: [N/8] uint8, or null for a count
// alone.
extern "C" int cadence_vis_mask(const void* table, int n_cols, int n_ins, int n_leaves,
                                const void* valid, int64_t N, void* count, void* bitmap,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int64_t), s);
  if (rc != cudaSuccess || N <= 0) return static_cast<int>(rc);
  vis_mask_kernel<<<mask_blocks(N), J_THREADS, 0, s>>>(
      program_from(table, n_cols, n_ins, n_leaves), static_cast<const uint8_t*>(valid), N,
      static_cast<unsigned long long*>(count), static_cast<uint32_t*>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

// Kernel K. As kernel J, plus start: [N] int64; N a power of two; k in
// [1, N]; ukey/tag: [N] uint64 and uint32 scratch; out: [k] int64 row ids.
extern "C" int cadence_vis_topk(const void* table, int n_cols, int n_ins, int n_leaves,
                                const void* valid, const void* start, int64_t N, int64_t k,
                                void* ukey, void* tag, void* out, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int64_t), s);
  if (rc != cudaSuccess || N <= 0) return static_cast<int>(rc);
  uint64_t* u = static_cast<uint64_t*>(ukey);
  uint32_t* t = static_cast<uint32_t*>(tag);
  vis_keys_kernel<<<mask_blocks(N), J_THREADS, 0, s>>>(
      program_from(table, n_cols, n_ins, n_leaves), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(start), N, u, t, static_cast<unsigned long long*>(count));
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

// Kernel L. table: [C column pointers][C value pointers][C element sizes]
// on the card; idx: [B] int64 (distinct once wrapped); N: column length.
extern "C" int cadence_vis_apply(const void* table, int C, const void* idx, int64_t B,
                                 int64_t N, void* stream) {
  const int64_t n = B * C;
  if (n <= 0) return 0;
  vis_apply_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), C, static_cast<const int64_t*>(idx), B, N);
  return static_cast<int>(cudaGetLastError());
}
