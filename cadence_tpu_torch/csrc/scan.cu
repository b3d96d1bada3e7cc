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
// Kernel K design: select, then sort. The order is the composite
// (!mask, key, row) with key = (uint64)(-start) ^ sign bit (-start negated
// in uint64_t, so unsigned order is the signed order of the wrapped
// negation). The k-th row lies in one part (the matches when k <= count,
// else the rest), and a radix select finds a composite bound H such that
// the rows of that part at or below H number at least k' (its rank there)
// and at most k' - 1 + K_CAP; the candidates are those rows, and every
// match when the k-th row is not one. Passes:
//   1. topk_scan_kernel, one streaming pass as kernel J's: the plan per
//      row, the match count, a bitmap of the mask (a warp's ballot, N/8
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
constexpr int K_DIGIT = 12;              // composite bits a histogram pass fixes
constexpr int K_BINS = 1 << K_DIGIT;
constexpr int64_t K_CAP = 4096;          // the boundary bucket the passes may leave
constexpr int K_SORT_MAX = 16384;        // candidates one block sorts
constexpr int64_t K_SELECT_MAX = K_SORT_MAX - K_CAP;  // larger k: the full sort
constexpr int K_PASSES = 8;              // ceil(96 / K_DIGIT): pos reaches 0
constexpr int K_SORT_THREADS = 1024;

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
__global__ void topk_scan_kernel(Program P, const uint8_t* __restrict__ valid,
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

// Kernel K's scratch bytes for N rows and k: the select's state, the mask
// bitmap and the candidates; or, above K_SELECT_MAX, a key and a tag a row.
extern "C" int64_t cadence_vis_topk_scratch(int64_t N, int64_t k) {
  if (k > K_SELECT_MAX) return N * (sizeof(uint64_t) + sizeof(uint32_t));
  return sizeof(Select) + N / 8 + K_SORT_MAX * (sizeof(uint64_t) + sizeof(uint32_t));
}

// Kernel K. As kernel J, plus start: [N] int64; N a multiple of 64 (a power
// of two for k above K_SELECT_MAX); k in [1, N]; scratch: the bytes
// cadence_vis_topk_scratch gives, 8-byte aligned; out: [k] int64 row ids.
extern "C" int cadence_vis_topk(const void* table, int n_cols, int n_ins, int n_leaves,
                                const void* valid, const void* start, int64_t N, int64_t k,
                                void* scratch, void* out, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int64_t), s);
  if (rc != cudaSuccess || N <= 0) return static_cast<int>(rc);
  const Program P = program_from(table, n_cols, n_ins, n_leaves);
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
    topk_scan_kernel<<<mask_blocks(N), J_THREADS, 0, s>>>(
        P, v, st, N, k, sel, bits, static_cast<unsigned long long*>(count));
    for (int pass = 0; pass < K_PASSES; ++pass)
      topk_hist_kernel<<<K_HIST_BLOCKS, K_HIST_THREADS, 0, s>>>(st, bits, N, sel);
    topk_compact_kernel<<<mask_blocks(N), J_THREADS, 0, s>>>(st, bits, N, sel, ckey, ctag);
    topk_sort_kernel<<<1, K_SORT_THREADS, sort_smem, s>>>(sel, ckey, ctag, k,
                                                          static_cast<int64_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  uint64_t* u = static_cast<uint64_t*>(scratch);
  uint32_t* t = reinterpret_cast<uint32_t*>(u + N);
  vis_keys_kernel<<<mask_blocks(N), J_THREADS, 0, s>>>(P, v, st, N, u, t,
                                                       static_cast<unsigned long long*>(count));
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
