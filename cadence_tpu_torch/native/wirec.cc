// Native wirec encoder: [W, E, L] int64 lane tensor -> adaptive-columnar
// wirec buffers (slab/bases/n_events), byte-identical to ops/wirec.py
// pack_wirec.
//
// The reference does its hot serialization in compiled Go
// (common/persistence/serialization/); this framework's analog is the
// host-side wire encoder that feeds the TPU link. BENCH_r05 put the
// pure-numpy wirec emit at ~2.2M events/s pack-only while the device
// replays ~3.9M transfer-included — host packing became the production
// bottleneck (PAPER.md §7: sustaining >=16.7M events/s decode+pack is
// why this is C++, not Python). This file ports the three phases:
//
//   measure  — per-lane plan (CONST/ABS/DELTA/TSREL_NZ, GCD scale,
//              minimal byte width) from a single streaming pass over the
//              lane grid, fanned out lane-per-thread;
//   emit     — slab/bases/n_events under a (possibly pinned) profile,
//              fanned out over workflow-row blocks; a chunk whose values
//              fall outside the pinned widths/scales reports a misfit
//              code the Python binding raises as ProfileMisfit — the
//              exact refit contract of the numpy encoder;
//   fused    — wire blobs -> int64 lanes (packer.cc PackOne) -> emit in
//              ONE multi-threaded call, so a streaming chunk crosses the
//              ctypes boundary once and lands in preallocated reusable
//              buffers (native/feeder.py ring slots).
//
// Semantics are exactly ops/wirec.py — including the floor-division
// quotients numpy's `//` produces on the raw pad-row values ABS lanes
// carry (C's truncating `/` would diverge on negative pads), and the
// exactness checks that decide ProfileMisfit. tests/test_native_packer.py
// fuzzes byte-parity against pack_wirec across every bench suite.
//
// Build: native/build.py (g++ -O3 -shared; hashed over wirec.cc AND
// packer.cc because of the include below); loaded via ctypes.

#include "packer.cc"

#include <numeric>

namespace {

// lane kinds (ops/wirec.py)
constexpr int64_t kKindConst = 0;
constexpr int64_t kKindAbs = 1;
constexpr int64_t kKindDelta = 2;
constexpr int64_t kKindTsrelNz = 3;

// misfit reasons, encoded as 1000 + lane * 4 + reason (positive return
// values of the emit entry points; the binding raises ProfileMisfit)
constexpr int64_t kMisfitConst = 0;
constexpr int64_t kMisfitScale = 1;
constexpr int64_t kMisfitWidth = 2;

inline int64_t MisfitCode(int64_t lane, int64_t reason) {
  return 1000 + lane * 4 + reason;
}

// numpy's floor division (`//`): C truncates toward zero instead
inline int64_t FloorDiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

inline int64_t Gcd64(int64_t g, int64_t v) {
  uint64_t a = static_cast<uint64_t>(g);
  uint64_t b = v < 0 ? -static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
  while (b) {
    uint64_t t = a % b;
    a = b;
    b = t;
  }
  return static_cast<int64_t>(a);
}

// minimal little-endian two's-complement byte width holding [lo, hi]
// (ops/wirec.py _width_for)
inline int64_t WidthFor(int64_t lo, int64_t hi) {
  for (int64_t w = 1; w < 8; ++w) {
    int64_t half = int64_t{1} << (8 * w - 1);
    if (-half <= lo && hi < half) return w;
  }
  return 8;
}

inline bool Fits(int64_t code, int64_t width) {
  if (width >= 8) return true;
  int64_t half = int64_t{1} << (8 * width - 1);
  return -half <= code && code < half;
}

// [W] real-row counts: numpy counts positive event ids, it does not
// assume a padded tail (ops/wirec.py: (ev[:,:,0] > 0).sum(axis=1))
void CountEvents(const int64_t* lanes, int64_t W, int64_t E, int64_t L,
                 int32_t* n_events) {
  for (int64_t w = 0; w < W; ++w) {
    int32_t n = 0;
    const int64_t* row = lanes + w * E * L;
    for (int64_t e = 0; e < E; ++e) {
      if (row[e * L + kLaneEventId] > 0) ++n;
    }
    n_events[w] = n;
  }
}

// ---------------------------------------------------------------------------
// measure: one lane's (kind, width, scale, const) from a single pass
// over the [W, E] grid — the exact decision procedure of _plan_lane.
// ---------------------------------------------------------------------------

void PlanLane(const int64_t* lanes, int64_t W, int64_t E, int64_t L,
              int64_t lane, const int32_t* n_events,
              int64_t* kind, int64_t* width, int64_t* scale, int64_t* cnst) {
  bool any = false, all_eq = true, has_zero = false, has_big = false;
  int64_t first = 0;
  int64_t min_v = 0, max_v = 0, g_abs = 0;
  int64_t min_d = 0, max_d = 0, g_d = 0;
  bool any_nz = false;
  int64_t min_r = 0, max_r = 0, g_ts = 0;

  for (int64_t w = 0; w < W; ++w) {
    const int64_t* row = lanes + w * E * L;
    int64_t n = n_events[w];
    int64_t ts_base = row[kLaneTimestamp];  // row 0 timestamp
    int64_t prev = 0;
    for (int64_t e = 0; e < n; ++e) {
      int64_t v = row[e * L + lane];
      if (!any) {
        any = true;
        first = min_v = max_v = v;
      } else {
        all_eq = all_eq && (v == first);
        if (v < min_v) min_v = v;
        if (v > max_v) max_v = v;
      }
      g_abs = Gcd64(g_abs, v);
      if (v == 0) has_zero = true;
      if ((v < 0 ? -v : v) > (int64_t{1} << 31)) has_big = true;
      int64_t d = (e == 0) ? 0 : v - prev;
      prev = v;
      if (d < min_d) min_d = d;
      if (d > max_d) max_d = d;
      g_d = Gcd64(g_d, d);
      if (v != 0) {
        int64_t r = v - ts_base;
        if (!any_nz) {
          any_nz = true;
          min_r = max_r = r;
        } else {
          if (r < min_r) min_r = r;
          if (r > max_r) max_r = r;
        }
        g_ts = Gcd64(g_ts, r);
      }
    }
  }

  if (!any || all_eq) {
    *kind = kKindConst;
    *width = 0;
    *scale = 1;
    *cnst = any ? first : 0;
    return;
  }
  if (g_abs <= 0) g_abs = 1;
  // GCD of |values| divides every value exactly, so / is floor-exact
  int64_t w_abs = WidthFor(min_v / g_abs, max_v / g_abs);
  if (g_d <= 0) g_d = 1;
  int64_t w_d = WidthFor(min_d / g_d, max_d / g_d);

  int64_t best_kind = kKindAbs, best_w = w_abs, best_scale = g_abs;
  if (w_d < w_abs) {
    best_kind = kKindDelta;
    best_w = w_d;
    best_scale = g_d;
  }
  if (has_zero && has_big && any_nz) {
    if (g_ts <= 0) g_ts = 1;
    int64_t q_min = min_r / g_ts, q_max = max_r / g_ts;
    int64_t code_lo = q_min < 0 ? q_min : 0;
    int64_t code_hi = q_max + 1 > 0 ? q_max + 1 : 0;
    int64_t w_ts = WidthFor(code_lo, code_hi);
    if (w_ts < best_w || (best_kind == kKindDelta && w_ts == best_w)) {
      best_kind = kKindTsrelNz;
      best_w = w_ts;
      best_scale = g_ts;
    }
  }
  *kind = best_kind;
  *width = best_w;
  *scale = best_scale;
  *cnst = 0;
}

// ---------------------------------------------------------------------------
// emit: one workflow-row block under the profile. Returns 0 or a misfit
// code. Every slab byte / bases column / n_events entry of the block is
// written, so preallocated buffers need no zeroing between chunks.
// ---------------------------------------------------------------------------

struct LanePlan {
  int64_t lane, kind, offset, width, scale, cnst, base_index;
};

int64_t EmitBlock(const int64_t* lanes, int64_t E, int64_t L,
                  const LanePlan* profile, int64_t P,
                  int64_t B, int64_t K,
                  int64_t w0, int64_t w1,
                  const int32_t* n_events,
                  uint8_t* slab, int64_t* bases) {
  std::vector<int64_t> codes(static_cast<size_t>(E));
  for (int64_t w = w0; w < w1; ++w) {
    const int64_t* row = lanes + w * E * L;
    int64_t n = n_events[w];
    int64_t ts_base = row[kLaneTimestamp];
    uint8_t* srow = slab + w * E * B;
    for (int64_t p = 0; p < P; ++p) {
      const LanePlan& pl = profile[p];
      if (pl.kind == kKindConst) {
        for (int64_t e = 0; e < n; ++e) {
          if (row[e * L + pl.lane] != pl.cnst)
            return MisfitCode(pl.lane, kMisfitConst);
        }
        continue;
      }
      if (pl.kind == kKindAbs) {
        for (int64_t e = 0; e < E; ++e) {
          int64_t v = row[e * L + pl.lane];
          // numpy `v // scale` floors; pad rows carry raw values (0/-1)
          int64_t c = pl.scale != 1 ? FloorDiv(v, pl.scale) : v;
          if (pl.scale != 1 && e < n && c * pl.scale != v)
            return MisfitCode(pl.lane, kMisfitScale);
          codes[static_cast<size_t>(e)] = c;
        }
      } else if (pl.kind == kKindDelta) {
        int64_t prev = 0;
        for (int64_t e = 0; e < E; ++e) {
          int64_t v = row[e * L + pl.lane];
          int64_t d = (e == 0 || e >= n) ? 0 : v - prev;
          prev = v;
          int64_t c = pl.scale != 1 ? FloorDiv(d, pl.scale) : d;
          if (pl.scale != 1 && e < n && c * pl.scale != d)
            return MisfitCode(pl.lane, kMisfitScale);
          codes[static_cast<size_t>(e)] = c;
        }
        if (pl.base_index >= 0) bases[w * K + pl.base_index] = row[pl.lane];
      } else {  // kKindTsrelNz
        for (int64_t e = 0; e < E; ++e) {
          int64_t v = row[e * L + pl.lane];
          int64_t q = FloorDiv(v - ts_base, pl.scale);
          int64_t c = q >= 0 ? q + 1 : q;
          if (e >= n || v == 0) {
            c = 0;
          } else {
            // undo the zero-escape bias and demand exactness (the
            // pinned-profile refit signal, scale 1 included)
            int64_t m = c - (c >= 1 ? 1 : 0);
            if (m * pl.scale + ts_base != v)
              return MisfitCode(pl.lane, kMisfitScale);
          }
          codes[static_cast<size_t>(e)] = c;
        }
        if (pl.base_index >= 0) bases[w * K + pl.base_index] = ts_base;
      }
      // width fit over the FULL grid (pad codes included), then the
      // little-endian byte emit
      for (int64_t e = 0; e < E; ++e) {
        int64_t c = codes[static_cast<size_t>(e)];
        if (!Fits(c, pl.width)) return MisfitCode(pl.lane, kMisfitWidth);
        uint64_t u = static_cast<uint64_t>(c);
        uint8_t* out = srow + e * B + pl.offset;
        for (int64_t k = 0; k < pl.width; ++k)
          out[k] = static_cast<uint8_t>(u >> (8 * k));
      }
    }
  }
  return 0;
}

int64_t EmitCorpus(const int64_t* lanes, int64_t W, int64_t E, int64_t L,
                   const LanePlan* profile, int64_t P, int64_t B, int64_t K,
                   uint8_t* slab, int64_t* bases, int32_t* n_events,
                   int64_t num_threads) {
  CountEvents(lanes, W, E, L, n_events);
  if (num_threads < 1) num_threads = 1;
  if (num_threads > W) num_threads = W > 0 ? W : 1;
  if (num_threads == 1) {
    return EmitBlock(lanes, E, L, profile, P, B, K, 0, W, n_events,
                     slab, bases);
  }
  std::vector<int64_t> errs(static_cast<size_t>(num_threads), 0);
  std::vector<std::thread> threads;
  int64_t block = (W + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * block, hi = std::min(W, lo + block);
    if (lo >= hi) break;
    threads.emplace_back([&, t, lo, hi] {
      errs[static_cast<size_t>(t)] = EmitBlock(
          lanes, E, L, profile, P, B, K, lo, hi, n_events, slab, bases);
    });
  }
  for (auto& th : threads) th.join();
  for (int64_t e : errs) {
    if (e != 0) return e;
  }
  return 0;
}

std::vector<LanePlan> BuildProfile(const int64_t* p_lane,
                                   const int64_t* p_kind,
                                   const int64_t* p_offset,
                                   const int64_t* p_width,
                                   const int64_t* p_scale,
                                   const int64_t* p_const,
                                   const int64_t* p_base_index,
                                   int64_t P) {
  std::vector<LanePlan> prof(static_cast<size_t>(P));
  for (int64_t p = 0; p < P; ++p) {
    prof[static_cast<size_t>(p)] =
        LanePlan{p_lane[p], p_kind[p], p_offset[p], p_width[p],
                 p_scale[p], p_const[p], p_base_index[p]};
  }
  return prof;
}

}  // namespace

extern "C" {

// Per-lane plan of a [W, E, L] int64 lane tensor: writes kinds/widths/
// scales/consts[L]. The binding assembles offsets/base columns with the
// same loop pack_wirec uses, so the profile STRUCTURE can never drift.
int64_t cadence_wirec_measure(const int64_t* lanes, int64_t W, int64_t E,
                              int64_t L, int64_t* kinds, int64_t* widths,
                              int64_t* scales, int64_t* consts,
                              int64_t num_threads) {
  std::vector<int32_t> n_events(static_cast<size_t>(W));
  CountEvents(lanes, W, E, L, n_events.data());
  if (num_threads < 1) num_threads = 1;
  if (num_threads > L) num_threads = L;
  auto work = [&](int64_t t) {
    for (int64_t lane = t; lane < L; lane += num_threads) {
      PlanLane(lanes, W, E, L, lane, n_events.data(), &kinds[lane],
               &widths[lane], &scales[lane], &consts[lane]);
    }
  };
  if (num_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < num_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Emit a [W, E, L] lane tensor under a pinned profile (7 parallel arrays
// of P entries). Returns 0, or 1000 + lane*4 + reason on a profile
// misfit (the binding raises ProfileMisfit — measured, never silent).
int64_t cadence_wirec_emit(const int64_t* lanes, int64_t W, int64_t E,
                           int64_t L,
                           const int64_t* p_lane, const int64_t* p_kind,
                           const int64_t* p_offset, const int64_t* p_width,
                           const int64_t* p_scale, const int64_t* p_const,
                           const int64_t* p_base_index, int64_t P,
                           int64_t B, int64_t K,
                           uint8_t* slab, int64_t* bases, int32_t* n_events,
                           int64_t num_threads) {
  auto prof = BuildProfile(p_lane, p_kind, p_offset, p_width, p_scale,
                           p_const, p_base_index, P);
  return EmitCorpus(lanes, W, E, L, prof.data(), P, B, K, slab, bases,
                    n_events, num_threads);
}

// The fused streaming chunk: wire blobs -> int64 lanes (PackOne, into
// the caller's reusable scratch) -> wirec emit under a pinned profile,
// one ctypes call, one thread pool pass each phase. Returns the total
// events packed, or the packer's -(workflow+1)*1000 - err on a decode
// failure; *misfit_out lands the emit misfit code (0 = clean).
int64_t cadence_wirec_pack_fused(
    const uint8_t* blob, const int64_t* offsets, int64_t W, int64_t E,
    int64_t L, int64_t* lanes_scratch,
    const int64_t* p_lane, const int64_t* p_kind, const int64_t* p_offset,
    const int64_t* p_width, const int64_t* p_scale, const int64_t* p_const,
    const int64_t* p_base_index, int64_t P, int64_t B, int64_t K,
    uint8_t* slab, int64_t* bases, int32_t* n_events, int64_t* misfit_out,
    int64_t num_threads) {
  *misfit_out = 0;
  int64_t total = PackCorpus<int64_t, false>(blob, offsets, W, E, L,
                                             lanes_scratch, num_threads);
  if (total < 0) return total;
  auto prof = BuildProfile(p_lane, p_kind, p_offset, p_width, p_scale,
                           p_const, p_base_index, P);
  *misfit_out = EmitCorpus(lanes_scratch, W, E, L, prof.data(), P, B, K,
                           slab, bases, n_events, num_threads);
  return total;
}

}  // extern "C"
