// The wirec decode as the kernels see it (ops/wirec.py): the per-lane
// profile, passed to a kernel by value, and the decode of one lane's code.
// Shared by kernel A's wirec reader (replay_kernel.cuh) and kernel E (wirec.cu).
//
// Semantics are the JAX package's ops/wirec.py `_read_le` / `decode_step`:
// - the top byte of a code is sign-extended, the lower bytes are OR-ed in
//   unsigned; width 8 is the full 64 bits;
// - ABS: code*scale; DELTA: prev + code*scale, where prev advances on every
//   event row, padding rows included; TSREL_NZ: 0 for a 0 code, else
//   m*scale + base with m = code - 1 for code >= 1 and m = code otherwise;
// - every product and sum wraps as int64 does in XLA (done in uint64_t);
// - rows at or past n_events take PAD_VALUES (-1 on the event-type lane,
//   0 elsewhere); only the output is masked, never the carry.
#pragma once

#include <cstdint>

namespace cadence {

constexpr int WIREC_LANES = 18;
constexpr int WIREC_LANE_EVENT_TYPE = 1;
constexpr int KIND_CONST = 0, KIND_ABS = 1, KIND_DELTA = 2, KIND_TSREL_NZ = 3;

struct WirecLane {
  int64_t scale, cnst;
  int32_t kind, offset, width, base;
};

// One entry per lane, in lane order (the Python wrapper checks it).
struct WirecProfile {
  WirecLane lane[WIREC_LANES];
};

// The host entry points take the profile as WIREC_LANES rows of
// (kind, offset, width, base_index, scale, const) int64.
inline WirecProfile wirec_profile_from(const int64_t* t) {
  WirecProfile p;
  for (int i = 0; i < WIREC_LANES; ++i) {
    const int64_t* r = t + 6 * i;
    p.lane[i] = WirecLane{r[4], r[5], static_cast<int32_t>(r[0]), static_cast<int32_t>(r[1]),
                          static_cast<int32_t>(r[2]), static_cast<int32_t>(r[3])};
  }
  return p;
}

__device__ __forceinline__ int64_t wirec_read_le(const uint8_t* row, int off, int width) {
  uint64_t v = static_cast<uint64_t>(static_cast<int64_t>(static_cast<int8_t>(row[off + width - 1])))
               << (8 * (width - 1));
  for (int k = 0; k < width - 1; ++k) v |= static_cast<uint64_t>(row[off + k]) << (8 * k);
  return static_cast<int64_t>(v);
}

// The decoded value of one non-CONST lane. `carry` is the DELTA lane's
// running value and is advanced here; `base` is bases[w, lane.base].
__device__ __forceinline__ int64_t wirec_lane_value(const WirecLane& l, int64_t code,
                                                    int64_t& carry, int64_t base) {
  const uint64_t scale = static_cast<uint64_t>(l.scale);
  if (l.kind == KIND_ABS) return static_cast<int64_t>(static_cast<uint64_t>(code) * scale);
  if (l.kind == KIND_DELTA) {
    carry = static_cast<int64_t>(static_cast<uint64_t>(carry) + static_cast<uint64_t>(code) * scale);
    return carry;
  }
  if (code == 0) return 0;
  const int64_t m = code >= 1 ? code - 1 : code;
  return static_cast<int64_t>(static_cast<uint64_t>(m) * scale + static_cast<uint64_t>(base));
}

__device__ __forceinline__ int64_t wirec_pad_value(int lane) {
  return lane == WIREC_LANE_EVENT_TYPE ? -1 : 0;
}

}  // namespace cadence
