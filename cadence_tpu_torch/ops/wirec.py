"""wirec: the compressed host-to-device wire format (columnar, adaptive
width), a copy of the JAX package's ops/wirec.py with the device decode
written for the card.

The int64 lanes spend 144 B per event on lanes whose information content
is a handful of bits: event ids advance by 1, timestamps by a fixed tick,
half the lanes are constant per corpus. wirec ships each lane at its
measured width and decodes on the device, so the dense form never
crosses the host link.

Format. A corpus [W, E, NUM_LANES] int64 becomes:
  - slab   [W, E, B] uint8 - per-lane byte columns, little-endian two's
           complement at each lane's minimal width (1..8 bytes);
  - bases  [W, K] int64 - per-workflow first-row values for the DELTA and
           TSREL_NZ lanes;
  - n_events [W] int32 - real-row counts (tail padding is rebuilt on the
           device, never shipped);
  - profile - a per-lane plan chosen at pack time by measuring the corpus:
      * CONST  c        : every real value equals c; 0 bytes on the wire.
      * ABS    v = q*s  : values divided by their GCD s, stored at the
                          minimal width for the quotient.
      * DELTA  v = cumsum(q*s) + base : row-to-row differences (event
                          ids, timestamps, task ids), GCD-scaled.
      * TSREL_NZ        : sparse absolute-nanos lanes: zero stays zero,
                          nonzero values are GCD-scaled offsets from the
                          workflow's first timestamp.

The host half (pack_wirec, gather_corpus and the planning helpers) is the
JAX package's numpy code, so the packed bytes are the reference's. The
device half decodes: `decode_wirec` is kernel E (csrc/wirec.cu) on the
card and `decode_wirec_plain` on the CPU; `decode_step_plain` is the
one-column decode that the plain replay scan (ops/replay.wirec_scan_plain)
fuses into its loop, and kernel A's wirec reader (csrc/replay_kernel.cuh) does
the same per thread. The decode reproduces the JAX package's exactly,
padding rows and the DELTA carry through them included.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .encode import LANE_EVENT_ID, LANE_EVENT_TYPE, LANE_TIMESTAMP, NUM_LANES

KIND_CONST = 0
KIND_ABS = 1
KIND_DELTA = 2
KIND_TSREL_NZ = 3

#: reconstructed value of each lane in tail-padding rows
PAD_VALUES = tuple(-1 if lane == LANE_EVENT_TYPE else 0
                   for lane in range(NUM_LANES))


class LaneCode(NamedTuple):
    """One lane's static decode plan."""

    lane: int
    kind: int
    offset: int      # byte offset inside the slab row (unused for CONST)
    width: int       # bytes per event (0 for CONST)
    scale: int       # GCD the stored quotient multiplies back by
    const: int       # CONST value
    base_index: int  # column in `bases` (-1 when no base is needed)


class WirecCorpus(NamedTuple):
    slab: np.ndarray       # [W, E, B] uint8
    bases: np.ndarray      # [W, K] int64
    n_events: np.ndarray   # [W] int32
    profile: Tuple[LaneCode, ...]

    @property
    def wire_bytes(self) -> int:
        return self.slab.nbytes + self.bases.nbytes + self.n_events.nbytes

    def bytes_per_event(self) -> float:
        real = int(self.n_events.sum())
        return self.wire_bytes / real if real else float("inf")


class ProfileMisfit(Exception):
    """A chunk's values exceed the pinned profile's widths/scales; the
    caller refits (recompute + recompile) — measured, never silent."""


def _width_for(lo: int, hi: int) -> int:
    """Minimal little-endian two's-complement byte width holding [lo, hi]."""
    for w in range(1, 8):
        if -(1 << (8 * w - 1)) <= lo and hi < (1 << (8 * w - 1)):
            return w
    return 8


def _gcd_scale(vals: np.ndarray) -> int:
    """GCD of |vals| (1 when empty/all-zero): the exact common tick."""
    if vals.size == 0:
        return 1
    g = int(np.gcd.reduce(np.abs(vals)))
    return g if g > 0 else 1


def _delta_codes(v: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Row-to-row differences with the real→pad cliff zeroed (pad rows
    carry delta 0 — the decoder's pad mask reconstructs their values, so
    only the width matters and zero always fits). d[:, 0] is 0 by
    construction: the workflow base ships in `bases`."""
    d = v.copy()
    d[:, 1:] -= v[:, :-1]
    d[:, 0] = 0
    return np.where(mask, d, 0)


def _plan_lane(v: np.ndarray, mask: np.ndarray, n: np.ndarray,
               ts_base: np.ndarray) -> Tuple[int, int, int, int]:
    """Choose (kind, width, scale, const) for one lane's [W, E] values.
    Only real rows matter — padding is reconstructed from n_events."""
    real = v[mask]
    if real.size == 0 or (real == real.flat[0]).all():
        return KIND_CONST, 0, 1, (int(real.flat[0]) if real.size else 0)

    g_abs = _gcd_scale(real)
    w_abs = _width_for(int(real.min()) // g_abs, int(real.max()) // g_abs)

    d = _delta_codes(v, mask)
    g_d = _gcd_scale(d[mask])
    dq = d[mask] // g_d
    w_d = _width_for(int(dq.min()), int(dq.max())) if dq.size else 1

    best = (KIND_ABS, w_abs, g_abs, 0)
    if w_d < w_abs:
        best = (KIND_DELTA, w_d, g_d, 0)

    # sparse absolute-nanos lanes: zeros + huge values (expiration stamps)
    if (real == 0).any() and (np.abs(real) > 1 << 31).any():
        rel = (v - ts_base[:, None])[mask & (v != 0)]
        g_ts = _gcd_scale(rel)
        q = rel // g_ts
        code_lo = min(int(q.min()), 0)
        code_hi = max(int(q.max()) + 1, 0)
        w_ts = _width_for(code_lo, code_hi)
        if w_ts < best[1] or (best[0] == KIND_DELTA and w_ts == best[1]):
            best = (KIND_TSREL_NZ, w_ts, g_ts, 0)
    return best


def _emit(slab: np.ndarray, off: int, width: int, code: np.ndarray) -> None:
    """Write [W, E] int64 codes as `width` little-endian bytes."""
    u = code.astype(np.uint64)
    for k in range(width):
        slab[:, :, off + k] = ((u >> np.uint64(8 * k))
                               & np.uint64(0xFF)).astype(np.uint8)


def _lane_codes(v: np.ndarray, mask: np.ndarray, n: np.ndarray,
                ts_base: np.ndarray, kind: int, scale: int
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The stored quotient grid for one lane, plus the per-workflow base
    column (or None). Pad-row codes are whatever falls out of the raw
    values (ABS) or zero (DELTA/TSREL) — the decoder's pad mask makes
    their decoded value irrelevant; only the byte width must hold them,
    and pad values are 0/-1."""
    if kind == KIND_ABS:
        return v // scale if scale != 1 else v, None
    if kind == KIND_DELTA:
        d = _delta_codes(v, mask)
        return d // scale if scale != 1 else d, v[:, 0].copy()
    if kind == KIND_TSREL_NZ:
        q = (v - ts_base[:, None]) // scale
        code = np.where(q >= 0, q + 1, q)
        return np.where(mask & (v != 0), code, 0), ts_base.copy()
    raise ValueError(f"kind {kind} emits no codes")


def _check_fit(code: np.ndarray, width: int) -> bool:
    lo, hi = -(1 << (8 * width - 1)), (1 << (8 * width - 1)) - 1
    return bool((code >= lo).all() and (code <= hi).all())


def _pack_rows(ev: np.ndarray, mask: np.ndarray, n: np.ndarray,
               ts_base: np.ndarray, profile: Tuple[LaneCode, ...],
               slab: np.ndarray, bases: np.ndarray) -> None:
    """Emit every lane of a [w, E, L] row block into its slab/bases slice
    (each transform is per-workflow-row, so blocks are independent)."""
    for e in profile:
        v = ev[:, :, e.lane]
        if e.kind == KIND_CONST:
            if mask.any() and not (v[mask] == e.const).all():
                raise ProfileMisfit(f"lane {e.lane}: non-const under CONST")
            continue
        code, base = _lane_codes(v, mask, n, ts_base, e.kind, e.scale)
        # exactness: the quotient must reproduce the value on REAL rows
        # (scale divides evenly) — pad rows are reconstructed by mask
        if e.scale != 1 or e.kind == KIND_TSREL_NZ:
            if e.kind == KIND_ABS:
                bad = (code * e.scale != v) & mask
            elif e.kind == KIND_DELTA:
                bad = (code * e.scale != _delta_codes(v, mask)) & mask
            else:  # KIND_TSREL_NZ: undo the zero-escape bias
                m = code - (code >= 1)
                bad = ((m * e.scale + ts_base[:, None] != v)
                       & mask & (v != 0))
            if bad.any():
                raise ProfileMisfit(f"lane {e.lane}: scale {e.scale} misfit")
        if not _check_fit(code, e.width):
            raise ProfileMisfit(f"lane {e.lane}: width {e.width} overflow")
        _emit(slab, e.offset, e.width, code)
        if base is not None:
            bases[:, e.base_index] = base


#: minimum rows per thread block: below this the pool overhead beats the
#: numpy-releases-the-GIL parallelism win
_MIN_BLOCK_ROWS = 256

#: process-lifetime pack pools by worker count — the wirec feeder calls
#: pack_wirec once per chunk, so per-call pool spawn/join would be pure
#: overhead on the exact path this parallelism is optimizing
_POOLS: dict = {}
_POOLS_LOCK = threading.Lock()


def _pack_pool(threads: int):
    with _POOLS_LOCK:
        pool = _POOLS.get(threads)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = _POOLS[threads] = ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="wirec-pack")
        return pool


def pack_wirec(events64: np.ndarray,
               profile: Optional[Tuple[LaneCode, ...]] = None,
               num_threads: Optional[int] = None) -> WirecCorpus:
    """[W, E, NUM_LANES] int64 → WirecCorpus.

    With `profile` pinned (streaming chunks sharing one executable), the
    chunk is packed under that plan; values that don't fit its
    widths/scales raise ProfileMisfit so the caller refits explicitly.

    `num_threads` > 1 enables the chunk-parallel path: lane PLANNING fans
    out per lane and EMIT fans out over workflow-row blocks (every
    transform — delta, GCD scaling, ts-rel — is per-workflow, so blocks
    are independent and the packed bytes are identical to the serial
    path). numpy releases the GIL inside the ufunc loops, so host packing
    scales with cores instead of pinning one. `None` resolves through the
    one CADENCE_TPU_PACK_THREADS knob (utils/concurrency.pack_threads);
    small corpora stay serial either way (_MIN_BLOCK_ROWS).
    """
    from ..utils.concurrency import pack_threads

    ev = np.asarray(events64, dtype=np.int64)
    W, E, L = ev.shape
    assert L == NUM_LANES, f"expected {NUM_LANES} lanes, got {L}"
    n = (ev[:, :, LANE_EVENT_ID] > 0).sum(axis=1).astype(np.int32)
    mask = np.arange(E)[None, :] < n[:, None]
    # row 0 is real whenever n > 0, so the first-row value IS the base
    ts_base = ev[:, 0, LANE_TIMESTAMP]

    threads = pack_threads(num_threads)
    if W < 2 * _MIN_BLOCK_ROWS:
        threads = 1
    pool = _pack_pool(threads) if threads > 1 else None

    if profile is None:
        if pool is not None:
            plans = list(pool.map(
                lambda lane: _plan_lane(ev[:, :, lane], mask, n, ts_base),
                range(NUM_LANES)))
        else:
            plans = [_plan_lane(ev[:, :, lane], mask, n, ts_base)
                     for lane in range(NUM_LANES)]
        off = 0
        base_cols = 0
        entries = []
        for lane, (kind, width, scale, const) in enumerate(plans):
            bi = -1
            if kind in (KIND_DELTA, KIND_TSREL_NZ):
                bi = base_cols
                base_cols += 1
            entries.append(LaneCode(lane, kind, off if width else 0,
                                    width, scale, const, bi))
            off += width
        profile = tuple(entries)

    B = sum(e.width for e in profile)
    K = sum(1 for e in profile if e.base_index >= 0)
    slab = np.zeros((W, E, B), dtype=np.uint8)
    bases = np.zeros((W, K), dtype=np.int64)
    if pool is not None:
        block = max(_MIN_BLOCK_ROWS, -(-W // threads))
        bounds = [(lo, min(lo + block, W)) for lo in range(0, W, block)]
        list(pool.map(
            lambda b: _pack_rows(ev[b[0]:b[1]], mask[b[0]:b[1]],
                                 n[b[0]:b[1]], ts_base[b[0]:b[1]],
                                 profile, slab[b[0]:b[1]],
                                 bases[b[0]:b[1]]),
            bounds))
    else:
        _pack_rows(ev, mask, n, ts_base, profile, slab, bases)
    return WirecCorpus(slab, bases, n, profile)


def gather_corpus(corpus: WirecCorpus, indices,
                  pad_workflows: int = 0,
                  pad_events: int = 0) -> WirecCorpus:
    """Gather flagged rows into a compact sub-corpus under the SAME
    profile (engine/ladder.py's wirec leg): the widened-K re-replay
    decodes the identical bytes, so gather+re-replay is byte-equivalent
    to the rows' original decode. The event axis trims to the flagged
    rows' longest real history; padding rows carry n_events = 0 (the
    decoder masks every event past n_events to no-op lanes), letting
    padded shapes pow2-bucket for executable reuse."""
    idx = np.asarray(indices, dtype=np.int64)
    n = corpus.n_events[idx]
    e_real = int(n.max()) if len(idx) else 1
    e_real = max(e_real, 1)
    E = max(e_real, pad_events)
    W = max(len(idx), pad_workflows)
    slab = np.zeros((W, E, corpus.slab.shape[2]), dtype=np.uint8)
    bases = np.zeros((W, corpus.bases.shape[1]), dtype=np.int64)
    n_events = np.zeros((W,), dtype=np.int32)
    slab[:len(idx), :e_real] = corpus.slab[idx][:, :e_real]
    bases[:len(idx)] = corpus.bases[idx]
    n_events[:len(idx)] = n
    return WirecCorpus(slab, bases, n_events, corpus.profile)



def delta_base_columns(profile: Tuple[LaneCode, ...]) -> Tuple[int, ...]:
    """`bases` columns of the DELTA lanes, in profile order (the decode
    carry's initial values)."""
    return tuple(e.base_index for e in profile if e.kind == KIND_DELTA)


# ---------------------------------------------------------------------------
# Device decode: the plain PyTorch versions, and kernel E
# ---------------------------------------------------------------------------


def _read_le(slab, off: int, width: int):
    """[..., B] uint8 -> [...] int64: little-endian, the top byte
    sign-extended, the lower bytes OR-ed in unsigned."""
    v = slab[..., off + width - 1].view(torch.int8).to(torch.int64) << (8 * (width - 1))
    for k in range(width - 1):
        v = v | (slab[..., off + k].to(torch.int64) << (8 * k))
    return v


def _lane_value(e: LaneCode, code, prev, base):
    """One non-CONST lane's decoded value from its code: ABS `code*s`,
    DELTA `prev + code*s`, TSREL_NZ 0 for a 0 code, else `m*s + base` with
    `m` the code less its zero-escape bias. int64 products and sums wrap."""
    if e.kind == KIND_ABS:
        return code * e.scale
    if e.kind == KIND_DELTA:
        return prev + code * e.scale
    m = torch.where(code >= 1, code - 1, code)
    return torch.where(code == 0, torch.zeros_like(code), m * e.scale + base)


def decode_wirec_plain(slab, bases, n_events, profile: Tuple[LaneCode, ...]):
    """Plain PyTorch version of kernel E: [W, E, B] uint8 -> [W, E,
    NUM_LANES] int64, the JAX package's decode_wirec. Rows at or past
    n_events take PAD_VALUES."""
    W, E, _ = slab.shape
    in_real = torch.arange(E, device=slab.device)[None, :] < n_events.to(torch.int64)[:, None]
    lanes = []
    for e in profile:
        if e.kind == KIND_CONST:
            v = torch.full((W, E), e.const, dtype=torch.int64, device=slab.device)
        else:
            code = _read_le(slab, e.offset, e.width)
            base = bases[:, e.base_index][:, None] if e.base_index >= 0 else None
            if e.kind == KIND_DELTA:
                v = torch.cumsum(code * e.scale, dim=1) + base
            else:
                v = _lane_value(e, code, None, base)
        lanes.append(torch.where(in_real, v, torch.full_like(v, PAD_VALUES[e.lane])))
    return torch.stack(lanes, dim=-1)


def decode_step_plain(sl, prev, bases, n_events, e_idx: int,
                      profile: Tuple[LaneCode, ...]):
    """Decode ONE event column, as the JAX package's decode_step: sl [W, B]
    uint8 -> (ev [W, NUM_LANES] int64, new prev [W, n_delta] int64). The
    DELTA lanes carry their running value in `prev`, which advances on
    every column, padding rows included; only the output is masked."""
    W = sl.shape[0]
    in_real = e_idx < n_events
    vals = []
    new_prev = prev.clone()
    di = 0
    for e in profile:
        if e.kind == KIND_CONST:
            v = torch.full((W,), e.const, dtype=torch.int64, device=sl.device)
        else:
            code = _read_le(sl, e.offset, e.width)
            base = bases[:, e.base_index] if e.base_index >= 0 else None
            v = _lane_value(e, code, prev[:, di] if e.kind == KIND_DELTA else None, base)
            if e.kind == KIND_DELTA:
                new_prev[:, di] = v
                di += 1
        vals.append(torch.where(in_real, v, torch.full_like(v, PAD_VALUES[e.lane])))
    return torch.stack(vals, dim=-1), new_prev


def check_profile(profile: Tuple[LaneCode, ...], B: int, K: int) -> None:
    """Raise unless `profile` is what the kernels take: one entry per lane
    in lane order, byte columns inside a [B] row, base columns inside [K]."""
    if len(profile) != NUM_LANES:
        raise ValueError(f"profile: {len(profile)} entries, expected {NUM_LANES}")
    for i, e in enumerate(profile):
        if e.lane != i:
            raise ValueError(f"profile entry {i} is lane {e.lane}: lanes must be in order")
        if e.kind not in (KIND_CONST, KIND_ABS, KIND_DELTA, KIND_TSREL_NZ):
            raise ValueError(f"lane {i}: unknown kind {e.kind}")
        if e.kind != KIND_CONST and not (1 <= e.width <= 8 and 0 <= e.offset
                                         and e.offset + e.width <= B):
            raise ValueError(f"lane {i}: bytes [{e.offset}, +{e.width}) outside a {B}-byte row")
        if e.kind in (KIND_DELTA, KIND_TSREL_NZ) and not 0 <= e.base_index < K:
            raise ValueError(f"lane {i}: base column {e.base_index} outside [0, {K})")


def profile_table(profile: Tuple[LaneCode, ...]):
    """The profile as the kernels' C entry points take it: NUM_LANES rows
    of (kind, offset, width, base_index, scale, const) int64, which the C
    side packs into the struct it passes to the kernel by value."""
    flat = [int(v) for e in profile
            for v in (e.kind, e.offset, e.width, e.base_index, e.scale, e.const)]
    return (ctypes.c_int64 * len(flat))(*flat)


def wirec_inputs(slab, bases, n_events, profile, device):
    """(slab, bases, n_events) as contiguous uint8 / int64 / int32 tensors
    on `device`, checked against each other and the profile."""
    slab = torch.as_tensor(slab).to(device).contiguous()
    bases = torch.as_tensor(bases).to(device).contiguous()
    n_events = torch.as_tensor(n_events).to(device).contiguous()
    if slab.dim() != 3 or slab.dtype != torch.uint8:
        raise ValueError(f"slab: expected [W, E, B] uint8, got {tuple(slab.shape)} {slab.dtype}")
    W = slab.shape[0]
    if bases.dim() != 2 or bases.shape[0] != W or bases.dtype != torch.int64:
        raise ValueError(f"bases: expected [{W}, K] int64, got {tuple(bases.shape)} {bases.dtype}")
    if tuple(n_events.shape) != (W,) or n_events.dtype != torch.int32:
        raise ValueError(f"n_events: expected [{W}] int32, got "
                         f"{tuple(n_events.shape)} {n_events.dtype}")
    check_profile(tuple(profile), slab.shape[2], bases.shape[1])
    return slab, bases, n_events


def decode_wirec(slab, bases, n_events, profile: Tuple[LaneCode, ...], device=None):
    """Full-tensor decode [W, E, B] uint8 -> [W, E, NUM_LANES] int64 on
    `device`: kernel E on the card, the plain version on the CPU."""
    dev = resolve_device(device)
    slab, bases, n_events = wirec_inputs(slab, bases, n_events, profile, dev)
    if dev.type == "cpu":
        return decode_wirec_plain(slab, bases, n_events, tuple(profile))
    launch, out = decode_launch(slab, bases, n_events, profile)
    launch()
    return out


def decode_launch(slab, bases, n_events, profile: Tuple[LaneCode, ...]):
    """Check what kernel E takes; return (its launch, the [W, E,
    NUM_LANES] int64 output it writes)."""
    dev = slab.device
    W, E, B = slab.shape
    K = bases.shape[1]
    _build.require(slab, torch.uint8, (W, E, B), "slab", dev)
    _build.require(bases, torch.int64, (W, K), "bases", dev)
    _build.require(n_events, torch.int32, (W,), "n_events", dev)
    check_profile(tuple(profile), B, K)
    out = torch.empty((W, E, NUM_LANES), dtype=torch.int64, device=dev)
    return _build.launcher(
        "decode_wirec", _build.load().cadence_decode_wirec, slab, bases, n_events, out,
        W, E, B, K, profile_table(profile), _build.stream_of(slab)), out
