"""The native wirec encoder's binding, the dispatcher between it and the
numpy encoder, and the staging of a packed corpus onto the card.

`wirec.cc` (a byte-for-byte copy of the JAX package's, with the
`packer.cc` it includes) measures and emits the same profile and bytes as
ops/wirec.pack_wirec, threaded. `pack_wirec_auto` is the one dispatcher:
the native encoder when it is enabled and g++ could build it, the numpy
encoder otherwise, with the same bytes either way; the counters under
`tpu.native` say which one served. `CADENCE_TPU_NATIVE_WIREC` set to
0/false/off/no pins the numpy encoder.

The feeder's chunks go through `pack_serialized_wirec`: wire blobs to
int64 lanes to wirec columns in one native pass (the first chunk packs,
measures and emits; later chunks make one fused call under the pinned
profile and raise ProfileMisfit when they do not fit it), written into
the reusable host buffers of a `WirecBuffers` ring slot.

Staging. `stage_corpus` copies the slab, bases and n_events (a ring
slot's arrays or any others) into page-locked host memory and from there
to the card with non-blocking copies on a side CUDA stream; the caller's
current stream waits on an event recorded after the copies, so the replay
launched next on it reads whole tensors while the host thread has already
moved on, and the slot may be written again as soon as the call returns.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.encode import NUM_LANES
from ..ops.wirec import (
    KIND_DELTA,
    KIND_TSREL_NZ,
    LaneCode,
    ProfileMisfit,
    WirecCorpus,
    pack_wirec,
)
from ..utils import metrics as m
from ..utils.concurrency import pack_threads
from . import build as _build

#: 0/false/off/no pins the numpy encoder; anything else (or unset) takes
#: the native one when it can be built
NATIVE_WIREC_ENV = "CADENCE_TPU_NATIVE_WIREC"

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def wirec_native_enabled(registry=None) -> bool:
    """True when wirec packs should take the native encoder. Publishes the
    `tpu.native/available` gauge (1 when the library loads here)."""
    reg = registry if registry is not None else m.DEFAULT_REGISTRY
    avail = _build.load_wirec() is not None
    reg.gauge(m.SCOPE_TPU_NATIVE, m.M_NATIVE_AVAILABLE, 1.0 if avail else 0.0)
    env = os.environ.get(NATIVE_WIREC_ENV, "").strip().lower()
    if env in ("0", "false", "off", "no"):
        return False
    return avail


def _lib():
    lib = _build.load_wirec()
    if lib is None:
        raise RuntimeError("native wirec unavailable: no C++ compiler (g++) on PATH")
    return lib


def _lanes(events64) -> np.ndarray:
    ev = np.ascontiguousarray(events64, dtype=np.int64)
    if ev.ndim != 3 or ev.shape[2] != NUM_LANES:
        raise ValueError(f"expected [W, E, {NUM_LANES}] int64 lanes, got {ev.shape}")
    return ev


def _assemble_profile(plans) -> Tuple[LaneCode, ...]:
    """(kind, width, scale, const) per lane -> the LaneCode tuple, by the
    offset and base-column loop of ops/wirec.pack_wirec."""
    off = 0
    base_cols = 0
    entries = []
    for lane, (kind, width, scale, const) in enumerate(plans):
        bi = -1
        if kind in (KIND_DELTA, KIND_TSREL_NZ):
            bi = base_cols
            base_cols += 1
        entries.append(LaneCode(lane, kind, off if width else 0, width, scale, const, bi))
        off += width
    return tuple(entries)


def _profile_columns(profile):
    return [np.fromiter((getattr(e, f) for e in profile), dtype=np.int64, count=len(profile))
            for f in ("lane", "kind", "offset", "width", "scale", "const", "base_index")]


def profile_widths(profile) -> Tuple[int, int]:
    """(B, K): slab bytes per event and bases columns under `profile`."""
    return (sum(e.width for e in profile), sum(1 for e in profile if e.base_index >= 0))


def _raise_misfit(code: int) -> None:
    lane, reason = divmod(code - 1000, 4)
    what = {0: "non-const under CONST", 1: "scale misfit",
            2: "width overflow"}.get(reason, f"code {reason}")
    raise ProfileMisfit(f"lane {lane}: {what} (native)")


def measure_profile_native(events64: np.ndarray,
                           num_threads: Optional[int] = None) -> Tuple[LaneCode, ...]:
    """The per-lane plan of [W, E, L] int64 lanes, measured natively: the
    profile pack_wirec would choose."""
    ev = _lanes(events64)
    W, E, L = ev.shape
    kinds, widths, scales, consts = (np.zeros(L, dtype=np.int64) for _ in range(4))
    rc = _lib().cadence_wirec_measure(
        ev.ctypes.data_as(_I64P), W, E, L, kinds.ctypes.data_as(_I64P),
        widths.ctypes.data_as(_I64P), scales.ctypes.data_as(_I64P),
        consts.ctypes.data_as(_I64P), pack_threads(num_threads, cap=L))
    if rc != 0:
        raise RuntimeError(f"cadence_wirec_measure returned {rc}")
    return _assemble_profile(list(zip(kinds.tolist(), widths.tolist(), scales.tolist(),
                                      consts.tolist())))


class WirecBuffers:
    """The reusable host buffers of one ring slot of the feeder: the int64
    lanes scratch and the wirec triple (slab, bases, n_events), the triple
    made anew only when the pinned profile's widths change (a refit). The
    native emit overwrites every byte it hands out, so a slot is reused
    chunk after chunk without zeroing; the executor's ring discipline
    frees it only after the chunk that last used it has finished."""

    def __init__(self, chunk_workflows: int, max_events: int) -> None:
        self.W = chunk_workflows
        self.E = max_events
        self.lanes = np.empty((chunk_workflows, max_events, NUM_LANES), dtype=np.int64)
        self._key: Optional[Tuple[int, int]] = None
        self.slab = self.bases = self.n_events = None

    def for_profile(self, profile):
        """(slab, bases, n_events) sized for `profile`."""
        B, K = profile_widths(profile)
        if self._key != (B, K):
            self.slab = np.empty((self.W, self.E, B), dtype=np.uint8)
            self.bases = np.empty((self.W, K), dtype=np.int64)
            self.n_events = np.empty((self.W,), dtype=np.int32)
            self._key = (B, K)
        return self.slab, self.bases, self.n_events


def _outputs(W: int, E: int, profile, out: Optional[WirecBuffers]):
    if out is None:
        B, K = profile_widths(profile)
        return (np.empty((W, E, B), dtype=np.uint8), np.empty((W, K), dtype=np.int64),
                np.empty((W,), dtype=np.int32))
    if (out.W, out.E) != (W, E):
        raise ValueError(f"WirecBuffers slot is [{out.W}, {out.E}], the chunk [{W}, {E}]")
    return out.for_profile(profile)


def pack_wirec_native(events64: np.ndarray, profile=None,
                      num_threads: Optional[int] = None,
                      out: Optional[WirecBuffers] = None) -> WirecCorpus:
    """[W, E, L] int64 -> WirecCorpus with the native encoder, the same
    bytes as ops/wirec.pack_wirec; under a pinned `profile` that the lanes
    do not fit, raises ProfileMisfit. `out` writes into a ring slot."""
    ev = _lanes(events64)
    W, E, L = ev.shape
    threads = pack_threads(num_threads)
    if profile is None:
        profile = measure_profile_native(ev, num_threads=threads)
    B, K = profile_widths(profile)
    slab, bases, n_events = _outputs(W, E, profile, out)
    cols = _profile_columns(profile)
    rc = _lib().cadence_wirec_emit(
        ev.ctypes.data_as(_I64P), W, E, L, *(c.ctypes.data_as(_I64P) for c in cols),
        len(profile), B, K, slab.ctypes.data_as(_U8P), bases.ctypes.data_as(_I64P),
        n_events.ctypes.data_as(_I32P), threads)
    if rc != 0:
        _raise_misfit(rc)
    return WirecCorpus(slab, bases, n_events, tuple(profile))


def pack_serialized_wirec(blobs: Sequence[bytes], max_events: int, profile=None,
                          num_threads: Optional[int] = None,
                          out: Optional[WirecBuffers] = None) -> Tuple[WirecCorpus, int]:
    """W serialized histories -> int64 lanes -> WirecCorpus, natively:
    without a `profile`, one pack then measure and emit (the first chunk);
    under a pinned `profile`, one fused call, which raises ProfileMisfit
    when the chunk does not fit it (its lanes are then in `out.lanes`, so
    the caller refits from them). Returns (corpus, events packed)."""
    from .packing import blob_offsets, raise_pack_error

    lib = _lib()
    W = len(blobs)
    blob, offsets = blob_offsets(blobs)
    threads = pack_threads(num_threads, cap=max(1, W))
    if out is not None:
        if (out.W, out.E) != (W, max_events):
            raise ValueError(f"WirecBuffers slot is [{out.W}, {out.E}], the chunk "
                             f"[{W}, {max_events}]")
        lanes = out.lanes
    else:
        lanes = np.empty((W, max_events, NUM_LANES), dtype=np.int64)
    if profile is None:
        rc = lib.cadence_pack_corpus(blob, offsets.ctypes.data_as(_I64P), W, max_events,
                                     NUM_LANES, lanes.ctypes.data_as(_I64P), threads)
        if rc < 0:
            raise_pack_error(rc)
        return pack_wirec_native(lanes, num_threads=num_threads, out=out), int(rc)
    B, K = profile_widths(profile)
    slab, bases, n_events = _outputs(W, max_events, profile, out)
    misfit = np.zeros(1, dtype=np.int64)
    rc = lib.cadence_wirec_pack_fused(
        blob, offsets.ctypes.data_as(_I64P), W, max_events, NUM_LANES,
        lanes.ctypes.data_as(_I64P), *(c.ctypes.data_as(_I64P) for c in _profile_columns(profile)),
        len(profile), B, K, slab.ctypes.data_as(_U8P), bases.ctypes.data_as(_I64P),
        n_events.ctypes.data_as(_I32P), misfit.ctypes.data_as(_I64P), threads)
    if rc < 0:
        raise_pack_error(rc)
    if int(misfit[0]) != 0:
        _raise_misfit(int(misfit[0]))
    return WirecCorpus(slab, bases, n_events, tuple(profile)), int(rc)


def pack_wirec_auto(events64: np.ndarray, profile=None, num_threads: Optional[int] = None,
                    registry=None) -> WirecCorpus:
    """The wirec-pack dispatcher: the native encoder when enabled and
    available, the numpy one otherwise (the same bytes); counts which
    served under tpu.native. ProfileMisfit propagates from either."""
    reg = registry if registry is not None else m.DEFAULT_REGISTRY
    if wirec_native_enabled(reg):
        corpus = pack_wirec_native(events64, profile=profile, num_threads=num_threads)
        reg.inc(m.SCOPE_TPU_NATIVE, m.M_NATIVE_PACKS)
        return corpus
    corpus = pack_wirec(events64, profile=profile, num_threads=num_threads)
    reg.inc(m.SCOPE_TPU_NATIVE, m.M_NATIVE_PY_PACKS)
    return corpus


def pinned(arr: np.ndarray) -> torch.Tensor:
    """A host tensor in page-locked memory holding a copy of `arr`."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    out.copy_(src)
    return out


def stage_h2d(tensors: Sequence[torch.Tensor], device) -> Tuple[torch.Tensor, ...]:
    """Copy page-locked host tensors to the card on a side stream. The
    device tensors are allocated on the caller's current stream (so the
    caching allocator reuses them call after call); the current stream
    waits on an event recorded after the copies, so work queued on it next
    sees the whole tensors."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"stage_h2d: copies to a CUDA device, not {dev}")
    current = torch.cuda.current_stream(dev)
    out = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in tensors)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)  # the new buffers may reuse memory the current stream used
    with torch.cuda.stream(side):
        for dst, src in zip(out, tensors):
            dst.copy_(src, non_blocking=True)
    for dst in out:  # written on the side stream: not reused before the copy ends
        dst.record_stream(side)
    current.wait_event(side.record_event())
    return out


def stage_corpus(corpus: WirecCorpus, device=None):
    """(slab, bases, n_events) of `corpus` on `device` (None: the card):
    through page-locked memory and a side stream on the card; plain
    tensors on the CPU."""
    dev = resolve_device(device)
    arrays = (corpus.slab, corpus.bases, corpus.n_events)
    if dev.type == "cpu":
        return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return stage_h2d([pinned(a) for a in arrays], dev)
