"""The native blob packers' binding: serialized histories (core/codec.py
wire bytes) to lane tensors, with packer.cc (a byte-for-byte copy of the
JAX package's, built into the one library native/build.py load_wirec
makes). A copy of the JAX package's native/packing.py, pointed at that
library."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from ..ops.encode import NUM_LANES, NUM_LANES32
from ..utils.concurrency import pack_threads
from . import build as _build

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def native_available() -> bool:
    return _build.load_wirec() is not None


def _lib():
    lib = _build.load_wirec()
    if lib is None:
        raise RuntimeError("native packer unavailable: no C++ compiler (g++) on PATH")
    return lib


def blob_offsets(blobs: Sequence[bytes]):
    """Join W serialized histories into the (blob, offsets[W + 1]) call
    frame every native corpus entry point takes."""
    blob = b"".join(blobs)
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return blob, offsets


def raise_pack_error(rc: int, wire32: bool = False) -> None:
    """Decode a native packer failure (-(workflow+1)*1000 - err) into the
    ValueError every caller raises."""
    workflow = (-rc) // 1000 - 1
    err = (-rc) % 1000
    codes = ("1=truncated, 2=unknown attr, 3=history exceeds max_events"
             + (", 4=lane exceeds int32 — use the int64 path" if wire32 else ""))
    raise ValueError(f"native packer failed on workflow {workflow} (code {err}: {codes})")


def _out(out: Optional[np.ndarray], shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype=dtype)
    if out.shape != shape or out.dtype != dtype or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out buffer {out.shape} {out.dtype}: expected a C-contiguous "
                         f"{shape} {np.dtype(dtype)}")
    return out


def pack_serialized(blobs: Sequence[bytes], max_events: int,
                    num_threads: Optional[int] = None,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack W serialized histories into [W, max_events, NUM_LANES] int64.
    A preallocated `out` is fully overwritten (real rows and padding)."""
    lib = _lib()
    W = len(blobs)
    blob, offsets = blob_offsets(blobs)
    out = _out(out, (W, max_events, NUM_LANES), np.int64)
    rc = lib.cadence_pack_corpus(blob, offsets.ctypes.data_as(_I64P), W, max_events, NUM_LANES,
                                 out.ctypes.data_as(_I64P),
                                 pack_threads(num_threads, cap=max(1, W)))
    if rc < 0:
        raise_pack_error(rc)
    return out


def pack_serialized32(blobs: Sequence[bytes], max_events: int,
                      num_threads: Optional[int] = None,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack W serialized histories into the wire32 format [W, max_events,
    NUM_LANES32] int32 (ops/encode.py: timestamp and expiration split
    lo/hi, every other lane range-checked)."""
    lib = _lib()
    W = len(blobs)
    blob, offsets = blob_offsets(blobs)
    out = _out(out, (W, max_events, NUM_LANES32), np.int32)
    rc = lib.cadence_pack_corpus32(blob, offsets.ctypes.data_as(_I64P), W, max_events,
                                   NUM_LANES32, out.ctypes.data_as(_I32P),
                                   pack_threads(num_threads, cap=max(1, W)))
    if rc < 0:
        raise_pack_error(rc, wire32=True)
    return out


def encode_corpus_native(histories, max_events: int = 0) -> np.ndarray:
    """The native packer in place of ops/encode.encode_corpus. Continue-as-
    new chains (batches with new_run_events) do not go through the wire
    codec, so they raise rather than lose the chained run."""
    from ..core.codec import serialize_corpus

    for h in histories:
        for b in h:
            if b.new_run_events:
                raise ValueError("native packer does not chain new_run_events yet; use "
                                 "ops.encode.encode_corpus for continued-as-new histories")
    if max_events <= 0:
        max_events = max(sum(len(b.events) for b in h) for h in histories)
    return pack_serialized(serialize_corpus(histories), max_events)
