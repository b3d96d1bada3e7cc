"""The native host corpus generator (generator.cc, a byte-for-byte copy of
the JAX package's). It runs its own sequential splitmix64 stream per
workflow, so its histories are not ops/genkernel.py's: each is held to
its own JAX counterpart."""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from ..ops.encode import NUM_LANES
from . import build as _build


def generator_available() -> bool:
    return _build.load_generator() is not None


def generate_corpus_native(seed: int, first_index: int, num_workflows: int, max_events: int,
                           num_threads: Optional[int] = None,
                           out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """Fill [num_workflows, max_events, NUM_LANES] int64 with distinct
    histories for global indices [first_index, first_index +
    num_workflows); returns (lanes, real event count). Pass `out` to reuse
    a buffer."""
    lib = _build.load_generator()
    if lib is None:
        raise RuntimeError("native generator unavailable: no C++ compiler (g++) on PATH")
    if num_threads is None:
        num_threads = os.cpu_count() or 1
    shape = (num_workflows, max_events, NUM_LANES)
    if out is None:
        out = np.empty(shape, dtype=np.int64)
    elif out.shape != shape or out.dtype != np.int64 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out buffer {out.shape} {out.dtype}: expected a C-contiguous {shape} "
                         "int64")
    total = lib.cadence_generate_corpus(ctypes.c_uint64(seed), first_index, num_workflows,
                                        max_events, NUM_LANES,
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                        num_threads)
    return out, int(total)
