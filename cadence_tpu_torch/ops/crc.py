"""CRC32 of canonical payload rows on the device.

The reference computes an IEEE CRC32 over the canonical mutable-state
payload; core/checksum.py mirrors it with zlib over little-endian int64
rows. `crc32_rows` hashes each [width] row to one value on the device, so
the host reads 4 bytes per workflow instead of 8 * width: kernel C
(csrc/crc32.cu) for rows on the GPU, the plain PyTorch version
`crc32_rows_plain` for rows on the CPU. `replay_to_crc` is the whole
reduction from event lanes: kernels A, B and C in turn.

CRCs are unsigned 32-bit values. Inside torch they are int64 tensors that
hold the unsigned value (torch's uint32 has almost no ops); at the numpy
boundary (ops/replay.replay_corpus) they become np.uint32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

_POLY = np.uint32(0xEDB88320)  # reflected IEEE polynomial
_MASK32 = 0xFFFFFFFF


def _make_tables() -> np.ndarray:
    """Slice-by-8 table set T[0..7]: T[0] is the classic byte table;
    T[k][i] advances T[k-1][i] by one zero byte."""
    t = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (_POLY if c & np.uint32(1) else np.uint32(0))
        t[0, i] = c
    for k in range(1, 8):
        prev = t[k - 1]
        t[k] = (prev >> np.uint32(8)) ^ t[0][prev & np.uint32(0xFF)]
    return t


_TABLES = _make_tables()


def crc32_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C: slice-by-8 CRC32 of each int64
    row's little-endian bytes, in masked int64. Returns [W] int64 holding
    the unsigned CRC, bit-identical to core.checksum.crc32_of_rows."""
    tables = torch.as_tensor(_TABLES.astype(np.int64), device=rows.device)
    crc = torch.full((rows.shape[0],), _MASK32, dtype=torch.int64, device=rows.device)
    for i in range(rows.shape[1]):
        word = rows[:, i]
        lo = word & _MASK32
        hi = (word >> 32) & _MASK32
        x = crc ^ lo
        out = torch.zeros_like(crc)
        for k in range(4):
            out = out ^ tables[7 - k][(x >> (8 * k)) & 0xFF]
        for k in range(4):
            out = out ^ tables[3 - k][(hi >> (8 * k)) & 0xFF]
        crc = out
    return crc ^ _MASK32


def crc32_rows(rows: torch.Tensor) -> torch.Tensor:
    """[W] int64 CRC32 (unsigned value) of each [W, width] int64 row:
    kernel C on the GPU, the plain version on the CPU."""
    if rows.device.type == "cpu":
        return crc32_rows_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"crc32_rows: unsupported device {rows.device}")
    launch, out = crc32_launch(rows)
    launch()
    return out


def crc32_launch(rows: torch.Tensor):
    """Check what kernel C takes (contiguous [W, width] int64 rows on the
    card; rows off a 16-byte boundary are copied, as the kernel copies them
    in 16-byte units); return (its launch, the [W] int64 output it
    writes)."""
    if rows.dim() != 2:
        raise ValueError(f"crc32_rows: expected [W, width] rows, got {tuple(rows.shape)}")
    _build.require(rows, torch.int64, rows.shape, "crc32_rows rows")
    rows = _build.aligned(rows)
    W, width = rows.shape
    out = torch.empty((W,), dtype=torch.int64, device=rows.device)
    return _build.launcher("crc32", _build.load().cadence_crc32, rows, out, W, width,
                           _build.stream_of(rows)), out


def replay_to_crc(events, layout, device=None):
    """Replay packed events [W, E, 18] int64 and reduce them to (crc32 [W]
    int64 holding the unsigned value, error [W]): kernels A, B and C in
    turn on the card, their plain versions on the CPU."""
    from .payload import payload_rows
    from .replay import replay_events

    s = replay_events(events, layout, device)
    return crc32_rows(payload_rows(s, layout)), s.error
