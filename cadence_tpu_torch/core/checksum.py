"""Mutable-state checksum: the replay parity oracle.

The reference computes a CRC32 over a thrift-serialized canonical payload of
the mutable state (service/history/execution/checksum.go:36-114,
CRC at common/checksum/crc.go:35-76). This framework keeps the
same payload *content and field order* but serializes it as a fixed-width
little-endian int64 row, so the identical payload can be produced by the
Python oracle (from a `MutableState`) and by the device kernels (from the dense
`ReplayState` tensors, sorted on the device) and compared elementwise.

Payload field order (mirroring checksum.go:58-113):
  cancel_requested, state, last_first_event_id, next_event_id,
  last_processed_event_id, signal_count, decision_attempt,
  decision_schedule_id, decision_started_id, decision_version,
  sticky_task_list (fnv64 hash; 0 when empty — always empty after replay,
  state_builder.go:108), version histories (count + (event_id, version)
  pairs), then the five sorted pending-ID lists, each count-prefixed:
  timer started IDs, activity schedule IDs, child initiated IDs,
  signal initiated IDs, request-cancel initiated IDs.

Counts are included (reference thrift lists are length-delimited) and lists
are padded to the layout capacities with PAD so rows are fixed-width.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Sequence

import numpy as np

if TYPE_CHECKING:  # avoid oracle<->core import cycle at runtime
    from ..oracle.mutable_state import MutableState

# Pad sentinel for unused list slots. Positive-huge so a plain ascending
# sort of the kernel's dense ID arrays yields [real ids..., PAD...] in
# exactly this row layout; never a legal event ID (real ids are small) nor a
# legal version, so padded rows cannot collide with real payloads.
PAD = np.int64(1 << 62)

CHECKSUM_PAYLOAD_VERSION = 1  # mutableStateChecksumPayloadV1, checksum.go:33
CHECKSUM_FLAVOR_IEEE_CRC32_OVER_INT64 = 1


@dataclass(frozen=True)
class PayloadLayout:
    """Fixed capacities of the canonical payload row (must match the kernel's
    table capacities in ops/state.py)."""

    max_version_history_items: int = 8
    max_activities: int = 16
    max_timers: int = 16
    max_children: int = 8
    max_request_cancels: int = 8
    max_signals: int = 8
    #: version-history branches the kernel can carry per workflow (NDC
    #: divergence); does not affect the payload width — the canonical
    #: payload covers the CURRENT branch only (checksum.go:92-100)
    max_branches: int = 2

    NUM_SCALARS = 11  # fields before the version-history block

    @property
    def width(self) -> int:
        return (
            self.NUM_SCALARS
            + 1 + 2 * self.max_version_history_items
            + 1 + self.max_timers
            + 1 + self.max_activities
            + 1 + self.max_children
            + 1 + self.max_signals
            + 1 + self.max_request_cancels
        )


DEFAULT_LAYOUT = PayloadLayout()

#: row index of the sticky-task-list hash. Replay always clears stickyness
#: (state_builder.go:108), so device-replayed rows carry 0 here while a live
#: ACTIVE state may legitimately hold a sticky hash — live-vs-replay
#: comparisons mask this field (the reference never replay-derives it
#: either: its checksum is only compared against the same stored state).
STICKY_ROW_INDEX = 10


def fnv64(s: str) -> int:
    """FNV-1a 64-bit hash, wrapped to signed int64; 0 for the empty string."""
    if not s:
        return 0
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h - (1 << 64) if h >= (1 << 63) else h


def _put_list(row: np.ndarray, offset: int, ids: Sequence[int], cap: int, what: str) -> int:
    if len(ids) > cap:
        raise OverflowError(f"{what}: {len(ids)} pending items exceed layout capacity {cap}")
    row[offset] = len(ids)
    offset += 1
    row[offset : offset + len(ids)] = sorted(ids)
    offset += cap
    return offset


def payload_row(ms: "MutableState", layout: PayloadLayout = DEFAULT_LAYOUT) -> np.ndarray:
    """Canonical payload row for one mutable state (oracle side)."""
    info = ms.execution_info
    row = np.full(layout.width, PAD, dtype=np.int64)
    row[0] = 1 if info.cancel_requested else 0
    row[1] = int(info.state)
    row[2] = info.last_first_event_id
    row[3] = info.next_event_id
    row[4] = info.last_processed_event
    row[5] = info.signal_count
    row[6] = info.decision_attempt
    row[7] = info.decision_schedule_id
    row[8] = info.decision_started_id
    row[9] = info.decision_version
    row[10] = fnv64(info.sticky_task_list)
    offset = layout.NUM_SCALARS

    items = ms.version_histories.current().items
    if len(items) > layout.max_version_history_items:
        raise OverflowError(
            f"version history items {len(items)} exceed capacity {layout.max_version_history_items}"
        )
    row[offset] = len(items)
    offset += 1
    for i, item in enumerate(items):
        row[offset + 2 * i] = item.event_id
        row[offset + 2 * i + 1] = item.version
    offset += 2 * layout.max_version_history_items

    offset = _put_list(
        row, offset,
        [ti.started_id for ti in ms.pending_timer_info_ids.values()],
        layout.max_timers, "timers",
    )
    offset = _put_list(
        row, offset, list(ms.pending_activity_info_ids.keys()),
        layout.max_activities, "activities",
    )
    offset = _put_list(
        row, offset, list(ms.pending_child_execution_info_ids.keys()),
        layout.max_children, "children",
    )
    offset = _put_list(
        row, offset, list(ms.pending_signal_info_ids.keys()),
        layout.max_signals, "signals",
    )
    offset = _put_list(
        row, offset, list(ms.pending_request_cancel_info_ids.keys()),
        layout.max_request_cancels, "request cancels",
    )
    assert offset == layout.width
    return row


def crc32_of_row(row: np.ndarray) -> int:
    """IEEE CRC32 over the row's little-endian bytes.

    Reference analog: checksum.GenerateCRC32 (common/checksum/crc.go:35-57).
    """
    return zlib.crc32(np.ascontiguousarray(row, dtype="<i8").tobytes())


def crc32_of_rows(rows: np.ndarray) -> np.ndarray:
    """Vectorized (per-row) CRC32 for a [W, width] payload matrix."""
    rows = np.ascontiguousarray(rows, dtype="<i8")
    return np.fromiter(
        (zlib.crc32(r.tobytes()) for r in rows), dtype=np.uint32, count=len(rows)
    )


@dataclass(frozen=True)
class Checksum:
    """Reference analog: checksum.Checksum (common/checksum/checksum.go)."""

    version: int
    flavor: int
    value: int

    @classmethod
    def of(cls, ms: "MutableState", layout: PayloadLayout = DEFAULT_LAYOUT) -> "Checksum":
        return cls(
            version=CHECKSUM_PAYLOAD_VERSION,
            flavor=CHECKSUM_FLAVOR_IEEE_CRC32_OVER_INT64,
            value=crc32_of_row(payload_row(ms, layout)),
        )


def verify(ms: "MutableState", csum: Checksum, layout: PayloadLayout = DEFAULT_LAYOUT) -> None:
    """Reference analog: checksum.Verify (crc.go:59-76)."""
    if csum.version != CHECKSUM_PAYLOAD_VERSION:
        raise ValueError(f"invalid checksum payload version {csum.version}")
    if csum.flavor != CHECKSUM_FLAVOR_IEEE_CRC32_OVER_INT64:
        raise ValueError(f"unknown checksum flavor {csum.flavor}")
    actual = Checksum.of(ms, layout)
    if actual.value != csum.value:
        raise ValueError(f"checksum mismatch: expected {csum.value}, got {actual.value}")
