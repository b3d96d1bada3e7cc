"""Persisted mutable-state snapshots, host half: the record, its blob and
its store.

The JAX package's engine/snapshot.py persists one workflow's device
ReplayState row (W=1, base layout) with its canonical payload, branch,
content address (batch count + last-batch CRC32, engine/cache.py) and
pack interner, so a cold path can hydrate the row and replay only the
suffix. `Stores` builds a `SnapshotStore`, and the history store drops a
record whenever a mutation rewrites bytes under its address (tail
overwrite at or before the snapshot point, NDC branch switch, run
deletion).

This module is that file's lines 80-310: `enabled`, `layout_signature`,
the state-row blob (`pack_state_row` gives the JAX package's bytes for
the same state; `unpack_state_row` rebuilds a W=1 ReplayState of CPU
tensors), `SnapshotRecord`, `SnapshotStore` and `validate_record`. The
hydration half (`seed_caches`, `seed_from_batches`) and the writer
(`Snapshotter`) come with the resident slice of the port, whose resident
pool they feed. Until the host control plane brings the write-ahead log
(engine/durability.py), `put` logs nothing.
"""
from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.checksum import PayloadLayout
from ..utils import metrics as m
from .cache import ContentAddress

#: snapshot record format version (inside the WAL's schema version: the
#: WAL header gates the record SET, this gates the blob layout)
SNAPSHOT_VERSION = 1

#: kill switch: CADENCE_TPU_SNAPSHOT=0 disables both writing and hydration
ENABLE_ENV = "CADENCE_TPU_SNAPSHOT"


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "1") not in ("0", "false", "off")


def layout_signature(layout: PayloadLayout) -> Tuple[int, ...]:
    """The capacity tuple a snapshot's state arrays were shaped by; a
    record hydrates only into the exact layout that wrote it."""
    return (layout.max_version_history_items, layout.max_activities,
            layout.max_timers, layout.max_children,
            layout.max_request_cancels, layout.max_signals,
            layout.max_branches)


# ---------------------------------------------------------------------------
# state-row serialization (ReplayState W=1 <-> bytes)
# ---------------------------------------------------------------------------


#: blob magic: flat little-endian tensor bytes in the state's field order
#: (ops/state.leaves, the JAX package's NamedTuple flatten order);
#: shapes and dtypes are implied by the layout
_BLOB_MAGIC = b"CSNP1\n"


def pack_state_row(state_row) -> bytes:
    """Serialize a W=1 ReplayState row to bytes: magic + each tensor's raw
    bytes in field order, deterministic for a fixed layout."""
    from ..ops.state import layout_of, leaves

    _names, fields, _total = _row_template(layout_of(state_row))
    parts = [_BLOB_MAGIC]
    for (_, t), (_shape, dtype, _count, _off) in zip(leaves(state_row), fields):
        parts.append(np.ascontiguousarray(t.cpu().numpy(), dtype=dtype).tobytes())
    return b"".join(parts)


class SnapshotFormatError(Exception):
    """Blob does not decode into this layout's ReplayState shapes: the
    torn or foreign snapshot class callers must treat as a miss."""


#: layout signature -> (field names, [(shape, dtype, count, offset) per
#: tensor], total blob bytes): the W=1 template, built once per layout
_TEMPLATE_SPECS: Dict[tuple, tuple] = {}
_TEMPLATE_LOCK = threading.Lock()


def _row_template(layout: PayloadLayout):
    key = layout_signature(layout)
    spec = _TEMPLATE_SPECS.get(key)
    if spec is None:
        from ..ops.state import init_state, leaves

        names, fields = [], []
        off = len(_BLOB_MAGIC)
        for name, t in leaves(init_state(1, layout, "cpu")):
            a = t.numpy()
            names.append(name)
            fields.append((a.shape, a.dtype, int(a.size), off))
            off += a.nbytes
        spec = (tuple(names), fields, off)
        with _TEMPLATE_LOCK:
            _TEMPLATE_SPECS[key] = spec
    return spec


def unpack_state_row(blob: bytes, layout: PayloadLayout):
    """Bytes -> W=1 ReplayState of CPU tensors at `layout`; the magic and
    the exact byte length are checked against the layout's template, so a
    truncated, doctored or foreign-layout blob raises SnapshotFormatError
    instead of giving a wrong state."""
    from ..ops.convert import state_from_numpy

    names, fields, total = _row_template(layout)
    if not blob.startswith(_BLOB_MAGIC):
        raise SnapshotFormatError("bad state-blob magic")
    if len(blob) != total:
        raise SnapshotFormatError(f"state blob is {len(blob)} bytes; layout expects {total}")
    buf = bytearray(blob)
    arrs = {name: np.frombuffer(buf, dtype=dtype, count=count, offset=off).reshape(shape)
            for name, (shape, dtype, count, off) in zip(names, fields)}
    return state_from_numpy(arrs, device="cpu")


# ---------------------------------------------------------------------------
# the record + durable store
# ---------------------------------------------------------------------------


@dataclass
class SnapshotRecord:
    """One run's persisted device state at a known history point."""

    key: Tuple[str, str, str]
    batch_count: int          # content address: batches covered
    last_batch_crc: int       # content address: CRC32 of batch n-1
    events: int               # total packed events covered (lane rows)
    history_size: int         # mutable-state history_size at the point
    branch: int               # device-chosen current branch index
    payload: np.ndarray       # [width] int64 canonical payload row
    state_blob: bytes         # packed ReplayState row (pack_state_row)
    blob_crc: int             # CRC32 of state_blob (torn detection)
    interner: Dict[str, int]  # pack interner as of the snapshot point
    layout: Tuple[int, ...]   # layout_signature of the writing engine
    version: int = SNAPSHOT_VERSION

    @property
    def address(self) -> ContentAddress:
        return ContentAddress(self.batch_count, self.last_batch_crc)

    @property
    def nbytes(self) -> int:
        return len(self.state_blob) + self.payload.nbytes


class SnapshotStore:
    """Latest snapshot per run, durable through the cluster WAL when one
    is attached.

    The history store holds a back-reference (Stores wires it) and drops
    entries on the content-address-invalidating mutations: a tail
    overwrite at or before the snapshot point, an NDC current-branch
    switch, and run deletion."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._snaps: Dict[Tuple[str, str, str], SnapshotRecord] = {}
        self._wal = None

    def put(self, rec: SnapshotRecord) -> None:
        from . import crashpoints
        crashpoints.fire("store.snapshot.put")
        with self._lock:
            self._snaps[rec.key] = rec
            if self._wal is not None:
                from .durability import snapshot_record
                self._wal.append(snapshot_record(rec))

    def restore(self, rec: SnapshotRecord) -> None:
        """Recovery: install a record without re-logging it."""
        with self._lock:
            self._snaps[rec.key] = rec

    def get(self, key: Tuple[str, str, str]) -> Optional[SnapshotRecord]:
        with self._lock:
            return self._snaps.get(key)

    def drop(self, key: Tuple[str, str, str]) -> bool:
        with self._lock:
            return self._snaps.pop(key, None) is not None

    def invalidate_overwrite(self, key: Tuple[str, str, str],
                             rewritten_batch_index: int) -> None:
        """A tail overwrite rewrote batches from `rewritten_batch_index`
        on: a snapshot covering any rewritten batch is dead; one strictly
        before the rewrite point is still a valid prefix and survives."""
        with self._lock:
            rec = self._snaps.get(key)
            if rec is not None and rec.batch_count > rewritten_batch_index:
                del self._snaps[key]

    def invalidate_branch_switch(self, key: Tuple[str, str, str]) -> None:
        """NDC moved the current branch: the snapshot's lineage is no
        longer the one consumers replay."""
        self.drop(key)

    def keys(self) -> List[Tuple[str, str, str]]:
        with self._lock:
            return list(self._snaps.keys())

    def items(self) -> List[Tuple[Tuple[str, str, str], SnapshotRecord]]:
        with self._lock:
            return list(self._snaps.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._snaps.values())

    def stats(self) -> Dict[str, object]:
        with self._lock:
            recs = list(self._snaps.values())
        return {
            "entries": len(recs),
            "bytes": sum(r.nbytes for r in recs),
            "events_covered": sum(r.events for r in recs),
        }


def validate_record(rec: SnapshotRecord, layout: PayloadLayout,
                    registry=None) -> bool:
    """Cheap integrity gate shared by every consumer: format version,
    layout signature, and blob CRC. Counts and returns False on any
    mismatch; the caller falls back to full replay."""
    reg = registry if registry is not None else m.DEFAULT_REGISTRY
    if rec.version != SNAPSHOT_VERSION \
            or tuple(rec.layout) != layout_signature(layout):
        reg.inc(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_IGNORED_STALE)
        return False
    if zlib.crc32(rec.state_blob) != rec.blob_crc:
        reg.inc(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_IGNORED_TORN)
        return False
    return True
