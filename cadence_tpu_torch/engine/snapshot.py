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

The host half: `enabled`, `layout_signature`, the state-row blob
(`pack_state_row` gives the JAX package's bytes for the same state;
`unpack_state_row` rebuilds a W=1 ReplayState of CPU tensors),
`SnapshotRecord`, `SnapshotStore` and `validate_record`. On durable
stores (engine/durability.py) `put` logs each record as a "snap" record
of the write-ahead log.

The device half feeds and reads the resident pool (engine/resident.py):
- `seed_caches` / `seed_from_batches` hydrate a valid record into the
  pool and seed the pack cache's interner at the snapshot point; a torn
  blob, stale address or foreign layout is counted and ignored, and the
  caller falls back to full replay. Inside one pool call (`with
  resident.batch():`) many hydrations stack on the host and reach the
  device as one copy per state tensor and one kernel-G scatter;
- `Snapshotter` writes records under a policy (CADENCE_TPU_SNAPSHOT_
  MIN_EVENTS, _EVERY_EVENTS), each behind the checksum gate: the resident
  payload row must equal the oracle's live row, branch included. Its
  `sweep` reads every written key's state back with one kernel-G gather
  and one copy per state tensor.
"""
from __future__ import annotations

import functools
import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..utils import metrics as m
from .cache import ContentAddress

#: snapshot record format version (inside the WAL's schema version: the
#: WAL header gates the record SET, this gates the blob layout)
SNAPSHOT_VERSION = 1

#: kill switch: CADENCE_TPU_SNAPSHOT=0 disables both writing and hydration
ENABLE_ENV = "CADENCE_TPU_SNAPSHOT"


#: min total packed events before a workflow earns a snapshot record
MIN_EVENTS_ENV = "CADENCE_TPU_SNAPSHOT_MIN_EVENTS"
DEFAULT_MIN_EVENTS = 8
#: appended events since the last snapshot before the next one is due
EVERY_EVENTS_ENV = "CADENCE_TPU_SNAPSHOT_EVERY_EVENTS"
DEFAULT_EVERY_EVENTS = 32


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


def pack_state_rows(states) -> List[bytes]:
    """Serialize every row of a batched ReplayState: magic + each tensor's
    raw bytes in field order, deterministic for a fixed layout. One copy
    to the host per state tensor, then bytes per row."""
    from ..ops.state import layout_of, leaves

    _names, fields, _total = _row_template(layout_of(states))
    host = [np.ascontiguousarray(t.cpu().numpy(), dtype=dtype)
            for (_, t), (_shape, dtype, _count, _off) in zip(leaves(states), fields)]
    return [b"".join([_BLOB_MAGIC] + [a[i].tobytes() for a in host])
            for i in range(states.state.shape[0])]


def pack_state_row(state_row) -> bytes:
    """Serialize a W=1 ReplayState row to bytes (pack_state_rows)."""
    return pack_state_rows(state_row)[0]


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
    instead of giving a wrong state. The tensors are views of one copy of
    the blob (a warm start unpacks one row per workflow)."""
    import torch

    from ..ops.state import map_state

    _names, fields, total = _row_template(layout)
    if not blob.startswith(_BLOB_MAGIC):
        raise SnapshotFormatError("bad state-blob magic")
    if len(blob) != total:
        raise SnapshotFormatError(f"state blob is {len(blob)} bytes; layout expects {total}")
    buf = bytearray(blob)
    it = iter(fields)

    def view(_):
        shape, dtype, count, off = next(it)
        return torch.from_numpy(np.frombuffer(buf, dtype=dtype, count=count,
                                              offset=off).reshape(shape))

    return map_state(view, _meta_row(layout))


@functools.lru_cache(maxsize=None)
def _meta_row(layout: PayloadLayout):
    """A W=1 state of meta tensors at `layout`: the structure unpack fills."""
    from ..ops.state import init_state

    return init_state(1, layout, "meta")


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


# ---------------------------------------------------------------------------
# hydration: snapshot -> resident pool + pack cache (the shared cold-path seam)
# ---------------------------------------------------------------------------


def seed_caches(rec: SnapshotRecord, resident, pack_cache,
                layout: PayloadLayout, registry=None) -> bool:
    """Admit a validated snapshot into the resident pool and seed the pack
    cache's interner at the snapshot point, so every later suffix encode
    resumes from it. The address's validity against the current history
    is the caller's job; this guards only the blob."""
    reg = registry if registry is not None else m.DEFAULT_REGISTRY
    try:
        state_row = unpack_state_row(rec.state_blob, layout)
    except SnapshotFormatError:
        reg.inc(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_IGNORED_TORN)
        return False
    if not resident.admit(rec.key, rec.address, state_row, rec.payload, rec.branch):
        return False
    if pack_cache is not None:
        pack_cache.seed_suffix(rec.key, rec.address, rec.interner, rec.events)
    reg.inc(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_HYDRATES)
    return True


def seed_from_batches(snapshots: Optional[SnapshotStore], resident, pack_cache, key, batches,
                      layout: PayloadLayout, registry=None) -> bool:
    """Full-batch-list hydration (verify and rebuild, which hold the
    history anyway): validate the record's content address against
    `batches` (exact or prefix), then seed. A stale address is counted and
    ignored; the caller's cold path takes the key."""
    from .cache import address_relation

    if snapshots is None or not enabled():
        return False
    rec = snapshots.get(key)
    if rec is None:
        return False
    reg = registry if registry is not None else m.DEFAULT_REGISTRY
    if not validate_record(rec, layout, reg):
        return False
    if address_relation(rec.address, batches) not in ("exact", "prefix"):
        reg.inc(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_IGNORED_STALE)
        return False
    return seed_caches(rec, resident, pack_cache, layout, reg)


# ---------------------------------------------------------------------------
# the writer (policy + checksum gate)
# ---------------------------------------------------------------------------


@dataclass
class SweepReport:
    considered: int = 0
    written: int = 0
    skipped_policy: int = 0
    skipped_checksum: int = 0
    skipped_not_at_tip: int = 0
    keys_written: List[tuple] = field(default_factory=list)


class Snapshotter:
    """Checksum-gated snapshot writer over the resident pool, one per
    replay engine (TPUReplayEngine.snapshotter()), sharing its stores,
    resident pool, pack cache and layout. `note_append` feeds the
    appended-events policy counter from the serving tier; `snapshot_key`
    writes one record when the gates pass; `sweep` drives every resident
    key."""

    def __init__(self, stores, resident, pack_cache, layout: PayloadLayout = DEFAULT_LAYOUT,
                 registry=None, min_events: Optional[int] = None,
                 every_events: Optional[int] = None) -> None:
        self.stores = stores
        self.resident = resident
        self.pack_cache = pack_cache
        self.layout = layout
        self.metrics = registry if registry is not None else m.DEFAULT_REGISTRY
        self.min_events = (min_events if min_events is not None
                           else int(os.environ.get(MIN_EVENTS_ENV, str(DEFAULT_MIN_EVENTS))))
        self.every_events = (every_events if every_events is not None
                             else int(os.environ.get(EVERY_EVENTS_ENV,
                                                     str(DEFAULT_EVERY_EVENTS))))
        self._lock = threading.Lock()
        #: called with every record this writer persists (snapshot-shipping
        #: replication, engine/multicluster.py); a failure never fails the write
        self.shipper = None
        #: per-key appended events since the last snapshot write
        self._since: Dict[tuple, int] = {}
        #: keys not to re-probe until every_events more accumulate
        self._known: set = set()

    def _scope(self):
        return self.metrics.scope(m.SCOPE_TPU_SNAPSHOT)

    def note_append(self, key: tuple, events: int) -> None:
        with self._lock:
            if len(self._since) > 65536:
                self._since.clear()  # bounded; cleared keys re-accumulate
            self._since[key] = self._since.get(key, 0) + int(events)

    def due(self, key: tuple) -> bool:
        """Whether the policy wants a fresh record for this key: none
        stored yet, or enough events appended since the last one."""
        if not enabled():
            return False
        with self._lock:
            if self._since.get(key, 0) >= self.every_events:
                return True
            if key in self._known:
                return False
        if self.stores.snapshot.get(key) is None:
            return True
        self._defer(key)
        return False

    def _defer(self, key: tuple, reset_counter: bool = False) -> None:
        """Mark a key not due until every_events more accumulate."""
        with self._lock:
            if reset_counter:
                self._since[key] = 0
            if len(self._known) > 65536:
                self._known.clear()
            self._known.add(key)

    def maybe_snapshot(self, key: tuple) -> bool:
        """The per-transaction policy hook: write when due; a gate-failed
        attempt defers the key until every_events more accumulate."""
        if not self.due(key):
            return False
        if self.snapshot_key(key):
            return True
        self._defer(key, reset_counter=True)
        return False

    def snapshot_key(self, key: tuple, force: bool = False) -> bool:
        """Write one snapshot record if every gate passes: a base-rung
        resident entry at the store's single-lineage tip; the policy (due
        and min_events, unless `force`); the checksum gate (resident
        payload and branch equal to the live mutable state)."""
        prepared = self._prepare(key, force)
        if prepared is None:
            return False
        state, kept = self.resident.gather_current([prepared[1]])
        if not kept:
            return False  # re-admitted or evicted since the gates ran
        return self._write(prepared, pack_state_row(state))

    def _prepare(self, key: tuple, force: bool):
        """Run snapshot_key's gates; (key, entry, events, interner,
        history size) of a record to write, or None."""
        if not enabled():
            return None
        entry = self.resident.entry_for(key)
        if entry is None or entry.rung != 0:
            return None
        hs = self.stores.history
        try:
            if hs.branch_count(*key) > 1 or hs.get_current_branch(*key) != 0:
                return None
            total = hs.batch_count(*key)
            if total == 0 or entry.address.batch_count != total:
                return None
            boundary = hs.as_history_batches_range(*key, from_batch=total - 1)
        except Exception:
            return None
        from .cache import batch_crc
        if not boundary or batch_crc(boundary[0]) != entry.address.last_batch_crc:
            return None  # resident not at the stored tip
        events = (self.pack_cache.events_for(key, entry.address)
                  if self.pack_cache is not None else None)
        if not force:
            if not self.due(key):
                return None
            if events is not None and events < self.min_events:
                return None
        try:
            from ..core.checksum import STICKY_ROW_INDEX, payload_row
            ms = self.stores.execution.get_workflow(*key)
            live = payload_row(ms, self.layout)
            live[STICKY_ROW_INDEX] = 0
            live_branch = int(ms.version_histories.current_index)
        except Exception:
            return None
        if not (entry.payload == live).all() or int(entry.branch) != live_branch:
            self._scope().inc(m.M_SNAP_CHECKSUM_SKIPS)
            return None
        interner = (self.pack_cache.interner_for(key, entry.address)
                    if self.pack_cache is not None else None)
        if interner is None or events is None:
            # no pack entry at this address: one full pack at write time
            # recovers the interner and the event count
            if self.pack_cache is None:
                return None
            self.pack_cache.encode(key, hs.as_history_batches(*key))
            interner = self.pack_cache.interner_for(key, entry.address)
            events = self.pack_cache.events_for(key, entry.address)
            if interner is None or events is None:
                return None
        if not force and events < self.min_events:
            return None
        try:
            history_size = hs.serialized_size(*key)
        except Exception:
            return None
        return key, entry, int(events), dict(interner), int(history_size)

    def _write(self, prepared, blob: bytes) -> bool:
        key, entry, events, interner, history_size = prepared
        rec = SnapshotRecord(
            key=key, batch_count=entry.address.batch_count,
            last_batch_crc=entry.address.last_batch_crc, events=events,
            history_size=history_size, branch=int(entry.branch),
            payload=np.asarray(entry.payload, dtype=np.int64), state_blob=blob,
            blob_crc=zlib.crc32(blob), interner=interner, layout=layout_signature(self.layout))
        self.stores.snapshot.put(rec)
        if self.shipper is not None:
            try:
                self.shipper(rec)
            except Exception:
                pass  # shipping is for another region's warm start
        self._defer(key, reset_counter=True)
        self._scope().inc(m.M_SNAP_WRITES)
        self._gauges()
        return True

    def _gauges(self) -> None:
        # one method call, which a store served over the wire answers too
        # (rpc/client.RemoteStores forwards methods, not len() or
        # properties; the JAX package's len() raises there, after the
        # record is written, and fails the rest of the flush)
        st = self.stores.snapshot.stats()
        self.metrics.gauge(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_ENTRIES, float(st["entries"]))
        self.metrics.gauge(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_BYTES, float(st["bytes"]))

    def sweep(self, keys=None, force: bool = False) -> SweepReport:
        """Snapshot every resident key (or `keys`); `force` bypasses the
        due/min-events policy, never the tip or checksum gates. The gates
        run key by key; the states of every key that passed come back with
        one kernel-G gather per slab and one copy per state tensor, then
        the records are written in key order. A key the serving drain
        re-admitted or evicted between its gates and the gather is counted
        as not at the tip, and not written."""
        report = SweepReport()
        passed = []
        for key in (keys if keys is not None else self.resident.keys()):
            report.considered += 1
            pre = self.metrics.counter(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_CHECKSUM_SKIPS)
            prepared = self._prepare(key, force)
            if prepared is not None:
                passed.append(prepared)
            elif self.metrics.counter(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_CHECKSUM_SKIPS) > pre:
                report.skipped_checksum += 1
            elif not force and not self.due(key):
                report.skipped_policy += 1
            else:
                report.skipped_not_at_tip += 1
        by_slab: Dict[int, List[int]] = {}
        for i, (_, entry, _, _, _) in enumerate(passed):
            by_slab.setdefault(id(entry.slot.slab), []).append(i)
        blobs: Dict[int, bytes] = {}
        for idx in by_slab.values():
            state, kept = self.resident.gather_current([passed[i][1] for i in idx])
            if kept:
                blobs.update(zip((idx[j] for j in kept), pack_state_rows(state)))
        for i, prepared in enumerate(passed):
            if i not in blobs:
                report.skipped_not_at_tip += 1
                continue
            self._write(prepared, blobs[i])
            report.written += 1
            report.keys_written.append(prepared[0])
        self._gauges()
        return report
