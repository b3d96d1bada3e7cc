"""The device-resident mutable-state pool: O(new events) append replay.

The reference never replays a live workflow from event 0 on the hot path:
the history engine's execution cache (service/history/execution/cache.go)
keeps each open workflow's mutable state warm, and a transaction applies
only its new events. ResidentStateCache is the device twin of that cache,
the JAX package's engine/resident.py under the same names:

- each workflow's final ReplayState row stays on the device between
  calls, LRU-bounded by a byte budget (CADENCE_TPU_RESIDENT_HBM_BUDGET);
- entries are content-addressed by (workflow key, batch count, last-batch
  CRC32), the pack cache's scheme (engine/cache.py): a tail overwrite,
  reset rewrite or NDC branch switch changes the address, and the stale
  entry is dropped, counted, never served;
- an append replays ONLY the new batches: the suffix lanes scan against
  the resident states with kernel A (ops/replay.replay_scan);
- capacity overflow during an append stays on the device: the ladder
  widens the PRE-append states and re-replays just the suffix
  (engine/ladder.escalate_resident); resolved rows stay resident at the
  widened layout and re-narrow to the base layout once their pending
  load drains (ops/state.narrow_ok, kernel H);
- under a mesh (set_mesh) the pool shards across `mesh.devices` by
  parallel/mesh.workflow_shard: the budget splits into equal slices, each
  with its own LRU order, and each group's append runs on its device.

The representation differs from the JAX package's, not the accounting.
There each entry pins a W=1 pytree of 66 device arrays. Here the rows of
one (shard slice, layout) live in a SLAB: a batched ReplayState of
`capacity` rows on the slice's device, a free list of its slots, grown by
doubling with one kernel-G copy. An entry holds a slot reference
(`ResidentEntry.slot`); `state_of(entry)` materialises its W=1 state.
Admitting, gathering a group for an append, widening, re-narrowing and
growing are kernel G launches (ops/rehome.py), never 66 per-tensor
copies. The budget, LRU order and evictions are the JAX package's to the
byte: `_row_nbytes` counts a row as the JAX package does, and
`slab_bytes` reports what the slabs really hold beside it.

Two rules keep the slots safe:
- Slots freed during a call (an eviction or an invalidation inside
  `replay_append`, `admit`, ...) go back to the free list only when the
  outermost call returns, so a pre-append state that the ladder reads
  after a same-call eviction is still there; a same-layout re-admit
  writes back into the entry's own slot, and only a change of layout
  (widen or re-narrow) moves a row.
- Admits record their writes; the bookkeeping runs in the JAX package's
  sequential order, and the writes of rows still resident launch
  together (one kernel G per source batch and slab) when the call ends,
  or before anything reads the slab. No launch writes one slot twice.
Every launch runs on the current stream of the slab's device, under the
pool's lock.

Counters land under `tpu.resident` (hits, suffix-hits, misses,
invalidations, evictions, events-appended, widened and re-narrowed
rows) with the resident-bytes, entries and budget gauges.
"""
from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..device import canonical_device, resolve_device
from ..ops.encode import NUM_LANES, history_length
from ..ops.rehome import rehome
from ..ops.state import ReplayState, empty_state, init_state, layout_of, leaves, map_state
from ..utils import metrics as m
from .cache import ContentAddress, address_relation, content_address

#: byte budget for resident states (LRU evicts past it)
BUDGET_ENV = "CADENCE_TPU_RESIDENT_HBM_BUDGET"
DEFAULT_BUDGET = 256 << 20
#: workflows per append-replay chunk through the bulk executor
CHUNK_ENV = "CADENCE_TPU_RESIDENT_CHUNK"
DEFAULT_CHUNK = 2048
#: kill switch (CADENCE_TPU_RESIDENT=0 sends every call down the
#: full-replay path)
ENABLE_ENV = "CADENCE_TPU_RESIDENT"
#: rows a new slab holds before its first doubling
SLAB_ROWS = 64

#: live caches (the tests reset them between cases: their slabs hold
#: device memory that must not leak across tests)
_LIVE: "weakref.WeakSet[ResidentStateCache]" = weakref.WeakSet()


def reset_all() -> None:
    """Clear every live cache's entries and slabs."""
    for cache in list(_LIVE):
        cache.clear()


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "1") not in ("0", "false", "off")


def _bucket(n: int, floor: int) -> int:
    return max(floor, 1 << (max(1, int(n)) - 1).bit_length())


class _Slab:
    """The rows of one (shard slice, layout): a batched ReplayState on one
    device, its free slots (lowest first) and each slot's owning entry."""

    def __init__(self, layout: PayloadLayout, device: torch.device) -> None:
        self.layout = layout
        self.device = device
        self.state = empty_state(SLAB_ROWS, layout, device)
        self.free = list(range(SLAB_ROWS - 1, -1, -1))
        self.owner: List[Optional[ResidentEntry]] = [None] * SLAB_ROWS
        self.row_bytes = _row_state_bytes(layout)

    @property
    def capacity(self) -> int:
        return len(self.owner)

    @property
    def nbytes(self) -> int:
        return self.capacity * self.row_bytes

    def grow(self) -> None:
        """Double the slab: one kernel-G copy of every row into the new one."""
        cap = self.capacity
        bigger = empty_state(2 * cap, self.layout, self.device)
        rows = torch.arange(cap)
        self.state = rehome(self.state, rows, self.layout, bigger, rows)
        self.free = list(range(2 * cap - 1, cap - 1, -1)) + self.free
        self.owner.extend([None] * cap)


def _row_state_bytes(layout: PayloadLayout) -> int:
    """Bytes of one state row at `layout` (every tensor's row)."""
    return sum(t.element_size() * t.numel() for _, t in leaves(init_state(1, layout, "meta")))


class Slot(NamedTuple):
    """Where a resident row lives: a slab and a row index in it."""

    slab: _Slab
    index: int


@dataclass
class ResidentEntry:
    """One workflow's pinned state row and the host-side payload row that
    serves exact hits without touching the device."""

    slot: Slot               # the row in its slab (state_of materialises it)
    payload: np.ndarray      # [base_width] canonical payload row
    branch: int              # device-chosen current branch
    address: ContentAddress
    rung: int                # 0 = base layout; r > 0 = widened 2**r
    nbytes: int


@dataclass
class AppendResult:
    """Outcome of one append transaction (aligned with replay_append's
    items): resolved rows carry the post-append canonical payload;
    unresolved ones name the kernel error and fall to the caller's oracle
    arbitration (their entry is already invalidated)."""

    ok: bool
    payload: Optional[np.ndarray] = None
    branch: int = 0
    error: int = 0
    rung: int = 0
    escalated: bool = False


@dataclass
class AppendReport:
    """Per-call accounting."""

    transactions: int = 0
    events_appended: int = 0
    escalated_rows: int = 0
    #: (workflows, suffix event axis) per launched chunk: equal suffixes
    #: launch equal shapes whatever the histories' lengths
    chunk_shapes: List[Tuple[int, int]] = field(default_factory=list)


class ResidentStateCache:
    """Content-addressed LRU of device-resident per-workflow states, kept
    in slabs on the devices of `mesh` (set_mesh), or on `device` (None:
    the card) when no mesh is bound."""

    def __init__(self, layout: PayloadLayout = DEFAULT_LAYOUT,
                 budget_bytes: Optional[int] = None,
                 registry=None, ladder=None,
                 chunk_workflows: Optional[int] = None,
                 pipeline_depth: Optional[int] = None,
                 mesh=None, device=None) -> None:
        self.layout = layout
        self.budget_bytes = (budget_bytes if budget_bytes is not None
                             else int(os.environ.get(BUDGET_ENV, str(DEFAULT_BUDGET))))
        self.metrics = registry if registry is not None else m.DEFAULT_REGISTRY
        #: widened-K escalation for appends that overflow the resident
        #: layout (engine/ladder.py); None: flagged appends fail to the
        #: caller's oracle path
        self.ladder = ladder
        self.chunk_workflows = (chunk_workflows if chunk_workflows
                                else int(os.environ.get(CHUNK_ENV, str(DEFAULT_CHUNK))))
        self.pipeline_depth = pipeline_depth
        self.device = device
        self._lock = threading.RLock()
        self._mesh = mesh
        n = mesh.size if mesh is not None else 1
        self._slices: List["OrderedDict[tuple, ResidentEntry]"] = [
            OrderedDict() for _ in range(n)]
        self._slice_bytes: List[int] = [0] * n
        self._row_bytes_cache: Dict[PayloadLayout, int] = {}
        #: (shard, layout) -> slab
        self._slabs: Dict[Tuple[int, PayloadLayout], _Slab] = {}
        #: calls in progress (across threads), slots freed meanwhile, and
        #: the recorded writes: (id(slab), slot) -> (slab, slot, src, row)
        self._depth = 0
        self._deferred: List[Slot] = []
        self._writes: Dict[Tuple[int, int], tuple] = {}
        #: rows admitted from the CPU into a slab on a card (snapshot
        #: hydration), stacked on the host on their way over
        self.host_rows = 0
        self.last_append = AppendReport()
        _LIVE.add(self)
        self._gauges()

    # -- mesh sharding ------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        """(Re)bind the pool to a mesh: per-device slices keyed by
        workflow_shard, the budget split per device. Rebinding to another
        width, or to the same width over other devices, drops every entry
        (their rows live on the old assignment's devices); an unsharded
        pool keeps its entries."""
        n = mesh.size if mesh is not None else 1
        new_devs = tuple(mesh.devices) if mesh is not None and n > 1 else ()
        with self._lock:
            old_n = len(self._slices)
            old_devs = (tuple(self._mesh.devices)
                        if self._mesh is not None and old_n > 1 else ())
            self._mesh = mesh
            if n == old_n and new_devs == old_devs:
                return
            if old_n > 1:
                for d in range(old_n):
                    self.metrics.gauge(m.SCOPE_TPU_RESIDENT,
                                       m.device_metric(m.M_RESIDENT_BYTES, d), 0.0)
            self._slices = [OrderedDict() for _ in range(n)]
            self._slice_bytes = [0] * n
            self._drop_slabs_locked()
            self._gauges_locked()

    @property
    def n_shards(self) -> int:
        return len(self._slices)

    def shard_of(self, key: tuple) -> int:
        from ..parallel.mesh import workflow_shard
        return workflow_shard(key, len(self._slices))

    def device_of(self, key: tuple):
        """The mesh device owning this key's slice (None when the pool is
        unsharded)."""
        if self._mesh is None or len(self._slices) <= 1:
            return None
        return self._mesh.devices[self.shard_of(key)]

    def _slice_device(self, shard: int) -> torch.device:
        """The device of a shard slice's slabs, named as its tensors name
        it, so that a row from that device is written in place."""
        if self._mesh is not None:
            return canonical_device(self._mesh.devices[shard])
        return canonical_device(resolve_device(self.device))

    @property
    def slice_budget(self) -> int:
        return max(1, self.budget_bytes // len(self._slices))

    # -- bookkeeping --------------------------------------------------------

    def _scope(self):
        return self.metrics.scope(m.SCOPE_TPU_RESIDENT)

    def _gauges(self) -> None:
        with self._lock:
            self._gauges_locked()

    def _gauges_locked(self) -> None:
        self.metrics.gauge(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_BYTES,
                           float(sum(self._slice_bytes)))
        self.metrics.gauge(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_ENTRIES,
                           float(sum(len(s) for s in self._slices)))
        self.metrics.gauge(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_BUDGET_BYTES,
                           float(self.budget_bytes))
        if len(self._slices) > 1:
            for d, nbytes in enumerate(self._slice_bytes):
                self.metrics.gauge(m.SCOPE_TPU_RESIDENT,
                                   m.device_metric(m.M_RESIDENT_BYTES, d), float(nbytes))

    def _row_nbytes(self, layout: PayloadLayout) -> int:
        """Bytes of one W=1 state row at `layout` plus the host payload row,
        the JAX package's formula (what the budget counts)."""
        cached = self._row_bytes_cache.get(layout)
        if cached is None:
            cached = _row_state_bytes(layout) + self.layout.width * 8
            self._row_bytes_cache[layout] = cached
        return cached

    def __len__(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._slices)

    def keys(self) -> List[tuple]:
        """Every pinned workflow key across the shard slices."""
        with self._lock:
            return [k for sl in self._slices for k in sl.keys()]

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._slice_bytes)

    @property
    def slab_bytes(self) -> int:
        """Device bytes the slabs hold (every slot, used or free)."""
        with self._lock:
            return sum(slab.nbytes for slab in self._slabs.values())

    def stats(self) -> Dict[str, object]:
        """Occupancy, hit-rate and budget rollup."""
        reg = self.metrics
        hits = reg.counter(m.SCOPE_TPU_RESIDENT, m.M_CACHE_HITS)
        suffix = reg.counter(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_SUFFIX_HITS)
        misses = reg.counter(m.SCOPE_TPU_RESIDENT, m.M_CACHE_MISSES)
        looked = hits + suffix + misses
        with self._lock:
            entries = sum(len(s) for s in self._slices)
            resident = sum(self._slice_bytes)
            widened = sum(1 for s in self._slices for e in s.values() if e.rung > 0)
            per_device = list(self._slice_bytes)
        return {
            "entries": entries,
            "widened_entries": widened,
            "resident_bytes": resident,
            "mesh_shards": len(per_device),
            "per_device_bytes": per_device,
            "budget_bytes": self.budget_bytes,
            "budget_used": (resident / self.budget_bytes if self.budget_bytes else 0.0),
            "hits": hits,
            "suffix_hits": suffix,
            "misses": misses,
            "hit_rate": ((hits + suffix) / looked) if looked else 0.0,
            "invalidations": reg.counter(m.SCOPE_TPU_RESIDENT, m.M_CACHE_INVALIDATIONS),
            "evictions": reg.counter(m.SCOPE_TPU_RESIDENT, m.M_CACHE_EVICTIONS),
            "events_appended": reg.counter(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_EVENTS_APPENDED),
        }

    # -- slots --------------------------------------------------------------

    @contextmanager
    def batch(self):
        """One pool call: admits inside it record their writes, which
        launch together when the outermost call (across threads) ends or
        before anything reads a slab; slots freed meanwhile return to the
        free lists then."""
        with self._lock:
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._flush_writes_locked()
                    for slab, index in self._deferred:
                        slab.owner[index] = None
                        slab.free.append(index)
                    self._deferred.clear()

    def _alloc_locked(self, shard: int, layout: PayloadLayout) -> Slot:
        slab = self._slabs.get((shard, layout))
        if slab is None:
            slab = self._slabs[(shard, layout)] = _Slab(layout, self._slice_device(shard))
        if not slab.free:
            slab.grow()
        return Slot(slab, slab.free.pop())

    def _release_locked(self, entry: ResidentEntry) -> None:
        """Free an entry's slot and drop its recorded write (only rows still
        resident are written). While a call is in progress the slot stays
        the entry's until the outermost call ends: an escalation may still
        read the evicted entry's pre-append state."""
        slab, index = entry.slot
        if slab.owner[index] is not entry:
            return  # the slot moved on to a same-layout re-admit
        self._writes.pop((id(slab), index), None)
        if self._depth:
            self._deferred.append(entry.slot)
        else:
            slab.owner[index] = None
            slab.free.append(index)

    def _flush_writes_locked(self) -> None:
        """Launch every recorded write: one kernel G per (source batch,
        slab). A batch on another card comes over as one kernel-G gather
        on its own device and one copy per state tensor. Rows from the CPU
        into a slab on a card are stacked on the host, whatever their
        source, and copied once per state tensor."""
        if not self._writes:
            return
        groups: Dict[tuple, list] = {}
        for slab, index, src, row in self._writes.values():
            route = _write_route(src.state.device, slab.device)
            key = ("host", id(slab), layout_of(src)) if route == "host" else (
                route, id(slab), id(src))
            groups.setdefault(key, []).append((slab, index, src, row))
        self._writes.clear()
        for (route, _, _), rows in groups.items():
            slab, src = rows[0][0], rows[0][2]
            src_rows = [r for _, _, _, r in rows]
            if route == "host":
                src = map_state(lambda *ts: torch.cat(ts).to(slab.device),
                                *(map_state(lambda t, r=r: t[r:r + 1], s)
                                  for _, _, s, r in rows))
                src_rows = range(len(rows))
                self.host_rows += len(rows)
            elif route == "device":
                src = map_state(lambda t: t.to(slab.device),
                                rehome(src, src_rows, layout_of(src)))
                src_rows = range(len(rows))
            rehome(src, src_rows, slab.layout, slab.state, [i for _, i, _, _ in rows])

    def _drop_slabs_locked(self) -> None:
        self._slabs.clear()
        self._writes.clear()
        self._deferred.clear()

    def _gather_locked(self, entries: Sequence[ResidentEntry], pad_to: int = 0,
                       out_layout: Optional[PayloadLayout] = None) -> ReplayState:
        """The entries' states (one slab) as one batch, padded with init
        rows to `pad_to`: one kernel-G launch."""
        self._flush_writes_locked()
        slab = entries[0].slot.slab
        for e in entries:
            if e.slot.slab is not slab or slab.owner[e.slot.index] is not e:
                raise RuntimeError("resident entry is stale or not in the group's slab")
        rows = [e.slot.index for e in entries] + [-1] * max(0, pad_to - len(entries))
        return rehome(slab.state, rows, out_layout or slab.layout)

    def gather_current(self, entries: Sequence[ResidentEntry]
                       ) -> Tuple[Optional[ReplayState], List[int]]:
        """The states of the entries (one slab) that still hold their slots,
        as one batch, and their positions in `entries`. A concurrent call
        (the serving drain) may have re-admitted or evicted an entry since
        the caller looked it up; such an entry is left out, not an error.
        (None, []) when none is left."""
        with self._lock:
            kept = [i for i, e in enumerate(entries)
                    if e.slot.slab.owner[e.slot.index] is e]
            if not kept:
                return None, []
            return self._gather_locked([entries[i] for i in kept]), kept

    def state_of(self, entry: ResidentEntry) -> ReplayState:
        """The entry's W=1 state (a copy on its slab's device)."""
        with self._lock:
            return self._gather_locked([entry])

    def gather(self, entries: Sequence[ResidentEntry], pad_to: int = 0) -> ReplayState:
        """The states of entries that share a slab, as one batch padded with
        init rows to `pad_to` (one kernel-G launch)."""
        with self._lock:
            return self._gather_locked(entries, pad_to)

    # -- lookup / admit / invalidate ----------------------------------------

    def lookup(self, key: tuple, batches,
               authoritative: bool = True) -> Optional[Tuple[str, ResidentEntry]]:
        """("exact"|"suffix", entry) or None (miss).

        `batches` must be the key's CURRENT single-lineage history when
        `authoritative`: a stale entry is then invalidated on sight. With
        authoritative=False (batches may be a deliberate prefix of the
        stored history: a rebuild up to a reset point) the entry stays and
        the call just misses."""
        scope = self._scope()
        with self._lock:
            sl = self._slices[self.shard_of(key)]
            entry = sl.get(key)
            if entry is not None:
                sl.move_to_end(key)
        if entry is not None:
            relation = address_relation(entry.address, batches)
            if relation == "exact":
                scope.inc(m.M_CACHE_HITS)
                return ("exact", entry)
            if relation == "prefix":
                scope.inc(m.M_RESIDENT_SUFFIX_HITS)
                return ("suffix", entry)
            if authoritative:
                self.invalidate(key)
        scope.inc(m.M_CACHE_MISSES)
        return None

    def entry_for(self, key: tuple) -> Optional[ResidentEntry]:
        """The key's current entry, recency-refreshed, with no address
        validation and no hit/miss accounting (the serving tier's chain
        probe)."""
        with self._lock:
            sl = self._slices[self.shard_of(key)]
            entry = sl.get(key)
            if entry is not None:
                sl.move_to_end(key)
            return entry

    def invalidate(self, key: tuple) -> bool:
        """Drop an entry (counted)."""
        with self._lock:
            shard = self.shard_of(key)
            entry = self._slices[shard].pop(key, None)
            if entry is not None:
                self._slice_bytes[shard] -= entry.nbytes
                self._release_locked(entry)
            self._gauges_locked()
        if entry is not None:
            self._scope().inc(m.M_CACHE_INVALIDATIONS)
        return entry is not None

    def clear(self) -> None:
        """Drop every entry and free every slab."""
        with self._lock:
            for sl in self._slices:
                sl.clear()
            self._slice_bytes = [0] * len(self._slices)
            self._drop_slabs_locked()
            self._gauges_locked()

    def admit(self, key: tuple, address: ContentAddress, state_row,
              payload: np.ndarray, branch: int, rung: int = 0) -> bool:
        """Pin one workflow's W=1 state row (on any device); LRU-evicts past
        the owning slice's budget. Returns False when the row alone
        exceeds the slice budget (a budget of 0 disables residency)."""
        return self.admit_row(key, address, state_row, 0, payload, branch, rung)

    def admit_row(self, key: tuple, address: ContentAddress, state: ReplayState, row: int,
                  payload: np.ndarray, branch: int, rung: int = 0) -> bool:
        """Pin row `row` of a batched state. Inside one `batch()` the
        bookkeeping of many admits runs one after another, as separate
        admits would, and their writes launch together at its end."""
        with self.batch():
            return self._admit(key, address, state, row, payload, branch, rung)

    def _admit(self, key: tuple, address: ContentAddress, src: ReplayState, row: int,
               payload: np.ndarray, branch: int, rung: int = 0,
               layout: Optional[PayloadLayout] = None) -> bool:
        """Admit row `row` of `src` at `layout` (default: src's own); the
        write is recorded, and launches when the call ends."""
        layout = layout or layout_of(src)
        nbytes = self._row_nbytes(layout)
        if nbytes > self.slice_budget or nbytes > self.budget_bytes:
            return False
        evicted = 0
        with self._lock:
            shard = self.shard_of(key)
            sl = self._slices[shard]
            old = sl.pop(key, None)
            if old is not None:
                self._slice_bytes[shard] -= old.nbytes
            if (old is not None and old.slot.slab.layout == layout
                    and old.slot.slab.owner[old.slot.index] is old):
                slot = old.slot  # a same-layout re-admit writes back in place
            else:
                if old is not None:
                    self._release_locked(old)
                slot = self._alloc_locked(shard, layout)
            entry = ResidentEntry(slot=slot, payload=np.asarray(payload, dtype=np.int64),
                                  branch=int(branch), address=address, rung=int(rung),
                                  nbytes=nbytes)
            slot.slab.owner[slot.index] = entry
            self._writes[(id(slot.slab), slot.index)] = (slot.slab, slot.index, src, int(row))
            sl[key] = entry
            self._slice_bytes[shard] += nbytes
            while self._slice_bytes[shard] > self.slice_budget and len(sl) > 1:
                _, dropped = sl.popitem(last=False)
                self._slice_bytes[shard] -= dropped.nbytes
                self._release_locked(dropped)
                evicted += 1
            self._gauges_locked()
        if evicted:
            self.metrics.inc(m.SCOPE_TPU_RESIDENT, m.M_CACHE_EVICTIONS, evicted)
        return True

    # -- device helpers -----------------------------------------------------

    @staticmethod
    def extract_row(state: ReplayState, index: int) -> ReplayState:
        """W=1 copy of row `index` of a batched state (one kernel-G launch)."""
        return rehome(state, [int(index)], layout_of(state))

    # -- the append transaction ---------------------------------------------

    def replay_append(self, items: Sequence[Tuple[tuple, ResidentEntry, Sequence]],
                      encode_suffix: Optional[Callable] = None,
                      address_of: Callable = content_address) -> List[AppendResult]:
        """Replay ONLY the appended batches of each item against its
        resident state; items are (key, entry, full current batches) from
        suffix-hit lookups.

        Chunked through the bulk executor (suffix packing of chunk N+1
        overlaps the replay of chunk N); each chunk's corpus is sized by
        its longest SUFFIX. Entries sharing a rung and an owning shard
        batch together: one kernel-G gather from their slab, kernel A on
        the gathered batch, kernel B. On success the entry is re-pinned
        (same layout: in its own slot); capacity overflow escalates
        through the ladder from the PRE-append states; any other failure
        invalidates the entry and returns ok=False for oracle
        arbitration. `address_of` maps each item's third element to the
        post-append ContentAddress (the serving tier passes opaque tokens
        whose suffix rows its encode_suffix unwraps)."""
        return self.replay_append_report(items, encode_suffix, address_of)[0]

    def replay_append_report(self, items: Sequence[Tuple[tuple, ResidentEntry, Sequence]],
                             encode_suffix: Optional[Callable] = None,
                             address_of: Callable = content_address
                             ) -> Tuple[List[AppendResult], AppendReport]:
        """`replay_append` plus this call's AppendReport (also published as
        `last_append`)."""
        if encode_suffix is None:
            encode_suffix = _encode_suffix_cold
        results: List[Optional[AppendResult]] = [None] * len(items)
        report = AppendReport(transactions=len(items))
        self.last_append = report
        by_group: Dict[tuple, List[int]] = {}
        for i, (key, entry, _batches) in enumerate(items):
            by_group.setdefault((entry.rung, self.shard_of(key)), []).append(i)
        with self.batch():
            for (rung, shard), idxs in sorted(by_group.items()):
                self._append_group(items, idxs, rung, encode_suffix, results, report,
                                   address_of=address_of)
        return ([r if r is not None else AppendResult(ok=False) for r in results], report)

    def _append_group(self, items, idxs: List[int], rung: int, encode_suffix, results: List,
                      report: AppendReport, address_of: Callable = content_address) -> None:
        from ..ops.encode import assemble_corpus
        from ..ops.payload import payload_rows_narrow
        from ..ops.replay import replay_scan
        from ..ops.state import CAPACITY_ERRORS
        from ..parallel.mesh import on_device, _to_device
        from .executor import BulkReplayExecutor

        chunk = max(1, self.chunk_workflows)
        spans = [(lo, min(lo + chunk, len(idxs))) for lo in range(0, len(idxs), chunk)]
        device = items[idxs[0]][1].slot.slab.device
        executor = BulkReplayExecutor(depth=self.pipeline_depth, registry=self.metrics,
                                      scope=m.SCOPE_TPU_RESIDENT, device=device)
        scope = self._scope()

        def pack(ci):
            lo, hi = spans[ci]
            rows_list = []
            for i in idxs[lo:hi]:
                key, entry, batches = items[i]
                rows_list.append(encode_suffix(key, batches, entry.address.batch_count))
            E = _bucket(max((r.shape[0] for r in rows_list), default=1), 16)
            Wp = _bucket(len(rows_list), 8)
            corpus = assemble_corpus(rows_list, E)
            if corpus.shape[0] < Wp:
                pad = np.zeros((Wp - corpus.shape[0], E, NUM_LANES), dtype=np.int64)
                pad[:, :, 1] = -1  # LANE_EVENT_TYPE: no-op padding rows
                corpus = np.concatenate([corpus, pad])
            return corpus

        def launch(ci, corpus):
            lo, hi = spans[ci]
            with on_device(device):
                s0 = self.gather([items[i][1] for i in idxs[lo:hi]], pad_to=corpus.shape[0])
                report.chunk_shapes.append((corpus.shape[0], corpus.shape[1]))
                events = int((corpus[:, :, 0] > 0).sum())  # LANE_EVENT_ID
                report.events_appended += events
                scope.inc(m.M_RESIDENT_EVENTS_APPENDED, events)
                replay_scan(s0, _to_device(corpus, device))
                rows, ovf = payload_rows_narrow(s0, self.layout)
            return corpus, s0, rows, ovf

        def consume(ci, launched):
            corpus, s_fin, rows, ovf = launched
            return (corpus, s_fin, rows.cpu().numpy(), s_fin.error.cpu().numpy(),
                    ovf.cpu().numpy(), s_fin.current_branch.cpu().numpy())

        chunk_outs, _report = executor.run(len(spans), pack, launch, consume)

        for (lo, hi), (corpus, s_fin, rows, err, ovf, branch) in zip(spans, chunk_outs):
            group = idxs[lo:hi]
            flagged = [j for j in range(len(group))
                       if err[j] in CAPACITY_ERRORS or (err[j] == 0 and ovf[j])]
            narrow_mask = self._narrow_mask(s_fin, rung)
            for j, i in enumerate(group):
                if j in flagged:
                    continue
                key, entry, batches = items[i]
                if err[j] != 0:
                    self.invalidate(key)
                    results[i] = AppendResult(ok=False, error=int(err[j]))
                    continue
                results[i] = self._readmit(
                    key, address_of(batches), s_fin, j, rows[j], int(branch[j]), rung,
                    bool(narrow_mask[j]) if narrow_mask is not None else False)
            if flagged:
                self._escalate(items, [group[j] for j in flagged], corpus[flagged], rung,
                               results, report, address_of=address_of)

    def _narrow_mask(self, s_fin: ReplayState, rung: int):
        """[W] bool of rows that can re-narrow to base (kernel H), None at
        base."""
        if rung == 0:
            return None
        from ..ops.state import narrow_ok
        return narrow_ok(s_fin, self.layout).cpu().numpy()

    def _readmit(self, key, address: ContentAddress, s_fin: ReplayState, row: int, payload,
                 branch: int, rung: int, narrowable: bool) -> AppendResult:
        """Re-pin one successfully appended row (re-narrowed, by the same
        kernel-G write, when its load drained back under base capacities)."""
        layout = layout_of(s_fin)
        if rung > 0 and narrowable:
            layout = self.layout
            rung = 0
            self._scope().inc(m.M_RESIDENT_NARROWED)
        self._admit(key, address, s_fin, row, payload, branch, rung, layout=layout)
        return AppendResult(ok=True, payload=np.asarray(payload), branch=branch, rung=rung)

    def _escalate(self, items, flat_idxs: List[int], sub: np.ndarray, rung: int, results: List,
                  report: AppendReport, address_of: Callable = content_address) -> None:
        """Widened re-replay of capacity-flagged appends from their
        PRE-append states (their slots still hold them: a slot freed in
        this call is not reused before it ends)."""
        from ..ops.encode import gather_subcorpus

        if self.ladder is None:
            for i in flat_idxs:
                self.invalidate(items[i][0])
                results[i] = AppendResult(ok=False, error=-1)
            return
        scope = self._scope()
        scope.inc(m.M_RESIDENT_WIDENED, len(flat_idxs))
        report.escalated_rows += len(flat_idxs)
        pre_states = self.gather([items[i][1] for i in flat_idxs])
        trimmed = gather_subcorpus(sub, np.arange(sub.shape[0]))
        outcome, states_out = self.ladder.escalate_resident(trimmed, pre_states, base_rung=rung)
        #: (id of rung state, rung) -> narrow mask, once per distinct state
        masks: Dict[tuple, object] = {}
        for k, i in enumerate(flat_idxs):
            key, entry, batches = items[i]
            if not outcome.resolved[k]:
                from ..ops.state import ErrorCode
                # a zero ladder error here means the FINAL state exceeds the
                # base canonical payload (narrow overflow): report it as the
                # overflow it is, never as "no error"
                err = int(outcome.errors[k]) or ErrorCode.TABLE_OVERFLOW
                self.invalidate(key)
                results[i] = AppendResult(ok=False, error=err, escalated=True)
                continue
            s_fin, local, got_rung = states_out[k]
            mkey = (id(s_fin), got_rung)
            if mkey not in masks:
                masks[mkey] = self._narrow_mask(s_fin, got_rung)
            narrow_mask = masks[mkey]
            res = self._readmit(key, address_of(batches), s_fin, local, outcome.rows[k],
                                int(outcome.branch[k]), got_rung,
                                bool(narrow_mask[local]) if narrow_mask is not None else False)
            res.escalated = True
            results[i] = res


def _write_route(src: torch.device, slab: torch.device) -> str:
    """How a row on `src` reaches a slab on `slab`: "local" (one kernel G
    from the source batch), "device" (another card: gathered there, then
    copied) or "host" (the CPU into a card: stacked on the host)."""
    if src == slab:
        return "local"
    return "host" if src.type == "cpu" else "device"


def _encode_suffix_cold(key, batches, from_batch: int) -> np.ndarray:
    """Pack-cache-free suffix encoder (standalone consumers): a full
    resumable encode sliced at the prefix row count, byte-identical to
    the pack cache's suffix path."""
    from ..ops.encode import encode_batches_resumable

    rows, _ = encode_batches_resumable(batches)
    return rows[history_length(batches[:from_batch]):]

