"""Micro-batched device serving tier: live transactions feed the resident pool.

The JAX package's engine/serving.py ServingScheduler, under the same
names. After the oracle applies and persists a transaction (the oracle
stays the sole authority on legality), the transaction enqueues into a
coalescing queue keyed by workflow: a second transaction on the same
workflow before the first drains FOLDS into it (the latest expected state
wins, both tickets resolve from the one device pass). A drain thread
gathers pending transactions under an adaptive window
(CADENCE_TPU_SERVING_BATCH / CADENCE_TPU_SERVING_WAIT_US) and flushes:

- appends to resident workflows replay ONLY their new batches against
  the pinned states, grouped by owning mesh device inside the resident
  pool's replay_append (kernel G gathers the group from its slab, kernel
  A replays the suffix, kernel B projects the row), capacity overflow
  riding EscalationLadder.escalate_resident;
- cold workflows admit through one launch of kernel A then B per owning
  device (the JAX package's `_cold_fn` launch shape; nothing compiles per
  shape here, so there is no variant cache), their clean final states
  scattered into the pool by kernel G;
- parity is gated PER TRANSACTION: the device's canonical payload row
  must equal the oracle's committed row byte for byte, branch included;
  a divergence invalidates the entry, counts `parity-divergence` and
  resolves the ticket not-ok;
- the queue is BOUNDED (CADENCE_TPU_SERVING_QUEUE): past the bound
  `submit` raises utils/quotas.ServiceBusyError with a retry-after
  derived from the drain rate.

Observability: `tpu.serving` counters and the batch-size / queue-wait
histograms, the profiler's `serving` leg and `stats()`.
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.checksum import crc32_of_row
from ..utils import flightrecorder
from ..utils import metrics as m
from ..utils.profiler import ReplayProfiler
from ..utils.quotas import ServiceBusyError
from .cache import ContentAddress, batch_crc, content_address

#: max transactions drained into one flush window
BATCH_ENV = "CADENCE_TPU_SERVING_BATCH"
DEFAULT_BATCH = 64
#: max microseconds a flush window stays open waiting for more arrivals
#: (the window closes EARLY whenever arrivals stall — a lone transaction
#: never pays this in full)
WAIT_ENV = "CADENCE_TPU_SERVING_WAIT_US"
DEFAULT_WAIT_US = 2000
#: coalescing-queue bound (distinct pending workflows); past it submit
#: sheds with a typed ServiceBusyError instead of growing without limit
QUEUE_ENV = "CADENCE_TPU_SERVING_QUEUE"
DEFAULT_QUEUE = 4096
#: tier switch: 1 wires the scheduler into every history engine the
#: cluster creates (Onebox / ServiceHost); default off — the tier is an
#: explicit deployment choice, and the off configuration is the loadgen
#: comparison baseline
ENABLE_ENV = "CADENCE_TPU_SERVING"
#: boot warm-up: build the kernels and launch every flush shape once as a
#: host starts, so the first live drain pays neither (default on; 0 skips)
WARM_ENV = "CADENCE_TPU_SERVING_WARM"
#: csv of event-axis pow2 buckets the boot warm-up launches
WARM_EVENTS_ENV = "CADENCE_TPU_SERVING_WARM_EVENTS"
DEFAULT_WARM_EVENTS = (16, 32, 64, 128)

#: batch-size histogram buckets (transactions per flush)
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

#: times one item re-enters the queue when the store is mid-commit under
#: it (history tail moved but the execution row hasn't caught up)
MAX_REQUEUES = 3

#: live schedulers (conftest stops their drain threads between tests)
_LIVE: "weakref.WeakSet[ServingScheduler]" = weakref.WeakSet()


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "0") in ("1", "true", "on")


def warm_on_boot() -> bool:
    return os.environ.get(WARM_ENV, "1") not in ("0", "false", "off")


def warm_event_shapes() -> Tuple[int, ...]:
    raw = os.environ.get(WARM_EVENTS_ENV, "")
    if not raw:
        return DEFAULT_WARM_EVENTS
    try:
        shapes = tuple(int(s) for s in raw.split(",") if s.strip())
    except ValueError:
        return DEFAULT_WARM_EVENTS
    return shapes or DEFAULT_WARM_EVENTS


def reset_all() -> None:
    """Stop every live scheduler's drain thread and drop its queue (the
    conftest isolation seam, next to resident.reset_all)."""
    for s in list(_LIVE):
        s.stop()


def _bucket(n: int, floor: int) -> int:
    return max(floor, 1 << (max(1, int(n)) - 1).bit_length())


@dataclass
class ServingResult:
    """Outcome of one served transaction.

    `ok` means the device state was maintained AND its payload matched
    the oracle's committed row; `parity_ok` is False only on a genuine
    byte divergence (counted, entry invalidated). `checksum` is the
    CRC32 of the device-side canonical payload row — on a parity-clean
    transaction it equals the oracle row's checksum by construction."""

    ok: bool
    parity_ok: bool = True
    checksum: int = 0
    path: str = ""           # "exact" | "suffix" | "cold" | "bypass" | ""
    coalesced: bool = False
    escalated: bool = False
    error: str = ""
    queue_wait_s: float = 0.0


class ServingTicket:
    """Future-shaped handle for one submitted transaction; the engine's
    handoff is fire-and-forget, tests and sync callers block on it."""

    __slots__ = ("_event", "_result")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Optional[ServingResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServingResult:
        if not self._event.wait(timeout):
            raise TimeoutError("serving ticket not resolved in time")
        assert self._result is not None
        return self._result

    def _resolve(self, result: ServingResult) -> None:
        if self._event.is_set():
            return  # first resolution wins (a late error sweep must
            # never overwrite an already-delivered success)
        self._result = result
        self._event.set()


@dataclass
class _Pending:
    """One workflow's pending append: the LATEST committed transaction's
    expected state (earlier unflushed transactions for the same key
    coalesce into it — their events are a prefix of this one's batches,
    so the one device pass settles every folded ticket)."""

    key: tuple
    expected_row: np.ndarray
    expected_branch: int
    tail_crc: int
    enqueued: float
    tickets: List[ServingTicket] = field(default_factory=list)
    coalesced: int = 0
    requeues: int = 0
    #: set by _resolve: the drain's error sweep skips items already
    #: served (their entries are parity-clean — a later item's failure
    #: must not invalidate them or overwrite their tickets)
    resolved: bool = False
    #: the committed HistoryBatch objects, in commit order (folds
    #: append) — the zero-read chain: when the resident entry's address
    #: tail equals `prev_crc`, these batches ARE the suffix and the
    #: flush touches neither the history store nor the serializer.
    #: None when any fold arrived without its batch (chain unknown).
    batches: Optional[List[object]] = None
    #: CRC32 of the batch immediately BEFORE batches[0] (the scheduler's
    #: per-key ledger records each submit's tail as the next one's prev)
    prev_crc: Optional[int] = None


class ServingScheduler:
    """Micro-batching transaction scheduler over the resident tier.

    Constructed from a `TPUReplayEngine` (shares its resident cache,
    pack cache, ladder, mesh, layout, and metrics registry); the drain
    thread starts lazily on the first submit and parks on a condition
    when idle. `read_batches` / `read_live_row` are injection seams for
    bench/tests (default: the engine's stores)."""

    def __init__(self, tpu, max_batch: Optional[int] = None,
                 max_wait_us: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 registry=None,
                 read_batches: Optional[Callable] = None,
                 read_live_row: Optional[Callable] = None) -> None:
        self.tpu = tpu
        # the engine's mesh wires the pool's shard slices before the first
        # lookup (a flush groups and launches by owning device)
        tpu.mesh
        self.layout = tpu.layout
        self.resident = tpu.resident
        self.pack_cache = tpu.pack_cache
        self.metrics = registry if registry is not None else tpu.metrics
        self.max_batch = (max_batch if max_batch is not None
                          else int(os.environ.get(BATCH_ENV,
                                                  str(DEFAULT_BATCH))))
        self.max_wait_us = (max_wait_us if max_wait_us is not None
                            else int(os.environ.get(WAIT_ENV,
                                                    str(DEFAULT_WAIT_US))))
        self.max_queue = (max_queue if max_queue is not None
                          else int(os.environ.get(QUEUE_ENV,
                                                  str(DEFAULT_QUEUE))))
        #: injected read seams (bench/tests) disable the batch-range
        #: fast path below — a custom reader owns its own store model
        self._injected_reads = read_batches is not None
        self._read_batches = read_batches or self._store_batches
        self._read_live_row = read_live_row or self._store_live_row
        self._cv = threading.Condition()
        self._pending: "OrderedDict[tuple, _Pending]" = OrderedDict()
        #: per-key tail-CRC ledger: submit N's tail becomes submit N+1's
        #: prev, closing the committed-batch chain the flush fast path
        #: validates against the resident entry (bounded: cleared past
        #: the cap — a cleared key just falls back to the store read)
        self._ledger: Dict[tuple, int] = {}
        #: batches popped from the queue but not yet fully flushed (the
        #: drain() seam: "queue empty" alone races an in-flight flush)
        self._inflight = 0
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        #: EWMA of flush wall seconds — the retry-after estimate a shed
        #: submit carries (how long until the drain frees queue room)
        self._flush_ewma_s = 0.0
        #: the replay profiler's `serving` leg rides the replay-engine
        #: scope so `admin profile` shows it next to pack/kernel
        self._prof = ReplayProfiler(self.metrics, scope=m.SCOPE_TPU_REPLAY)
        _LIVE.add(self)

    # -- registry plumbing --------------------------------------------------

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, registry) -> None:
        self._metrics = registry
        if hasattr(self, "_prof"):
            self._prof.registry = registry

    def _scope(self):
        return self.metrics.scope(m.SCOPE_TPU_SERVING)

    # -- store seams --------------------------------------------------------

    def _store_batches(self, key: tuple):
        hs = self.tpu.stores.history
        if hs.branch_count(*key) > 1 or hs.get_current_branch(*key) != 0:
            return None  # multi-branch (NDC conflict shape): bypass
        return hs.as_history_batches(*key)

    def _store_live_row(self, key: tuple):
        """(payload row, branch) of the authoritative mutable state —
        the tail-moved fallback (a foreign transaction committed after
        the one that enqueued this item)."""
        from ..core.checksum import STICKY_ROW_INDEX, payload_row

        ms = self.tpu.stores.execution.get_workflow(*key)
        row = payload_row(ms, self.layout)
        row[STICKY_ROW_INDEX] = 0
        return row, int(ms.version_histories.current_index), \
            int(ms.execution_info.next_event_id)

    # -- submit -------------------------------------------------------------

    def submit(self, key: tuple, expected_row: np.ndarray,
               expected_branch: int, tail_crc: int,
               batch=None) -> ServingTicket:
        """Enqueue one COMMITTED transaction's post-state for device
        maintenance. `expected_row` is the oracle's canonical payload row
        (sticky already masked), `tail_crc` the CRC32 of the committed
        batch's serialized bytes — the content-address tail that lets the
        drain prove the store still ends at this transaction. `batch` is
        the committed HistoryBatch itself: with it, a chained append
        flushes with ZERO store reads (the handed batches are the
        suffix); without it the drain falls back to re-reading the
        history.

        Raises `ServiceBusyError` (typed, retry-after attached) when the
        coalescing queue is at its bound — backpressure, not failure:
        the oracle state is already durable; only the device twin lags."""
        ticket = ServingTicket()
        row = np.asarray(expected_row, dtype=np.int64)
        scope = self._scope()
        with self._cv:
            prev = self._ledger.get(key)
            if len(self._ledger) > 65536:
                self._ledger.clear()  # bounded; cleared keys re-read once
            self._ledger[key] = int(tail_crc)
            item = self._pending.get(key)
            if item is not None:
                # same workflow already pending: FOLD — this transaction's
                # batches strictly extend the pending one's, so replaying
                # to the newest committed state settles both tickets
                item.expected_row = row
                item.expected_branch = int(expected_branch)
                item.tail_crc = int(tail_crc)
                item.tickets.append(ticket)
                item.coalesced += 1
                if item.batches is not None and batch is not None:
                    item.batches.append(batch)
                else:
                    item.batches = None  # chain broken: store-read path
                scope.inc(m.M_SERVING_COALESCED)
            else:
                if len(self._pending) >= self.max_queue:
                    scope.inc(m.M_SERVING_REJECTED)
                    raise ServiceBusyError(
                        "serving queue full", domain="tpu.serving",
                        retry_after_s=max(self._flush_ewma_s, 0.001))
                self._pending[key] = _Pending(
                    key=key, expected_row=row,
                    expected_branch=int(expected_branch),
                    tail_crc=int(tail_crc), enqueued=time.perf_counter(),
                    tickets=[ticket],
                    batches=[batch] if batch is not None else None,
                    prev_crc=prev)
            scope.inc(m.M_SERVING_TXNS)
            scope.gauge(m.M_SERVING_QUEUE_DEPTH, float(len(self._pending)))
            self._ensure_thread()
            self._cv.notify_all()
        return ticket

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop_flag = False
            self._thread = threading.Thread(target=self._drain_loop,
                                            daemon=True,
                                            name="cadence-serving-drain")
            self._thread.start()

    def stop(self) -> None:
        """Stop the drain thread and resolve every queued ticket not-ok
        (shutdown, test isolation). Restartable: the next submit spins a
        fresh drain thread."""
        with self._cv:
            self._stop_flag = True
            pending = list(self._pending.values())
            self._pending.clear()
            self._cv.notify_all()
        for item in pending:
            for t in item.tickets:
                t._resolve(ServingResult(ok=False, error="stopped"))
        thread = self._thread
        if thread is not None and thread.is_alive() \
                and thread is not threading.current_thread():
            thread.join(timeout=5)
        self._thread = None

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty AND no flush is in flight (the
        settle seam for tests / the loadgen comparison — the tier is
        async by design). True when drained inside `timeout`."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._cv:
                if not self._pending and not self._inflight:
                    return True
            time.sleep(0.01)
        return False

    # -- the adaptive drain window ------------------------------------------

    def _gather(self) -> Optional[List[_Pending]]:
        """Block until work exists, hold the window open while the queue
        is still filling (up to max_wait_us / max_batch), then pop one
        flush batch FIFO. Returns None on stop."""
        with self._cv:
            while not self._stop_flag and not self._pending:
                self._cv.wait(timeout=0.1)
            if self._stop_flag:
                return None
        # adaptive window: poll in quarter-wait slices; close as soon as
        # arrivals stall (low depth never pays the full wait) or the
        # batch fills
        deadline = time.perf_counter() + self.max_wait_us / 1e6
        last_depth = -1
        while time.perf_counter() < deadline:
            with self._cv:
                depth = len(self._pending)
            if depth >= self.max_batch or depth == last_depth:
                break
            last_depth = depth
            time.sleep(max(self.max_wait_us / 4e6, 1e-5))
        with self._cv:
            batch: List[_Pending] = []
            while self._pending and len(batch) < self.max_batch:
                _, item = self._pending.popitem(last=False)
                batch.append(item)
            if batch:
                self._inflight += 1
            self._scope().gauge(m.M_SERVING_QUEUE_DEPTH,
                                float(len(self._pending)))
        return batch or None

    def _drain_loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                if self._stop_flag:
                    return
                continue
            try:
                with self._prof.leg(m.M_PROFILE_SERVING):
                    self._flush(batch)
            except Exception as exc:  # never kill the drain on one batch
                for item in batch:
                    if item.resolved:
                        # served before the failure: its entry is
                        # parity-clean and its tickets delivered — only
                        # the still-unserved items fail
                        continue
                    self.resident.invalidate(item.key)
                    self._resolve(item, ServingResult(
                        ok=False, error=f"{type(exc).__name__}: {exc}"))
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _requeue(self, item: _Pending) -> None:
        """Put one unstable item back (the store was mid-commit under
        it); a newer submit for the same key absorbs it."""
        self._scope().inc(m.M_SERVING_REQUEUED)
        item.requeues += 1
        with self._cv:
            newer = self._pending.get(item.key)
            if newer is not None:
                newer.tickets.extend(item.tickets)
                newer.coalesced += item.coalesced + 1
            else:
                self._pending[item.key] = item
                self._pending.move_to_end(item.key, last=False)
            self._cv.notify_all()

    def _resolve(self, item: _Pending, result: ServingResult) -> None:
        item.resolved = True
        result.coalesced = item.coalesced > 0
        result.queue_wait_s = time.perf_counter() - item.enqueued
        for t in item.tickets:
            t._resolve(result)

    # -- the flush ----------------------------------------------------------

    def _flush(self, batch: List[_Pending]) -> None:
        t_flush = time.perf_counter()
        self.metrics.observe(m.SCOPE_TPU_SERVING, m.M_SERVING_BATCH_SIZE,
                             float(sum(1 + i.coalesced for i in batch)),
                             buckets=BATCH_BUCKETS)
        for item in batch:
            self.metrics.observe(m.SCOPE_TPU_SERVING, m.M_SERVING_QUEUE_WAIT,
                                 t_flush - item.enqueued)

        suffix: List[Tuple[tuple, object, tuple]] = []
        suffix_items: List[_Pending] = []
        cold: List[Tuple[_Pending, list]] = []
        for item in batch:
            # zero-read chain path: the engine handed the committed
            # batches and the resident entry's tail is exactly this
            # chain's prev — the handed batches ARE the suffix, so the
            # flush touches neither the history store nor the serializer
            if item.batches is not None and item.prev_crc is not None:
                entry = self.resident.entry_for(item.key)
                if entry is not None and \
                        entry.address.last_batch_crc == item.prev_crc:
                    new_addr = ContentAddress(
                        entry.address.batch_count + len(item.batches),
                        item.tail_crc)
                    rows = self.pack_cache.encode_append(
                        item.key, entry.address, item.batches, new_addr)
                    if rows is not None:
                        suffix.append((item.key, entry, (rows, new_addr)))
                        suffix_items.append(item)
                        continue
            if self._injected_reads:
                self._route_full_read(item, suffix, suffix_items, cold)
            else:
                self._route_ranged(item, suffix, suffix_items, cold)

        if suffix:
            self._flush_suffix(suffix, suffix_items)
        if cold:
            self._flush_cold(cold)

        dt = time.perf_counter() - t_flush
        self._flush_ewma_s = (0.7 * self._flush_ewma_s + 0.3 * dt
                              if self._flush_ewma_s else dt)
        flightrecorder.emit(
            "serving-drain", txns=len(batch),
            coalesced=sum(i.coalesced for i in batch),
            suffix=len(suffix_items), cold=len(cold),
            flush_s=round(dt, 6), queue_depth=len(self._pending))

    def _route_full_read(self, item: _Pending, suffix, suffix_items,
                         cold) -> None:
        """The full-read store arbitration (injected-seam clusters and
        the genuine-cold fallback): read the whole history, tail-check,
        and partition by resident relation."""
        scope = self._scope()
        try:
            batches = self._read_batches(item.key)
        except Exception as exc:
            self._resolve(item, ServingResult(
                ok=False, error=f"read: {type(exc).__name__}"))
            return
        if batches is None or not batches:
            # multi-branch tree (NDC branch switch) or vanished run:
            # the resident tier never serves across those — drop any
            # pinned state and leave the device twin to the full
            # verify path
            self.resident.invalidate(item.key)
            scope.inc(m.M_SERVING_BYPASSED)
            self._resolve(item, ServingResult(ok=False, path="bypass",
                                              error="multi-branch"))
            return
        if batch_crc(batches[-1]) != item.tail_crc:
            # the store tail moved past the enqueued transaction: a
            # newer commit landed between submit and drain. Re-read
            # the live row; if history and execution row disagree
            # (mid-commit window) requeue instead of comparing torn
            # state against the device
            if not self._restabilize(item, batches[-1].events[-1].id):
                return
        hit = self.resident.lookup(item.key, batches)
        if hit is None:
            cold.append((item, batches))
        elif hit[0] == "exact":
            self._serve_exact(item, hit[1])
        else:
            entry = hit[1]
            rows = self.pack_cache.encode_suffix(
                item.key, batches, entry.address.batch_count)
            suffix.append((item.key, entry,
                           (rows, content_address(batches))))
            suffix_items.append(item)

    def _restabilize(self, item: _Pending, last_event_id: int) -> bool:
        """Tail-moved arbitration shared by both read paths: re-read the
        live execution row and retarget the item at it; requeue (or
        bypass past the budget) when history and execution row disagree
        — a mid-commit window whose torn state must never be compared
        against the device. True = item retargeted, keep flushing it."""
        scope = self._scope()
        try:
            row, br, next_id = self._read_live_row(item.key)
        except Exception as exc:
            self._resolve(item, ServingResult(
                ok=False, error=f"read: {type(exc).__name__}"))
            return False
        if last_event_id + 1 != next_id:
            if item.requeues < MAX_REQUEUES:
                self._requeue(item)
                return False
            # history and execution row still disagree after the
            # requeue budget (a permanent orphan tail from a
            # mid-commit crash): comparing torn state against
            # the device would count a PHANTOM divergence on the
            # gated counter — bypass instead, never serve
            self.resident.invalidate(item.key)
            scope.inc(m.M_SERVING_BYPASSED)
            self._resolve(item, ServingResult(
                ok=False, path="bypass", error="unstable-store"))
            return False
        item.expected_row = np.asarray(row, dtype=np.int64)
        item.expected_branch = br
        return True

    def _route_ranged(self, item: _Pending, suffix, suffix_items,
                      cold) -> None:
        """The chain-break / cold-admit fallback, O(suffix): instead of
        re-reading the full history, probe the batch COUNT, pick the
        best persisted candidate — the resident entry, else a persisted
        snapshot (engine/snapshot.py) — and fetch only batches from the
        candidate's boundary on (HistoryStore.read_batches_range). The
        boundary batch's CRC proves the candidate still prefixes the
        stored bytes; the fetched tail proves transaction stability.
        Only a key with NO valid candidate pays a full read."""
        from . import snapshot as snapshot_mod

        scope = self._scope()
        hs = self.tpu.stores.history
        key = item.key
        try:
            if hs.branch_count(*key) > 1 \
                    or hs.get_current_branch(*key) != 0:
                total = 0  # multi-branch: bypass below
            else:
                total = hs.batch_count(*key)
        except Exception as exc:
            self._resolve(item, ServingResult(
                ok=False, error=f"read: {type(exc).__name__}"))
            return
        if total == 0:
            self.resident.invalidate(key)
            scope.inc(m.M_SERVING_BYPASSED)
            self._resolve(item, ServingResult(ok=False, path="bypass",
                                              error="multi-branch"))
            return
        entry = self.resident.entry_for(key)
        snap = None
        if entry is None and snapshot_mod.enabled():
            snaps = getattr(self.tpu.stores, "snapshot", None)
            rec = snaps.get(key) if snaps is not None else None
            if rec is not None and 0 < rec.batch_count <= total \
                    and snapshot_mod.validate_record(rec, self.layout,
                                                     self.metrics):
                snap = rec
        addr = (entry.address if entry is not None
                else snap.address if snap is not None else None)
        part = None
        if addr is not None and 0 < addr.batch_count <= total:
            try:
                part = hs.as_history_batches_range(
                    *key, from_batch=addr.batch_count - 1)
            except Exception:
                part = None
            if not part or batch_crc(part[0]) != addr.last_batch_crc:
                # candidate no longer prefixes the stored bytes (tail
                # overwrite / reset rewrite): drop it, never serve
                if entry is not None:
                    self.resident.invalidate(key)
                if snap is not None:
                    self.metrics.inc(m.SCOPE_TPU_SNAPSHOT,
                                     m.M_SNAP_IGNORED_STALE)
                addr, part, entry, snap = None, None, None, None
        if addr is None:
            self._route_full_read(item, suffix, suffix_items, cold)
            return
        tail_crc_now = batch_crc(part[-1])
        if tail_crc_now != item.tail_crc:
            if not self._restabilize(item, part[-1].events[-1].id):
                return
        if snap is not None:
            # the snapshot proved valid against stored bytes: hydrate it
            # into the resident pool + seed the pack interner now
            if not snapshot_mod.seed_caches(snap, self.resident,
                                            self.pack_cache, self.layout,
                                            self.metrics):
                self._route_full_read(item, suffix, suffix_items, cold)
                return
            entry = self.resident.entry_for(key)
            if entry is None:
                self._route_full_read(item, suffix, suffix_items, cold)
                return
        if addr.batch_count == total:
            self._serve_exact(item, entry)
            return
        new_addr = ContentAddress(total, tail_crc_now)
        rows = self.pack_cache.encode_append(key, addr, part[1:],
                                             new_addr)
        if rows is None:
            # pack entry evicted out from under the resident state: one
            # full pack re-anchors it, then the suffix path proceeds
            self._route_full_read(item, suffix, suffix_items, cold)
            return
        suffix.append((key, entry, (rows, new_addr)))
        suffix_items.append(item)

    def _maybe_snapshot(self, keys_events) -> None:
        """Post-flush snapshot policy hook: feed the appended-events
        counters and write checksum-gated records for due keys
        (engine/snapshot.Snapshotter) — serving traffic keeps the
        durable snapshots fresh, so a later restart or chain break
        hydrates instead of replaying. Runs AFTER every ticket in the
        flush group resolved: a due key's write (device readback + WAL
        append) must never sit between co-batched callers and their
        results."""
        from . import snapshot as snapshot_mod

        if not keys_events or self._injected_reads \
                or not snapshot_mod.enabled():
            return
        snapper = self.tpu.snapshotter()
        for key, appended_events in keys_events:
            snapper.note_append(key, appended_events)
            snapper.maybe_snapshot(key)

    def _parity(self, item: _Pending, payload: np.ndarray,
                branch: int) -> Tuple[bool, int]:
        payload = np.asarray(payload, dtype=np.int64)
        ok = bool((payload == item.expected_row).all()
                  and int(branch) == item.expected_branch)
        if not ok:
            # never serve wrong state: the entry is dropped and counted;
            # the oracle's committed row remains the only truth
            self.resident.invalidate(item.key)
            self._scope().inc(m.M_SERVING_DIVERGENCE)
        return ok, int(crc32_of_row(payload))

    def _serve_exact(self, item: _Pending, entry) -> None:
        """The resident state already covers the committed batches (a
        coalesced fold or a verify pass got there first): zero device
        work, parity against the cached payload."""
        self._scope().inc(m.M_SERVING_EXACT)
        parity_ok, crc = self._parity(item, entry.payload, entry.branch)
        self._resolve(item, ServingResult(ok=parity_ok, parity_ok=parity_ok,
                                          checksum=crc, path="exact"))

    def _flush_suffix(self, suffix, items: List[_Pending]) -> None:
        """Replay ONLY the appended batches of each pending workflow
        against its resident state — grouped by (rung, owning shard)
        inside `ResidentStateCache.replay_append`, so the flush is one
        from-state launch per device group, capacity overflow riding
        `EscalationLadder.escalate_resident`. Items arrive as
        (key, entry, (suffix rows, post-append address)) tokens — the
        rows were encoded either from the handed committed batches (the
        zero-read chain) or from the pack cache's store-read path."""
        scope = self._scope()
        results, report = self.resident.replay_append_report(
            suffix,
            encode_suffix=lambda _key, token, _from: token[0],
            address_of=lambda token: token[1])
        scope.inc(m.M_SERVING_SUFFIX, len(items))
        scope.inc(m.M_SERVING_LAUNCHES, len(report.chunk_shapes))
        snapshot_due = []
        for (key, _entry, token), item, res in zip(suffix, items, results):
            if not res.ok:
                # entry already invalidated by replay_append; the oracle
                # stays authoritative and the next transaction cold-admits
                self._resolve(item, ServingResult(
                    ok=False, path="suffix", escalated=res.escalated,
                    error=f"device-error:{res.error}"))
                continue
            parity_ok, crc = self._parity(item, res.payload, res.branch)
            self._resolve(item, ServingResult(
                ok=parity_ok, parity_ok=parity_ok, checksum=crc,
                path="suffix", escalated=res.escalated))
            if parity_ok:
                snapshot_due.append((key, int(token[0].shape[0])))
        self._maybe_snapshot(snapshot_due)

    def _cold_launch(self, corpus: np.ndarray, device):
        """The cold admit's launch shape on the owning device: kernel A over
        the full histories, then kernel B; returns (state, payload rows)."""
        from ..ops.payload import payload_rows
        from ..ops.replay import replay_events
        from ..parallel.mesh import _to_device, on_device

        with on_device(device):
            state = replay_events(_to_device(corpus, device), self.layout, device)
            return state, payload_rows(state, self.layout)

    def _flush_cold(self, cold: List[Tuple[_Pending, list]]) -> None:
        """Cold workflows admit through the cold path's launch: full
        histories pack through the pack cache, one launch per owning
        device, the clean final states pinned into the pool (one kernel-G
        scatter per group, for the rows still resident once parity has
        settled each). Capacity-flagged rows get their parity settled
        through the ladder; they stay un-pinned."""
        from ..ops.encode import NUM_LANES, assemble_corpus, gather_subcorpus
        from ..ops.state import CAPACITY_ERRORS

        scope = self._scope()
        snapshot_due: List[Tuple[tuple, int]] = []
        groups: Dict[int, List[Tuple[_Pending, list]]] = {}
        for item, batches in cold:
            groups.setdefault(self.resident.shard_of(item.key), []).append((item, batches))
        for shard, grp in sorted(groups.items()):
            rows_list = [self.pack_cache.encode(item.key, batches) for item, batches in grp]
            E = _bucket(max((r.shape[0] for r in rows_list), default=1), 16)
            Wp = _bucket(len(grp), 8)
            corpus = assemble_corpus(rows_list, E)
            if corpus.shape[0] < Wp:
                pad = np.zeros((Wp - corpus.shape[0], E, NUM_LANES), dtype=np.int64)
                pad[:, :, 1] = -1  # LANE_EVENT_TYPE: no-op padding rows
                corpus = np.concatenate([corpus, pad])
            state, rows_dev = self._cold_launch(corpus, self.tpu.mesh.devices[shard])
            scope.inc(m.M_SERVING_LAUNCHES)
            rows = rows_dev.cpu().numpy()
            errors = state.error.cpu().numpy()
            branch = state.current_branch.cpu().numpy()

            flagged = [j for j in range(len(grp)) if errors[j] in CAPACITY_ERRORS]
            ladder_rows: Dict[int, Tuple[np.ndarray, int]] = {}
            if flagged and self.tpu.ladder is not None:
                outcome = self.tpu.ladder.escalate(gather_subcorpus(corpus, np.asarray(flagged)))
                for k, j in enumerate(flagged):
                    if outcome.resolved[k]:
                        ladder_rows[j] = (outcome.rows[k], int(outcome.branch[k]))

            with self.resident.batch():
                for j, (item, batches) in enumerate(grp):
                    if errors[j] != 0 and j not in ladder_rows:
                        self._resolve(item, ServingResult(
                            ok=False, path="cold", error=f"device-error:{int(errors[j])}"))
                        continue
                    if j in ladder_rows:
                        row_j, br_j = ladder_rows[j]
                        parity_ok, crc = self._parity(item, row_j, br_j)
                        self._resolve(item, ServingResult(
                            ok=parity_ok, parity_ok=parity_ok, checksum=crc, path="cold",
                            escalated=True))
                        continue
                    self.resident.admit_row(item.key, content_address(batches), state, j,
                                            rows[j], int(branch[j]))
                    scope.inc(m.M_SERVING_COLD)
                    parity_ok, crc = self._parity(item, rows[j], int(branch[j]))
                    self._resolve(item, ServingResult(
                        ok=parity_ok, parity_ok=parity_ok, checksum=crc, path="cold"))
                    if parity_ok:
                        # a freshly admitted cold state is the cheapest moment
                        # to persist: no snapshot exists yet
                        snapshot_due.append((item.key, 0))
        self._maybe_snapshot(snapshot_due)

    def warm(self, e_shapes: Sequence[int] = (16, 32, 64, 128),
             width: Optional[int] = None) -> int:
        """Build the kernel library and launch, on every mesh device, each
        shape a drain can meet once: every pow2 event bucket in `e_shapes`
        at every pow2 flush width up to `max_batch` (or `width`), through
        the append (kernel G gather, A, B) and the cold admit (A, B). Nothing
        compiles per shape, but the first flush then pays no library build
        and no allocator growth. Returns the number of (width, events)
        shapes warmed, as the JAX package counts them."""
        from ..ops.encode import NUM_LANES
        from ..ops.payload import payload_rows_narrow
        from ..ops.rehome import rehome
        from ..ops.replay import replay_scan
        from ..ops.state import init_state
        from ..parallel.mesh import _to_device, on_device

        top = _bucket(width if width is not None else self.max_batch, 8)
        widths = [w for w in (8, 16, 32, 64, 128) if w <= top] or [top]
        devices = list(dict.fromkeys(self.tpu.mesh.devices))
        warmed = 0
        for Wp in widths:
            for E in e_shapes:
                corpus = np.zeros((Wp, int(E), NUM_LANES), dtype=np.int64)
                corpus[:, :, 1] = -1  # LANE_EVENT_TYPE: no-op padding
                for dev in devices:
                    with on_device(dev):
                        s0 = rehome(init_state(Wp, self.layout, dev), range(Wp), self.layout)
                        replay_scan(s0, _to_device(corpus, dev))
                        payload_rows_narrow(s0, self.layout)[0].cpu()
                    self._cold_launch(corpus, dev)[1].cpu()
                warmed += 1
        return warmed

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """The `admin serving` rollup: knobs, queue, coalescing factor,
        path mix, parity status."""
        reg = self.metrics
        txns = reg.counter(m.SCOPE_TPU_SERVING, m.M_SERVING_TXNS)
        launches = reg.counter(m.SCOPE_TPU_SERVING, m.M_SERVING_LAUNCHES)
        wait = reg.histogram(m.SCOPE_TPU_SERVING, m.M_SERVING_QUEUE_WAIT)
        size = reg.histogram(m.SCOPE_TPU_SERVING, m.M_SERVING_BATCH_SIZE)
        return {
            "enabled": enabled(),
            "max_batch": self.max_batch,
            "max_wait_us": self.max_wait_us,
            "max_queue": self.max_queue,
            "queue_depth": self.queue_depth,
            "transactions": txns,
            "batched_launches": launches,
            "coalesced_appends": reg.counter(m.SCOPE_TPU_SERVING,
                                             m.M_SERVING_COALESCED),
            "coalescing_factor": round(txns / launches, 4) if launches
            else 0.0,
            "exact_serves": reg.counter(m.SCOPE_TPU_SERVING,
                                        m.M_SERVING_EXACT),
            "suffix_appends": reg.counter(m.SCOPE_TPU_SERVING,
                                          m.M_SERVING_SUFFIX),
            "cold_admits": reg.counter(m.SCOPE_TPU_SERVING,
                                       m.M_SERVING_COLD),
            "bypassed": reg.counter(m.SCOPE_TPU_SERVING,
                                    m.M_SERVING_BYPASSED),
            "requeued": reg.counter(m.SCOPE_TPU_SERVING,
                                    m.M_SERVING_REQUEUED),
            "busy_rejections": reg.counter(m.SCOPE_TPU_SERVING,
                                           m.M_SERVING_REJECTED),
            "parity_divergence": reg.counter(m.SCOPE_TPU_SERVING,
                                             m.M_SERVING_DIVERGENCE),
            "batch_size_p50": round(size.percentile(0.5), 2),
            "batch_size_p99": round(size.percentile(0.99), 2),
            "queue_wait_p50_ms": round(wait.percentile(0.5) * 1e3, 3),
            "queue_wait_p99_ms": round(wait.percentile(0.99) * 1e3, 3),
        }
