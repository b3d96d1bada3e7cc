"""Live HBM state migration: shard movement carries resident state along.

Cadence scales horizontally by spreading history shards across hosts via
the hashring + shard controller (service/history/shard/controller.go
acquireShards:381); the device tier gives each host a card-resident
mutable-state pool, a micro-batching serving scheduler, and a durable
snapshot twin — all single-host. This module is the cluster glue: when
the ring moves a shard between hosts, the resident state MOVES WITH IT
instead of being rebuilt by a cold replay storm on the new owner.

Two directions, both driven by the shard controller's membership hooks:

- OUT (planned rebalance / graceful drain): when the ring releases
  shards from this host, `shards_released` sweeps the resident pool for
  rows living in the moving shards and persists each as a checksum-gated
  `SnapshotRecord` (engine/snapshot.py — state blob + canonical payload
  + content address + interner) through the SHARED snapshot store, so
  the record is visible to every peer. The local entries are then
  dropped — a host must not keep serving state for shards it no longer
  owns. `drain_host` runs the same sweep eagerly over every owned shard:
  the operator's pre-kill verb that makes a planned host death a warm
  failover by construction.

- IN (steal / rebalance / restart): when the ring assigns shards to
  this host, `shards_acquired` queues them for a background hydration
  pass: every OPEN workflow in the acquired shards with a valid
  snapshot hydrates through the one shared primitive
  (`snapshot.seed_caches` → resident pool + pack-cache interner), the
  appended suffix since the snapshot point replays in ONE batched
  from-state pass (`ResidentStateCache.replay_append_report` — the same
  grouped launch the serving flush uses: kernel G gathers each group
  from its slab, kernel A replays the suffix from the carried state,
  kernel B reduces it with its fit epilogue), and the result is
  parity-checked against the oracle's live mutable state whenever the
  store is stable under it. A key with no usable record counts as a
  cold steal and is left for the serving tier's cold-admit path; a
  record whose address no longer prefixes the stored bytes (tail
  overwrite between snapshot and steal) is counted stale and ignored —
  a wrong state is never pinned.

On host DEATH there is no out-migration — the serving tier's
post-append snapshot policy is what keeps the shared store fresh enough
that the survivors' in-migration still hydrates instead of
cold-replaying.

Counters land under `tpu.migration/*` (utils/metrics.MIGRATION_COUNTERS,
pre-registered by `preregister_migration`).
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.checksum import STICKY_ROW_INDEX, payload_row
from ..core.enums import WorkflowState
from ..utils import flightrecorder
from ..utils import metrics as m
from . import snapshot as snapshot_mod
from .cache import ContentAddress, batch_crc
from .membership import shard_id_for_workflow

#: kill switch: CADENCE_TPU_MIGRATION=0 disables both directions (shard
#: movement falls back to cold replay on the new owner — the
#: pre-cluster behavior, kept as the parity-audit configuration)
ENABLE_ENV = "CADENCE_TPU_MIGRATION"

#: a record-less key with at most this many history batches counts as a
#: YOUNG steal, not a cold one: a 1-2 batch history (a start committed
#: moments before the steal) replays in microseconds — the snapshot
#: policy's own min_events floor deems it not worth a record, so the
#: warm-failover ratio must not charge the migration tier for it
YOUNG_BATCHES = 2


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "1") not in ("0", "false", "off")


def resident_row_checksums(resident) -> Dict[tuple, tuple]:
    """{key: (payload CRC32, branch, (batch count, last-batch CRC))}
    for every pinned resident row — the byte-parity probe the
    planned-rebalance gate compares losing-host → gaining-host →
    oracle. ONE implementation for every admin surface, so the probe can
    never drift."""
    from ..core.checksum import crc32_of_row

    rows: Dict[tuple, tuple] = {}
    for key in resident.keys():
        entry = resident.entry_for(key)
        if entry is None:
            continue
        rows[key] = (int(crc32_of_row(entry.payload)), int(entry.branch),
                     (int(entry.address.batch_count),
                      int(entry.address.last_batch_crc)))
    return rows


@dataclass
class OutReport:
    """One out-migration sweep (shard release / drain)."""

    shards: List[int] = field(default_factory=list)
    considered: int = 0
    snapshotted: int = 0
    skipped: int = 0       # gate-refused writes (not at tip, widened, ...)
    evicted: int = 0       # resident entries dropped for moved keys


@dataclass
class InReport:
    """One in-migration (hydration) pass over acquired shards."""

    shards: List[int] = field(default_factory=list)
    considered: int = 0
    hydrated: int = 0
    suffix_events: int = 0
    cold: int = 0
    #: record-less keys at or under YOUNG_BATCHES — expected-cold by
    #: the snapshot policy's own floor, excluded from the ratio gate
    young: int = 0
    stale: int = 0
    skipped_closed: int = 0
    already_resident: int = 0
    parity_divergence: int = 0
    parity_skipped_unstable: int = 0


class MigrationManager:
    """Shard-movement state migration for one host's serving tier.

    Bound to the host's `TPUReplayEngine` (shares its resident pool,
    pack cache, snapshotter, layout, and metrics registry) and its
    host-shard space (`membership.shard_id_for_workflow` over
    `num_shards` — the ring's unit of movement, NOT the device-mesh
    `workflow_shard` axis, which stays host-internal)."""

    def __init__(self, host: str, num_shards: int, tpu,
                 registry=None) -> None:
        self.host = host
        self.num_shards = num_shards
        self.tpu = tpu
        self.layout = tpu.layout
        self.metrics = registry if registry is not None else tpu.metrics
        self._lock = threading.Lock()
        #: shards queued for background hydration (coalesces acquire
        #: storms: a ring flap mid-pass just re-queues the shard)
        self._pending: Set[int] = set()
        self._thread: Optional[threading.Thread] = None
        self.last_out = OutReport()
        self.last_in = InReport()

    def _scope(self):
        return self.metrics.scope(m.SCOPE_TPU_MIGRATION)

    def shard_of(self, key: Tuple[str, str, str]) -> int:
        return shard_id_for_workflow(key[1], self.num_shards)

    # -- OUT: release / drain ----------------------------------------------

    def shards_released(self, shard_ids: Sequence[int]) -> OutReport:
        """The controller's release hook (ring moved shards away):
        snapshot every resident row living in the moving shards, then
        drop the local entries. Runs synchronously on the membership
        thread — the sweep is bounded by resident occupancy in the
        moved shards, and persisting BEFORE the gaining host's first
        cold admit is the whole point of the planned-rebalance path."""
        if not enabled():
            return OutReport(shards=list(shard_ids))
        return self.migrate_out(shard_ids, evict=True)

    def migrate_out(self, shard_ids: Sequence[int],
                    evict: bool = True) -> OutReport:
        """Persist (and optionally drop) the resident rows of
        `shard_ids`. `evict=False` is the drain verb's mode: the host
        keeps serving until it actually dies, the records just make its
        death a warm failover."""
        moved = set(int(s) for s in shard_ids)
        report = OutReport(shards=sorted(moved))
        scope = self._scope()
        resident = self.tpu.resident
        snapper = self.tpu.snapshotter()
        for key in resident.keys():
            if self.shard_of(key) not in moved:
                continue
            report.considered += 1
            try:
                written = snapper.snapshot_key(key, force=True)
            except Exception:
                written = False
            if written:
                report.snapshotted += 1
                scope.inc(m.M_MIG_OUT)
            else:
                # the write was gate-refused (widened rung, resident not
                # at the stored tip, checksum mismatch) — but an
                # EXISTING record at exactly the entry's address still
                # covers this row, so the move stays warm
                rec = None
                try:
                    rec = self.tpu.stores.snapshot.get(key)
                except Exception:
                    pass
                entry = resident.entry_for(key)
                if rec is not None and entry is not None \
                        and rec.address == entry.address:
                    report.snapshotted += 1
                    scope.inc(m.M_MIG_OUT)
                else:
                    report.skipped += 1
                    scope.inc(m.M_MIG_OUT_SKIPPED)
            if evict:
                if resident.invalidate(key):
                    report.evicted += 1
                    scope.inc(m.M_MIG_EVICTED)
                self.tpu.pack_cache.invalidate(key)
        self.last_out = report
        flightrecorder.emit(
            "migration-out", host=self.host, shards=report.shards,
            considered=report.considered, snapshotted=report.snapshotted,
            skipped=report.skipped, evicted=report.evicted)
        return report

    def drain_host(self, evict: bool = False) -> OutReport:
        """The drain verb: snapshot EVERY resident row on
        this host (all shards), keeping the entries unless asked —
        run before a planned kill so the survivors hydrate instead of
        replaying."""
        return self.migrate_out(range(self.num_shards), evict=evict)

    # -- IN: steal / acquire ------------------------------------------------

    def shards_acquired(self, shard_ids: Sequence[int]) -> None:
        """The controller's acquire hook: queue the shards and hydrate
        in the background (hydration does device work and store reads —
        it must never block the membership/beat thread)."""
        if not enabled() or not shard_ids:
            return
        with self._lock:
            self._pending.update(int(s) for s in shard_ids)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._hydrate_loop, daemon=True,
                    name=f"cadence-migration-{self.host}")
                self._thread.start()

    def _hydrate_loop(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    # drop the thread slot BEFORE the lock releases:
                    # a shards_acquired racing this exit must see
                    # "no live thread" and start a fresh one, or its
                    # shards would sit queued forever behind a
                    # dead-but-still-is_alive thread
                    self._thread = None
                    return
                batch = sorted(self._pending)
                self._pending.clear()
            try:
                self.hydrate_shards(batch)
            except Exception:
                # a failed pass leaves the keys to the serving tier's
                # on-demand hydration; never kill the loop
                continue

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until background hydration settles (tests/scenarios)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = self._thread is None and not self._pending
            if idle:
                return True
            time.sleep(0.02)
        return False

    def hydrate_shards(self, shard_ids: Sequence[int]) -> InReport:
        """Warm-start every open workflow of `shard_ids` from the shared
        snapshot store: seed resident + pack caches at the snapshot
        point, replay the appended suffix in one batched from-state
        pass, parity-check against the oracle where the store is
        stable. Synchronous core of the acquire hook (also the direct
        seam tests and the planned-rebalance verb use)."""
        wanted = set(int(s) for s in shard_ids)
        report = InReport(shards=sorted(wanted))
        scope = self._scope()
        stores = self.tpu.stores
        resident = self.tpu.resident
        # the engine's mesh wires the pool's shard slices before the first
        # lookup or admit (hydration admits onto the owning device)
        self.tpu.mesh
        try:
            # O(stolen keys): the store's per-shard execution index,
            # maintained incrementally by every writer — never a full
            # list_executions walk per steal (stores without the index
            # fall back)
            try:
                keys = stores.execution.list_executions_for_shards(
                    sorted(wanted), self.num_shards)
            except AttributeError:
                keys = [k for k in stores.execution.list_executions()
                        if self.shard_of(k) in wanted]
        except Exception:
            return report
        #: (key, entry, token) suffix items + their stability anchors
        suffix: List[tuple] = []
        anchors: Dict[tuple, int] = {}   # key -> last fetched event id
        expected: Dict[tuple, tuple] = {}  # key -> (row, branch, next_id)
        targets: Dict[tuple, ContentAddress] = {}  # key -> hydrated addr
        # one pool call: the snapshot rows admitted here reach the card
        # together when it ends (one copy per state tensor and one kernel-G
        # write), before the suffix replay gathers them
        with resident.batch():
            for key in keys:
                outcome = self._seed_key(key, report, anchors, expected,
                                         suffix, targets)
                if outcome == "hydrated-exact":
                    self._finish_key(key, report, anchors, expected, targets)
        if suffix:
            results, append_report = resident.replay_append_report(
                suffix,
                encode_suffix=lambda _k, token, _f: token[0],
                address_of=lambda token: token[1])
            report.suffix_events += append_report.events_appended
            scope.inc(m.M_MIG_SUFFIX_EVENTS, append_report.events_appended)
            for (key, _entry, _token), res in zip(suffix, results):
                if not res.ok:
                    # entry already invalidated by replay_append: the
                    # serving tier cold-admits on first touch
                    report.cold += 1
                    scope.inc(m.M_MIG_COLD)
                    continue
                self._finish_key(key, report, anchors, expected, targets)
        self.last_in = report
        flightrecorder.emit(
            "migration-in", host=self.host, shards=report.shards,
            considered=report.considered, hydrated=report.hydrated,
            suffix_events=report.suffix_events, cold=report.cold)
        return report

    def _seed_key(self, key, report: InReport, anchors, expected,
                  suffix, targets) -> str:
        """Hydrate ONE key up to (but not including) the suffix replay;
        returns the path taken. Mirrors the serving scheduler's
        batch-range discipline (engine/serving._route_ranged): the
        boundary batch's CRC proves the record still prefixes the
        stored bytes, and the prefix is never read or deserialized."""
        scope = self._scope()
        stores = self.tpu.stores
        resident = self.tpu.resident
        hs = stores.history
        report.considered += 1
        try:
            ms = stores.execution.get_workflow(*key)
        except Exception:
            report.cold += 1
            scope.inc(m.M_MIG_COLD)
            return "cold"
        if int(ms.execution_info.state) == int(WorkflowState.Completed):
            # closed workflows take no more transactions: nothing to
            # keep hot (verify hydrates them on demand if asked)
            report.skipped_closed += 1
            return "closed"
        if resident.entry_for(key) is not None:
            # the serving tier's on-demand path (or a previous pass)
            # got here first — don't double-admit or double-count
            report.already_resident += 1
            return "resident"
        try:
            if hs.branch_count(*key) > 1 \
                    or hs.get_current_branch(*key) != 0:
                report.cold += 1
                scope.inc(m.M_MIG_COLD)
                return "cold"
            total = hs.batch_count(*key)
        except Exception:
            report.cold += 1
            scope.inc(m.M_MIG_COLD)
            return "cold"
        rec = None
        if snapshot_mod.enabled():
            try:
                rec = stores.snapshot.get(key)
            except Exception:
                rec = None
        if rec is None or not snapshot_mod.validate_record(
                rec, self.layout, self.metrics):
            if rec is None and total <= YOUNG_BATCHES:
                report.young += 1
                scope.inc(m.M_MIG_YOUNG)
                return "young"
            report.cold += 1
            scope.inc(m.M_MIG_COLD)
            return "cold"
        try:
            part = (hs.as_history_batches_range(
                *key, from_batch=rec.batch_count - 1)
                if 0 < rec.batch_count <= total else None)
        except Exception:
            report.cold += 1
            scope.inc(m.M_MIG_COLD)
            return "cold"
        if not part or batch_crc(part[0]) != rec.last_batch_crc:
            report.stale += 1
            scope.inc(m.M_MIG_STALE)
            return "stale"
        if not snapshot_mod.seed_caches(rec, resident, self.tpu.pack_cache,
                                        self.layout, self.metrics):
            report.cold += 1
            scope.inc(m.M_MIG_COLD)
            return "cold"
        row = payload_row(ms, self.layout)
        row[STICKY_ROW_INDEX] = 0
        expected[key] = (row, int(ms.version_histories.current_index),
                         int(ms.execution_info.next_event_id))
        anchors[key] = int(part[-1].events[-1].id)
        new_addr = ContentAddress(total, batch_crc(part[-1]))
        targets[key] = new_addr
        if rec.batch_count == total:
            return "hydrated-exact"
        entry = resident.entry_for(key)
        rows = self.tpu.pack_cache.encode_append(key, rec.address,
                                                 part[1:], new_addr)
        if entry is None or rows is None:
            # the interner seed was evicted out from under us: leave
            # the key to the serving tier's full-read path
            resident.invalidate(key)
            report.cold += 1
            scope.inc(m.M_MIG_COLD)
            return "cold"
        suffix.append((key, entry, (rows, new_addr)))
        return "suffix"

    def _finish_key(self, key, report: InReport, anchors,
                    expected, targets) -> None:
        """Count one hydrated key, parity-checking its pinned payload
        against the oracle row read during the pass — but ONLY when the
        comparison is STABLE: the anchor event is still the tip the
        oracle row describes AND the entry still sits at the address
        this pass hydrated it to (the live serving tier may have
        legitimately advanced the entry mid-pass — its own gated parity
        covered that move). Anything moved is a foreign commit, not a
        divergence (the serving tier's _restabilize rule)."""
        scope = self._scope()
        entry = self.tpu.resident.entry_for(key)
        if entry is None:
            report.cold += 1
            scope.inc(m.M_MIG_COLD)
            return
        row, branch, next_id = expected[key]
        if anchors[key] + 1 != next_id \
                or entry.address != targets.get(key):
            report.hydrated += 1
            report.parity_skipped_unstable += 1
            scope.inc(m.M_MIG_IN)
            scope.inc(m.M_MIG_UNSTABLE)
            return
        payload = np.asarray(entry.payload, dtype=np.int64)
        if (payload == row).all() and int(entry.branch) == branch:
            report.hydrated += 1
            scope.inc(m.M_MIG_IN)
        else:
            # never serve wrong state: drop and count — gated at zero
            # by the migration tests
            self.tpu.resident.invalidate(key)
            report.parity_divergence += 1
            scope.inc(m.M_MIG_DIVERGENCE)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """The cluster admin rollup of this host's migration counters."""
        reg = self.metrics
        sc = m.SCOPE_TPU_MIGRATION
        return {
            "enabled": enabled(),
            "num_shards": self.num_shards,
            "migrated_out": reg.counter(sc, m.M_MIG_OUT),
            "migrate_out_skipped": reg.counter(sc, m.M_MIG_OUT_SKIPPED),
            "evicted_resident": reg.counter(sc, m.M_MIG_EVICTED),
            "migrated_in": reg.counter(sc, m.M_MIG_IN),
            "cold_steals": reg.counter(sc, m.M_MIG_COLD),
            "young_steals": reg.counter(sc, m.M_MIG_YOUNG),
            "stale_snapshots": reg.counter(sc, m.M_MIG_STALE),
            "suffix_events": reg.counter(sc, m.M_MIG_SUFFIX_EVENTS),
            "parity_divergence": reg.counter(sc, m.M_MIG_DIVERGENCE),
            "parity_skipped_unstable": reg.counter(sc, m.M_MIG_UNSTABLE),
        }
