"""LRU caches: execution context cache + domain cache + pack cache.

Reference: common/cache/lru.go (bounded LRU), service/history/execution/
cache.go:48 (per-shard workflow-context cache — the engine's hot-path
read amortizer), and common/cache/domainCache.go (domain metadata cache
with a refresh/notification-version contract).

Correctness model (differs from a plain memoizer on purpose):
- every EXECUTION cache entry is stamped with the store's per-key WRITE
  VERSION; a hit revalidates the version before use, so a write from ANY
  other path (replication passive-apply, NDC conflict resolution, admin
  rebuild — the writers that bypass this engine) invalidates the entry
  instead of serving a stale state. The version probe is a tiny store
  call; the win is skipping the full mutable-state read (a network
  round-trip + unpickle against a remote store server).
- the DOMAIN cache revalidates against the domain store's global
  mutation counter, so UpdateDomain/failover take effect on the next
  transaction (the reference tolerates a refresh interval of staleness;
  this is strictly fresher).
- the PACK cache holds per-workflow ENCODED LANE ROWS for the bulk
  replay path, content-addressed by (workflow key, batch count,
  last-batch checksum). Histories are append-only, so a stale entry is
  usually a valid PREFIX: re-verifying after one appended batch packs
  only the suffix (ops/encode.encode_batches_resumable carries the
  interner forward), producing lanes byte-identical to a cold pack.
  Hit/miss/evict/suffix counters land on /metrics under tpu.pack-cache.
"""
from __future__ import annotations

import copy
import threading
import zlib
from collections import OrderedDict
from typing import Any, Hashable, NamedTuple, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Content addressing — ONE implementation shared by every cache keyed on
# history content (PackCache here, engine/resident.ResidentStateCache):
# the invalidation semantics (what counts as exact / prefix / stale) must
# never drift between the host-side pack cache and the HBM-resident state
# cache, or an append could replay against a state built from different
# bytes than the lanes it packs.
# ---------------------------------------------------------------------------


def batch_crc(batch) -> int:
    """CRC32 of one serialized batch — the tail fingerprint of the
    content address (a torn/overwritten tail changes the last batch's
    bytes, so the checksum catches every mutation the engine can
    produce; new_run_events ride the serialized form too)."""
    from ..core.codec import serialize_history
    return zlib.crc32(serialize_history([batch]))


class ContentAddress(NamedTuple):
    """(batch count, last-batch CRC32) — with the workflow key, the full
    content address of one run's single-lineage history."""

    batch_count: int
    last_batch_crc: int


def content_address(batches) -> ContentAddress:
    """Address of a history as currently stored (empty histories address
    as (0, 0) and never hit)."""
    if not batches:
        return ContentAddress(0, 0)
    return ContentAddress(len(batches), batch_crc(batches[-1]))


def address_relation(cached: ContentAddress, batches) -> str:
    """How `batches` relates to a cached address:

    - "exact":  same count and the last batch checksums the same;
    - "prefix": MORE batches now and the batch at the cached count - 1
      still checksums the same — the cached entry is a valid prefix,
      only the appended suffix is new (histories are append-only);
    - "stale":  anything else — fewer batches, or a checksum mismatch at
      the cached position (tail overwrite after a retried transaction,
      reset rewrite). The caller must invalidate, never serve.
    """
    n = len(batches)
    if cached.batch_count <= 0 or cached.batch_count > n:
        return "stale"
    if batch_crc(batches[cached.batch_count - 1]) != cached.last_batch_crc:
        return "stale"
    return "exact" if cached.batch_count == n else "prefix"


class LRUCache:
    """Bounded LRU (common/cache/lru.go): get refreshes recency, put
    evicts the least-recent entry past capacity."""

    def __init__(self, max_size: int = 512) -> None:
        self.max_size = max_size
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: Hashable, value: Any) -> int:
        """Returns how many entries THIS put evicted (computed under the
        lock, so concurrent writers can attribute evictions exactly)."""
        evicted = 0
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)
                self.evictions += 1
                evicted += 1
        return evicted

    def delete(self, key: Hashable) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class ExecutionCache:
    """Per-engine mutable-state cache (execution/cache.go analog).

    Entries are (state, store write version); `load` returns a PRIVATE
    deepcopy (the transaction mutates it freely) only when the version
    still matches the store — any foreign write is detected, never
    served stale. The engine's shard ownership makes it the only ACTIVE
    writer, but passive appliers exist, hence the revalidation."""

    def __init__(self, max_size: int = 512) -> None:
        self.lru = LRUCache(max_size)

    def load(self, stores, domain_id: str, workflow_id: str,
             run_id: str):
        key = (domain_id, workflow_id, run_id)
        entry = self.lru.get(key)
        if entry is None:
            return None
        ms, version = entry
        current = stores.execution.get_version(domain_id, workflow_id, run_id)
        if current != version:
            self.lru.delete(key)
            return None
        return copy.deepcopy(ms)

    def store(self, domain_id: str, workflow_id: str, run_id: str,
              ms, version: int) -> None:
        self.lru.put((domain_id, workflow_id, run_id),
                     (copy.deepcopy(ms), version))

    def invalidate(self, domain_id: str, workflow_id: str,
                   run_id: str) -> None:
        self.lru.delete((domain_id, workflow_id, run_id))


class PackCache:
    """Content-addressed cache of packed (encoded) lane rows per workflow
    for the bulk replay executor (engine/tpu_engine.py).

    An entry is the workflow's UNPADDED [n, L] int64 lane rows plus its
    content address: (batch count, CRC32 of the serialized last batch)
    and the interner snapshot needed to extend it. Validation on every
    get:

    - exact hit: same batch count, same last-batch checksum → the rows
      are byte-identical to a cold encode (histories are append-only and
      a torn/overwritten tail changes the last batch's bytes, so the
      checksum catches every mutation the engine can produce);
    - suffix hit: MORE batches now, and the batch at the cached count - 1
      still checksums the same → the entry is a valid prefix; only the
      appended suffix is encoded (resumed interner), then re-cached;
    - anything else (fewer batches, checksum mismatch — tail overwrite
      after a retried transaction) is a miss: full repack.

    Counters (hits/misses/evictions/suffix-packs) are emitted to the
    registry under SCOPE_PACK_CACHE so /metrics scrapes show cache
    effectiveness next to the pipeline legs.
    """

    def __init__(self, max_size: int = 4096, registry=None) -> None:
        from ..utils import metrics as m
        self.lru = LRUCache(max_size)
        self.metrics = registry if registry is not None else m.DEFAULT_REGISTRY
        self._m = m

    def encode(self, key: Tuple[str, str, str], batches) -> np.ndarray:
        """Encoded [n, L] rows for this key's history (single lineage,
        batches in store order). Callers must treat the result as
        immutable — it is the cached array. A suffix-seeded entry
        (base_events > 0, engine/snapshot.py hydration) cannot serve a
        FULL encode — it covers only the post-snapshot rows — so it
        counts as a miss here and is upgraded to a base-0 entry by the
        full pack."""
        from ..ops.encode import NUM_LANES, encode_batches_resumable

        m = self._m
        scope = self.metrics.scope(m.SCOPE_PACK_CACHE)
        n_batches = len(batches)
        if n_batches == 0:
            return np.zeros((0, NUM_LANES), dtype=np.int64)
        entry = self.lru.get(key)
        if entry is not None:
            rows, address, interner_map, base = entry
            relation = address_relation(address, batches)
            if base == 0 and relation == "exact":
                scope.inc(m.M_CACHE_HITS)
                return rows
            if base == 0 and relation == "prefix":
                # valid prefix: pack only the appended suffix
                suffix, new_map = encode_batches_resumable(
                    batches[address.batch_count:], interner_map)
                rows = np.concatenate([rows, suffix])
                scope.inc(m.M_CACHE_SUFFIX_PACKS)
                self._put(key, rows, content_address(batches), new_map)
                return rows
        scope.inc(m.M_CACHE_MISSES)
        rows, interner_map = encode_batches_resumable(batches)
        self._put(key, rows, content_address(batches), interner_map)
        return rows

    def encode_append(self, key: Tuple[str, str, str], prefix_address,
                      new_batches, new_address) -> Optional[np.ndarray]:
        """Suffix rows for `new_batches` appended DIRECTLY after a cached
        prefix — the serving tier's zero-read hot path: the committed
        batches were handed over by the engine, so when the cached entry
        still matches `prefix_address` the suffix encodes from the
        resumed interner without ever re-reading (or re-serializing) the
        store history. Returns None when the entry is missing or covers
        different bytes (caller falls back to the full-read path); on
        success the cache is re-addressed at `new_address` so the next
        chained append extends it again. Works identically on a
        suffix-seeded entry (the base offset rides along), which is what
        keeps a snapshot-hydrated workflow's serving chain O(suffix)
        without the prefix ever being packed."""
        from ..ops.encode import encode_batches_resumable

        entry = self.lru.get(key)
        if entry is None:
            return None
        rows, address, interner_map, base = entry
        if address != prefix_address:
            return None
        suffix, new_map = encode_batches_resumable(new_batches,
                                                   interner_map)
        self.metrics.inc(self._m.SCOPE_PACK_CACHE,
                         self._m.M_CACHE_SUFFIX_PACKS)
        self._put(key, np.concatenate([rows, suffix]), new_address,
                  new_map, base_events=base)
        return suffix

    def encode_suffix(self, key: Tuple[str, str, str], batches,
                      from_batch: int) -> np.ndarray:
        """Only the rows of batches[from_batch:] — the resident-state
        append path (engine/resident.py): the device replays JUST the
        appended lanes against the HBM-resident state. Suffix bytes are
        guaranteed identical to the corresponding slice of a full pack
        (resumed-interner contract). A suffix-seeded entry
        (base_events > 0) serves any slice at or past its base without
        ever materializing the prefix rows — the snapshot tier's
        O(suffix) host-side half; everything else routes through
        encode() so the counters keep telling the truth about how the
        lanes were produced (hit / suffix-pack / miss)."""
        from ..ops.encode import encode_batches_resumable, history_length

        start = history_length(batches[:from_batch])
        entry = self.lru.get(key)
        if entry is not None and entry[3] > 0:
            rows, address, interner_map, base = entry
            relation = address_relation(address, batches)
            if relation in ("exact", "prefix") and start >= base:
                if relation == "prefix":
                    suffix, new_map = encode_batches_resumable(
                        batches[address.batch_count:], interner_map)
                    rows = np.concatenate([rows, suffix])
                    self.metrics.inc(self._m.SCOPE_PACK_CACHE,
                                     self._m.M_CACHE_SUFFIX_PACKS)
                    self._put(key, rows, content_address(batches),
                              new_map, base_events=base)
                else:
                    self.metrics.inc(self._m.SCOPE_PACK_CACHE,
                                     self._m.M_CACHE_HITS)
                return rows[start - base:]
            # stale or pre-base request: fall through to the full path
        rows = self.encode(key, batches)
        return rows[start:]

    def seed_suffix(self, key: Tuple[str, str, str],
                    address: ContentAddress, interner_map,
                    base_events: int) -> None:
        """Install a ZERO-ROW entry anchored at a snapshot's content
        address with its persisted interner (engine/snapshot.py
        hydration): subsequent encode_suffix/encode_append calls for
        this key extend from here — byte-identical to a resumed full
        pack — without the prefix lanes ever existing on this host."""
        from ..ops.encode import NUM_LANES

        self._put(key, np.zeros((0, NUM_LANES), dtype=np.int64),
                  address, dict(interner_map),
                  base_events=int(base_events))

    def interner_for(self, key: Tuple[str, str, str],
                     address: ContentAddress):
        """The cached interner snapshot at exactly `address` (None
        otherwise) — the snapshot writer persists it so hydration can
        resume suffix encoding without the prefix."""
        entry = self.lru.get(key)
        if entry is None or entry[1] != address:
            return None
        return entry[2]

    def events_for(self, key: Tuple[str, str, str],
                   address: ContentAddress) -> Optional[int]:
        """Total packed event rows covered by the entry at `address`
        (base offset + cached rows); None when the cache holds nothing
        for that address."""
        entry = self.lru.get(key)
        if entry is None or entry[1] != address:
            return None
        return int(entry[3] + entry[0].shape[0])

    def _put(self, key, rows, address: ContentAddress,
             interner_map, base_events: int = 0) -> None:
        evicted = self.lru.put(key, (rows, address, interner_map,
                                     int(base_events)))
        if evicted:
            self.metrics.inc(self._m.SCOPE_PACK_CACHE,
                             self._m.M_CACHE_EVICTIONS, evicted)

    def invalidate(self, key: Tuple[str, str, str]) -> None:
        self.lru.delete(key)

    def clear(self) -> None:
        self.lru.clear()


class DomainCache:
    """Domain metadata cache (common/cache/domainCache.go): revalidates
    against the store's mutation counter so updates/failovers surface on
    the next read."""

    def __init__(self, max_size: int = 256) -> None:
        self.lru = LRUCache(max_size)
        self._store_version = -1
        self._lock = threading.Lock()

    def _revalidate(self, stores) -> None:
        current = stores.domain.mutation_version()
        with self._lock:
            if current != self._store_version:
                self.lru.clear()
                self._store_version = current

    def by_id(self, stores, domain_id: str):
        self._revalidate(stores)
        info = self.lru.get(("id", domain_id))
        if info is None:
            info = stores.domain.by_id(domain_id)
            self.lru.put(("id", domain_id), info)
        return info

    def by_name(self, stores, name: str):
        self._revalidate(stores)
        info = self.lru.get(("name", name))
        if info is None:
            info = stores.domain.by_name(name)
            self.lru.put(("name", name), info)
        return info
