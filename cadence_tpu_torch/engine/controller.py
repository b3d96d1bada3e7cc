"""Shard controller: shard ownership driven by the membership hashring.

Reference: service/history/shard/controller.go — each history host runs a
controller that acquires the shards the hashring assigns to it
(acquireShards:381) and releases the rest (shardClosedCallback:258);
engines are created per shard through the EngineFactory seam (:55-58,
default factory at handler.go:266). That seam is exactly where this
framework's TPU engine plugs in (tpu_engine.py).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..utils import flightrecorder
from ..utils import metrics as cm
from ..utils.clock import TimeSource
from .history_engine import HistoryEngine
from .membership import HashRing, shard_id_for_workflow
from .persistence import Stores
from .shard import ShardContext

EngineFactory = Callable[[ShardContext], HistoryEngine]


class ShardController:
    def __init__(self, host: str, num_shards: int, stores: Stores,
                 ring: HashRing, time_source: TimeSource,
                 engine_factory: Optional[EngineFactory] = None) -> None:
        self.host = host
        self.num_shards = num_shards
        self.stores = stores
        self.ring = ring
        self.clock = time_source
        self._factory = engine_factory or self._default_factory
        self._lock = threading.Lock()
        self._engines: Dict[int, HistoryEngine] = {}
        #: shard-movement hooks (engine/migration.MigrationManager):
        #: `on_shards_released(ids)` fires after the ring takes shards
        #: away (engines closed — the losing side persists its resident
        #: rows), `on_shards_acquired(ids)` after eager acquisition
        #: creates engines for newly assigned shards (the gaining side
        #: hydrates). Both best-effort: a hook failure must never block
        #: membership convergence.
        self.on_shards_released: Optional[Callable[[list], None]] = None
        self.on_shards_acquired: Optional[Callable[[list], None]] = None
        #: shards whose acquire hook has fired for the CURRENT ownership
        #: epoch (cleared on release) — membership, not engine presence,
        #: decides hook delivery: a routed request racing the ring flip
        #: can create the engine before ensure_assigned looks, and an
        #: existence check would then suppress the hook forever
        self._acquire_notified: set = set()
        #: counter sink — rebindable so a ServiceHost's own registry (the
        #: one its /metrics scrape serves) sees the eviction witness
        self.metrics = cm.DEFAULT_REGISTRY
        ring.subscribe(self._on_membership_change)

    def _default_factory(self, shard: ShardContext) -> HistoryEngine:
        return HistoryEngine(shard, self.stores, self.clock)

    def _owns(self, shard_id: int) -> bool:
        return self.ring.lookup(f"shard-{shard_id}") == self.host

    def shard_for(self, workflow_id: str) -> int:
        return shard_id_for_workflow(workflow_id, self.num_shards)

    def engine_for_shard(self, shard_id: int) -> HistoryEngine:
        """GetEngineForShard (controller.go:199-211): create+acquire lazily.

        A cached engine whose shard context was FENCED (another owner bumped
        the range while this host was partitioned/paused) is evicted and
        re-acquired — a restored host must not serve a deposed context
        forever (controller.go shardClosedCallback:258)."""
        if not self._owns(shard_id):
            raise ShardNotOwnedError(
                f"host {self.host} does not own shard {shard_id} "
                f"(owner: {self.ring.lookup(f'shard-{shard_id}')})"
            )
        with self._lock:
            engine = self._engines.get(shard_id)
            if engine is not None and engine.shard.is_closed:
                del self._engines[shard_id]
                engine = None
                # flap-back witness: a deposed context got evicted and is
                # about to re-acquire — the counter lets chaos campaigns
                # assert the fence actually fired on a restored host
                self.metrics.inc(cm.SCOPE_CONTROLLER,
                                 cm.M_FENCED_EVICTIONS)
                flightrecorder.emit("shard-fenced-evict", host=self.host,
                                    shard=shard_id)
            if engine is None:
                ctx = ShardContext(shard_id, self.host, self.stores)
                ctx.acquire()
                engine = self._factory(ctx)
                self._engines[shard_id] = engine
            return engine

    def cached_engine(self, shard_id: int) -> Optional[HistoryEngine]:
        """The engine object currently cached for a shard, WITHOUT ring
        validation or acquisition — admin/introspection only (the
        deposed-owner fencing probe and DescribeHistoryHost analog)."""
        with self._lock:
            return self._engines.get(shard_id)

    def engine_for_workflow(self, workflow_id: str) -> HistoryEngine:
        return self.engine_for_shard(self.shard_for(workflow_id))

    def owned_shards(self):
        with self._lock:
            return sorted(self._engines.keys())

    def assigned_shards(self):
        """All shards the ring currently assigns to this host (whether or not
        an engine exists yet) — what the queue processors must sweep."""
        return [s for s in range(self.num_shards) if self._owns(s)]

    def _on_membership_change(self) -> None:
        """acquireShards (controller.go:381): release shards the ring no
        longer assigns here and eagerly acquire newly assigned ones, so
        their queues resume from persisted ack levels without waiting for a
        routed request."""
        released = []
        with self._lock:
            for shard_id in list(self._engines.keys()):
                if not self._owns(shard_id):
                    self._engines[shard_id].shard.close()
                    del self._engines[shard_id]
                    released.append(shard_id)
                    self._acquire_notified.discard(shard_id)
        if released and self.on_shards_released is not None:
            try:
                self.on_shards_released(released)
            except Exception:
                pass  # migration is best-effort; convergence is not
        self.ensure_assigned()

    def ensure_assigned(self) -> None:
        """Idempotent eager acquisition of every assigned shard. Per-shard
        failures (store briefly unreachable, ring moved mid-loop) skip that
        shard — the next call, routed request, or queue pump retries; one
        bad shard must never abort acquisition of the rest. Newly created
        engines fire the acquire hook (the in-migration seam) — also on a
        later retry beat, so a shard whose first acquisition failed still
        hydrates when it finally lands."""
        acquired = []
        for shard_id in self.assigned_shards():
            try:
                self.engine_for_shard(shard_id)
            except Exception:
                continue
            with self._lock:
                if shard_id not in self._acquire_notified:
                    self._acquire_notified.add(shard_id)
                    acquired.append(shard_id)
        if acquired and self.on_shards_acquired is not None:
            try:
                self.on_shards_acquired(acquired)
            except Exception:
                pass


class ShardNotOwnedError(Exception):
    """Routing error: caller must redirect to the owning host (the
    client/history peer-resolver redirect analog)."""
