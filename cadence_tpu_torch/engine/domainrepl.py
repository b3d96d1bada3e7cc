"""Domain-metadata replication: domain mutations flow to every cluster.

Reference: common/domain/replicationTaskExecutor.go (apply
register/update tasks on the receiving cluster), replication_queue.go
(the DB-backed domain replication queue), and service/worker/replicator
(the consumer). The reference transports these over Kafka; this
framework's messaging seam is the durable store queue (the same
reframing the history replication stream uses — one ordered,
at-least-once topic per concern).

The receiving side recomputes `is_active` from its OWN cluster name, so
one replicated record serves every consumer (the invariant that makes a
domain "global": same domain_id, same config, per-cluster activeness).

Conflicts arbitrate on FAILOVER VERSION first (domain/replicationTask
Executor.go handleDomainUpdateReplicationTask: the record carrying the
higher failover version is the authority — the split-brain winner),
with notification version breaking ties WITHIN one failover epoch (the
config-update ordering). A task carrying a LOWER failover version than
the local record is the loser region's update arriving after a
partition heals: it is rejected typed (`StaleDomainUpdate` recorded on
`stale_rejects`) and counted, never applied — last-writer-wins here
would let wall-clock arrival order overwrite the arbitration the
execution tier already enforces (`_Txn.commit`'s version guard).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Tuple

from ..utils import metrics as cm
from .persistence import DomainInfo, EntityNotExistsError

DOMAIN_REPLICATION_QUEUE = "domain-replication"

#: bounded queue of rejected-stale updates kept for operator inspection
#: (the "queue" half of reject/queue: losers are observable, not silently
#: dropped — `admin dlq`-style forensics without a second DLQ)
STALE_KEEP = 64


@dataclass(frozen=True)
class StaleDomainUpdate:
    """A rejected domain mutation: its failover version lost arbitration
    against the locally applied record."""

    domain_id: str
    name: str
    task_failover_version: int
    local_failover_version: int
    task_notification_version: int
    local_notification_version: int


@dataclass(frozen=True)
class DomainReplicationTask:
    """One domain mutation (replicator.DomainTaskAttributes analog)."""

    domain_id: str
    name: str
    retention_days: int
    active_cluster: str
    clusters: Tuple[str, ...]
    failover_version: int
    notification_version: int
    status: int
    description: str
    history_archival_uri: str

    @classmethod
    def of(cls, info: DomainInfo) -> "DomainReplicationTask":
        return cls(domain_id=info.domain_id, name=info.name,
                   retention_days=info.retention_days,
                   active_cluster=info.active_cluster,
                   clusters=tuple(info.clusters),
                   failover_version=info.failover_version,
                   notification_version=info.notification_version,
                   status=info.status, description=info.description,
                   history_archival_uri=info.history_archival_uri)


class DomainReplicationPublisher:
    """Active-side producer: every domain mutation enqueues a task."""

    def __init__(self, stores) -> None:
        self.stores = stores

    def publish(self, info: DomainInfo) -> None:
        self.stores.queue.enqueue(DOMAIN_REPLICATION_QUEUE,
                                  DomainReplicationTask.of(info))


class DomainReplicationProcessor:
    """Receiving-side consumer (replicationTaskExecutor.Execute): apply
    register-or-update, recomputing is_active locally. Arbitration is
    failover-version-first (see module docstring): lower failover
    version → typed+counted reject onto `stale_rejects`; same failover
    version, notification version not newer → duplicate replay of the
    at-least-once queue, skipped silently (counted)."""

    def __init__(self, source_queue_stores, target_stores,
                 local_cluster: str) -> None:
        self.source = source_queue_stores
        self.target = target_stores
        self.local_cluster = local_cluster
        self._cursor = 0
        #: optional hook(task, became_active) fired after an APPLIED task;
        #: `became_active` is True when this apply flipped the domain
        #: active onto THIS cluster — the standby-promotion trigger (the
        #: wire hosts run the task-refresher sweep off it, the analog of
        #: failover_watcher.go reacting to the metadata change)
        self.on_applied = None
        #: last STALE_KEEP arbitration losers, newest last
        self.stale_rejects: Deque[StaleDomainUpdate] = deque(
            maxlen=STALE_KEEP)
        #: counter sink (a ServiceHost rebinds to its own registry)
        self.metrics = cm.DEFAULT_REGISTRY

    def process_once(self) -> int:
        """Drain the stream to the tail (all pages); returns tasks
        APPLIED (stale replays advance the cursor without counting)."""
        applied = 0
        while True:
            items = self.source.queue.read(DOMAIN_REPLICATION_QUEUE,
                                           self._cursor)
            if not items:
                return applied
            for index, task in items:
                self._cursor = index + 1
                if self._apply(task):
                    applied += 1

    def _apply(self, task: DomainReplicationTask) -> bool:
        info = DomainInfo(
            domain_id=task.domain_id, name=task.name,
            retention_days=task.retention_days,
            is_active=task.active_cluster == self.local_cluster,
            active_cluster=task.active_cluster,
            clusters=tuple(task.clusters),
            failover_version=task.failover_version,
            notification_version=task.notification_version,
            status=task.status, description=task.description,
            history_archival_uri=task.history_archival_uri)
        try:
            existing = self.target.domain.by_id(task.domain_id)
        except EntityNotExistsError:
            self.target.domain.register(info)
            self.metrics.inc(cm.SCOPE_REPLICATION, cm.M_DOMREPL_APPLIED)
            if self.on_applied is not None:
                self.on_applied(task, info.is_active)
            return True
        if task.failover_version < existing.failover_version:
            # arbitration loser: the split-brain standby's update landing
            # after the winner's — reject typed + counted, NEVER apply
            # (LWW here would re-activate the deposed region's view)
            self.stale_rejects.append(StaleDomainUpdate(
                domain_id=task.domain_id, name=task.name,
                task_failover_version=task.failover_version,
                local_failover_version=existing.failover_version,
                task_notification_version=task.notification_version,
                local_notification_version=existing.notification_version))
            self.metrics.inc(cm.SCOPE_REPLICATION,
                             cm.M_DOMREPL_STALE_REJECTED)
            return False
        if (task.failover_version == existing.failover_version
                and existing.notification_version
                >= task.notification_version):
            # duplicate replay within one failover epoch (at-least-once
            # queue): already applied, advance past it
            self.metrics.inc(cm.SCOPE_REPLICATION, cm.M_DOMREPL_DUPLICATE)
            return False
        self.target.domain.update(info)
        self.metrics.inc(cm.SCOPE_REPLICATION, cm.M_DOMREPL_APPLIED)
        if self.on_applied is not None:
            became_active = (info.is_active
                             and existing.active_cluster != self.local_cluster)
            self.on_applied(task, became_active)
        return True
