"""Two-cluster harness: active + standby with replication and failover.

Reference analog: the XDC integration setup
(config/development_xdc_cluster0/1.yaml cluster-group metadata +
docker-compose-multiclusters) collapsed into one process — two Onebox
clusters, the replication stream between them, and graceful failover
(domain failover version bump; common/domain/failover_watcher.go and the
failovermanager workflow drive the same transition in the reference).

Both clusters run their device tiers on one device, named at construction:
None means the card, and without one construction raises.
"""
from __future__ import annotations

from typing import List, Optional

from ..core.events import HistoryBatch
from .cluster import ClusterMetadata
from .onebox import Onebox
from .replication import (
    HistoryReplicator,
    ReplicationPublisher,
    ReplicationTaskProcessor,
)
from .task_refresher import sweep_refresh


def _refresh_domain_tasks(box: Onebox, domain_name: str) -> None:
    """Promotion sweep for one domain (shared sweep in task_refresher)."""
    domain_id = box.stores.domain.by_name(domain_name).domain_id
    sweep_refresh(box.stores, box.route, domain_id)


def prehydrate_serving(box: Onebox) -> dict:
    """Warm promotion: hydrate the promoting box's serving
    tier from its snapshot store — which snapshot-shipping replication
    has been filling continuously — BEFORE the active flip, so the first
    post-failover transactions land on resident rows instead of paying a
    cold replay storm. One pass of the migration tier's shared hydration
    primitive over every shard (seed_caches + batch-range suffix replay,
    oracle parity gated)."""
    from .migration import MigrationManager
    mgr = MigrationManager(box.cluster_name, box.num_shards, box.tpu,
                           registry=box.metrics)
    report = mgr.hydrate_shards(range(box.num_shards))
    return {"considered": report.considered, "hydrated": report.hydrated,
            "suffix_events": report.suffix_events, "cold": report.cold,
            "young": report.young, "stale": report.stale,
            "already_resident": report.already_resident,
            "parity_divergence": report.parity_divergence}


class ReplicatedClusters:
    def __init__(self, num_hosts: int = 1, num_shards: int = 4,
                 metadata: Optional[ClusterMetadata] = None,
                 active_stores=None, standby_stores=None, device=None) -> None:
        self.meta = metadata or ClusterMetadata()
        self.active = Onebox(num_hosts=num_hosts, num_shards=num_shards,
                             cluster_name="primary", stores=active_stores,
                             device=device)
        self.standby = Onebox(num_hosts=num_hosts, num_shards=num_shards,
                              cluster_name="standby", stores=standby_stores,
                              device=device)
        self.publisher = ReplicationPublisher(self.active.stores)
        self.active.set_replication_publisher(self.publisher)
        self.replicator = HistoryReplicator(self.standby.stores,
                                            rebuilder=self.standby.rebuilder,
                                            notifier=self.standby.notifier)
        self.processor = ReplicationTaskProcessor(
            self.replicator, self.publisher, self.standby.stores,
            source_history_reader=self._read_source_history,
            tpu=self.standby.tpu)
        self.processor.metrics = self.standby.metrics
        # snapshot-shipping replication: every record the active side's
        # post-append policy writes rides the same stream, so the
        # standby's cold admits and its promotion are suffix replays
        self.active.tpu.snapshotter().shipper = (
            lambda rec: self.publisher.publish_snapshot(rec, "primary"))
        # reverse direction (standby → active): every cluster in an NDC
        # group both publishes and consumes (task_fetcher.go polls every
        # remote cluster); needed for post-split-brain reconciliation
        self.reverse_publisher = ReplicationPublisher(self.standby.stores)
        self.standby.set_replication_publisher(self.reverse_publisher)
        self.reverse_replicator = HistoryReplicator(
            self.active.stores, rebuilder=self.active.rebuilder,
            notifier=self.active.notifier)
        self.reverse_processor = ReplicationTaskProcessor(
            self.reverse_replicator, self.reverse_publisher,
            self.active.stores,
            source_history_reader=self._read_standby_history,
            tpu=self.active.tpu)
        self.reverse_processor.metrics = self.active.metrics
        self.standby.tpu.snapshotter().shipper = (
            lambda rec: self.reverse_publisher.publish_snapshot(
                rec, "standby"))
        # domain-metadata replication (common/domain/replication_queue.go
        # + worker/replicator): active-side domain mutations stream to the
        # standby, which recomputes is_active from its own cluster name
        from .domainrepl import (
            DomainReplicationProcessor,
            DomainReplicationPublisher,
        )
        self.domain_publisher = DomainReplicationPublisher(self.active.stores)
        self.active.frontend.domain_replication_publisher = self.domain_publisher
        self.domain_processor = DomainReplicationProcessor(
            self.active.stores, self.standby.stores, "standby")
        self.reverse_domain_publisher = DomainReplicationPublisher(
            self.standby.stores)
        self.standby.frontend.domain_replication_publisher = (
            self.reverse_domain_publisher)
        self.reverse_domain_processor = DomainReplicationProcessor(
            self.standby.stores, self.active.stores, "primary")
        # cross-cluster task executors (cross_cluster_task_processor.go):
        # operations whose TARGET domain is active on the peer park on a
        # per-target queue; the peer's processor executes them and the
        # result applies back on the source workflow
        from .crosscluster import CrossClusterProcessor, CrossClusterPublisher
        self.cross_cluster_publisher = CrossClusterPublisher(self.active.stores)
        for p in self.active.processors:
            p.cross_cluster_publisher = self.cross_cluster_publisher
        self.reverse_cross_cluster_publisher = CrossClusterPublisher(
            self.standby.stores)
        for p in self.standby.processors:
            p.cross_cluster_publisher = self.reverse_cross_cluster_publisher
        # one consumer per (source store × executing cluster): the two
        # cross pairs carry normal traffic; the two SELF pairs drain tasks
        # re-homed after a failover flipped the target domain back
        def _xc(source_box, exec_box, exec_name):
            return CrossClusterProcessor(
                source_box.stores, exec_box.route, source_box.route,
                exec_name, target_stores=exec_box.stores)
        self.cross_cluster_processor = _xc(self.active, self.standby,
                                           "standby")
        self.reverse_cross_cluster_processor = _xc(self.standby, self.active,
                                                   "primary")
        self._self_cross_cluster_processors = [
            _xc(self.active, self.active, "primary"),
            _xc(self.standby, self.standby, "standby"),
        ]

    def _read_source_history(self, domain_id: str, workflow_id: str,
                             run_id: str, from_event_id: int,
                             to_event_id: int) -> List[HistoryBatch]:
        """Admin GetWorkflowExecutionRawHistoryV2 analog for the resender."""
        batches = self.active.stores.history.as_history_batches(
            domain_id, workflow_id, run_id)
        return [b for b in batches
                if from_event_id <= b.events[0].id < to_event_id]

    def _read_standby_history(self, domain_id: str, workflow_id: str,
                              run_id: str, from_event_id: int,
                              to_event_id: int) -> List[HistoryBatch]:
        batches = self.standby.stores.history.as_history_batches(
            domain_id, workflow_id, run_id)
        return [b for b in batches
                if from_event_id <= b.events[0].id < to_event_id]

    def register_global_domain(self, name: str, retention_days: int = 1) -> str:
        version = self.meta.initial_failover_version("primary")
        domain_id = self.active.frontend.register_domain(
            name, retention_days=retention_days, is_active=True,
            clusters=self.meta.cluster_names, active_cluster="primary",
            failover_version=version)
        self.standby.frontend.register_domain(
            name, retention_days=retention_days, is_active=False,
            clusters=self.meta.cluster_names, active_cluster="primary",
            failover_version=version, domain_id=domain_id)
        return domain_id

    def replicate(self) -> int:
        """Drain the replication stream into the standby (history AND
        domain metadata)."""
        total = self.domain_processor.process_once()
        while True:
            n = self.processor.process_once()
            total += n
            if n == 0:
                return total

    def replicate_domains(self) -> int:
        """Drain only the domain-metadata stream (both directions)."""
        return (self.domain_processor.process_once()
                + self.reverse_domain_processor.process_once())

    def replicate_reverse(self) -> int:
        """Drain the standby's outbound stream into the active cluster."""
        total = 0
        while True:
            n = self.reverse_processor.process_once()
            total += n
            if n == 0:
                return total

    def split_brain_promote(self, domain_name: str) -> int:
        """NON-graceful failover: ONLY the standby learns it is active (the
        old active keeps writing at its version) — the divergence generator
        for NDC conflict-resolution tests (host/ndc/integration_test.go
        crafts the same shape with conflicting event batches). Returns the
        standby's new failover version."""
        d = self.standby.stores.domain.by_name(domain_name)
        new_version = self.meta.next_failover_version(
            "standby", d.failover_version)
        d.failover_version = new_version
        d.active_cluster = "standby"
        d.is_active = True
        # notification-version ordering: a queued pre-promotion domain
        # task must never replay OVER this write on a receiving cluster
        d.notification_version += 1
        self.standby.stores.domain.update(d)
        _refresh_domain_tasks(self.standby, domain_name)
        return new_version

    def heal(self, domain_name: str, active_cluster: str = "standby") -> None:
        """Post-split-brain reconnection: converge domain metadata to the
        winner, then drain both replication directions so conflict
        resolution runs on both sides."""
        winner = (self.standby if active_cluster == "standby"
                  else self.active).stores.domain.by_name(domain_name)
        winner_nv = max(
            self.active.stores.domain.by_name(domain_name).notification_version,
            self.standby.stores.domain.by_name(domain_name).notification_version,
        ) + 1
        for box in (self.active, self.standby):
            d = box.stores.domain.by_name(domain_name)
            d.failover_version = winner.failover_version
            d.active_cluster = active_cluster
            d.is_active = box.cluster_name == active_cluster
            d.notification_version = winner_nv
            box.stores.domain.update(d)
        self.replicate()
        self.replicate_reverse()

    def process_cross_cluster(self) -> int:
        """Drain both clusters' parked cross-cluster tasks (including
        tasks re-homed after an intervening failover)."""
        total = (self.cross_cluster_processor.process_once()
                 + self.reverse_cross_cluster_processor.process_once())
        for proc in self._self_cross_cluster_processors:
            total += proc.process_once()
        return total

    def redirecting_frontend(self, cluster: str,
                             policy: str = "selected-apis-forwarding"):
        """The cluster-redirection wrapper for one side's frontend
        (clusterRedirectionHandler.go): global domains' active APIs
        forward to the active cluster."""
        from .redirection import ClusterRedirectionFrontend
        if cluster == "primary":
            local, remote = self.active.frontend, self.standby.frontend
            remotes = {"standby": remote}
        else:
            local, remote = self.standby.frontend, self.active.frontend
            remotes = {"primary": remote}
        return ClusterRedirectionFrontend(local, remotes, cluster,
                                          policy=policy)

    def failover(self, domain_name: str, to_cluster: str = "standby") -> int:
        """Graceful failover: bump the domain failover version into the
        target cluster's slot on BOTH clusters (domain metadata replication
        is synchronous here; the reference streams it via the worker
        replicator). Returns the new failover version."""
        current = self.active.stores.domain.by_name(domain_name).failover_version
        new_version = self.meta.next_failover_version(to_cluster, current)
        next_nv = max(
            self.active.stores.domain.by_name(domain_name).notification_version,
            self.standby.stores.domain.by_name(domain_name).notification_version,
        ) + 1
        for box in (self.active, self.standby):
            d = box.stores.domain.by_name(domain_name)
            d.failover_version = new_version
            d.active_cluster = to_cluster
            d.is_active = box.cluster_name == to_cluster
            # ahead of any queued pre-failover domain-replication task
            d.notification_version = next_nv
            box.stores.domain.update(d)
        # Standby promotion: the replicated state carries no tasks
        # (replication.py discards them), so every open workflow on the
        # newly-active cluster regenerates its outstanding tasks from
        # mutable state (RefreshTasks, mutable_state_task_refresher.go:77) —
        # without this, pre-failover pending work (in-flight activities,
        # user timers, pending decisions) never runs on the new active side.
        promoted = self.standby if to_cluster == "standby" else self.active
        _refresh_domain_tasks(promoted, domain_name)
        return new_version
