"""Managed failover: the failover workflow as an explicit coordinator.

Reference: service/worker/failovermanager/workflow.go — an operator
kicks off a failover workflow that processes domains in batches: drain
replication, flip the active cluster, verify, report per-domain status;
`rebalance` moves every mis-homed domain. The reference runs this as a
system workflow on the Cadence SDK; here it is a coordinator with the
same step structure and per-domain failure isolation, driven by the
operator (or a cron'd host loop).

Warm promotion: the graceful path drains in-flight
replication acks under a BOUNDED deadline — a source that cannot drain
in time degrades to NDC conflict resolution on the promoted side
instead of blocking the failover — and pre-hydrates the promoting
cluster's serving tier from its shipped snapshots before the flip, so
the first post-failover transactions land on resident HBM rows.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils.log import DEFAULT_LOGGER
from .multicluster import _refresh_domain_tasks, prehydrate_serving

STATUS_SUCCESS = "success"
STATUS_FAILED = "failed"
STATUS_SKIPPED = "skipped"

#: default bounded-drain deadline per batch: long enough for any sane
#: in-flight backlog, short enough that a wedged peer never turns a
#: planned failover into an outage (the degrade path is NDC conflict
#: resolution, which the replicator runs anyway on late arrivals)
DRAIN_DEADLINE_S = 10.0


@dataclass
class DomainFailoverResult:
    domain: str
    status: str
    detail: str = ""
    new_failover_version: Optional[int] = None


@dataclass
class FailoverReport:
    to_cluster: str
    results: List[DomainFailoverResult] = field(default_factory=list)
    #: batches whose replication drain hit the deadline and degraded to
    #: NDC conflict resolution instead of blocking the flip
    drain_degraded: int = 0
    #: pre-flip serving-tier hydration rollup (multicluster.
    #: prehydrate_serving) — None when the promoting box has no snapshots
    prehydration: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return all(r.status != STATUS_FAILED for r in self.results)

    @property
    def succeeded(self) -> int:
        return sum(1 for r in self.results if r.status == STATUS_SUCCESS)


class FailoverManager:
    def __init__(self, clusters) -> None:
        self.clusters = clusters
        self.log = DEFAULT_LOGGER.with_tags(component="failovermanager")

    def _box(self, cluster: str):
        return (self.clusters.active if cluster == "primary"
                else self.clusters.standby)

    def _bounded_drain(self, deadline_s: float) -> bool:
        """Drain both replication directions until quiet or the deadline.
        Returns True when fully drained; False degrades the batch to NDC
        conflict resolution (the standby replicator reconciles whatever
        arrives after the flip via branch selection + version arbitration)
        — a slow peer costs consistency work, never availability."""
        deadline = time.monotonic() + max(0.0, deadline_s)
        proc = getattr(self.clusters, "processor", None)
        if proc is None:
            # wire group: the consumers run inside the service hosts'
            # leader pumps; bound their drain wait with OUR deadline by
            # shadowing the group's timeout for this pass
            saved = self.clusters.DRAIN_TIMEOUT_S
            self.clusters.DRAIN_TIMEOUT_S = max(0.0, deadline_s)
            try:
                self.clusters.replicate_domains()
                self.clusters.replicate()
                self.clusters.replicate_reverse()
                return True
            except TimeoutError:
                return False
            finally:
                self.clusters.DRAIN_TIMEOUT_S = saved
        # incremental passes, not the unbounded replicate() loop: each
        # process_once is one queue page, so the deadline is honored even
        # against a source that keeps publishing
        self.clusters.replicate_domains()
        while time.monotonic() < deadline:
            moved = (proc.process_once()
                     + self.clusters.reverse_processor.process_once())
            if moved == 0:
                return True
        return False

    def _prehydrate(self, box) -> Optional[dict]:
        """Pre-flip serving-tier hydration for either box flavor: an
        in-process Onebox hydrates directly; a WireBox fans the
        admin_prehydrate op to every live host (each hydrates its OWN
        shards — only the leader would see a replicated flip)."""
        if getattr(box, "tpu", None) is not None:
            return prehydrate_serving(box)
        wire = getattr(box, "wire", None)
        if wire is None:
            return None
        rollup = {"considered": 0, "hydrated": 0, "suffix_events": 0,
                  "cold": 0, "young": 0, "stale": 0, "already_resident": 0,
                  "parity_divergence": 0, "hosts": 0}
        for name in sorted(wire.hosts):
            if wire.procs[name].poll() is not None:
                continue
            try:
                rep = wire.admin(name, "admin_prehydrate")
            except Exception:
                continue  # serving tier off (or host mid-restart)
            rollup["hosts"] += 1
            for k, v in rep.items():
                if k in rollup and k != "hosts":
                    rollup[k] += int(v)
        return rollup if rollup["hosts"] else None

    def managed_failover(self, domains: List[str],
                         to_cluster: str = "standby",
                         batch_size: int = 2,
                         drain_deadline_s: float = DRAIN_DEADLINE_S
                         ) -> FailoverReport:
        """Failover workflow body (failovermanager/workflow.go): domains
        process in batches; per domain — drain replication so the target
        is caught up (bounded; a deadline miss degrades to NDC conflict
        resolution rather than blocking), flip the active cluster through
        the ACTIVE side's UpdateDomain (stamping the next failover
        version), stream the flip to the peer, regenerate the new active
        side's tasks, and verify both sides agree. One bad domain never
        aborts the rest. The promoting cluster's serving tier pre-hydrates
        from shipped snapshots ONCE, before any flip."""
        report = FailoverReport(to_cluster=to_cluster)
        try:
            report.prehydration = self._prehydrate(self._box(to_cluster))
        except Exception as exc:
            # hydration is an optimization: a failure costs cold admits
            # on first touch, never the failover itself
            self.log.error("pre-flip hydration failed", error=str(exc))
        for lo in range(0, len(domains), batch_size):
            # ONE bounded replication drain per BATCH — the cost batching
            # amortizes (the reference pages domains for the same reason)
            try:
                if not self._bounded_drain(drain_deadline_s):
                    report.drain_degraded += 1
                    self.log.info(
                        "drain deadline hit; degrading to NDC "
                        "conflict resolution", deadline_s=drain_deadline_s)
            except Exception as exc:
                for name in domains[lo:lo + batch_size]:
                    report.results.append(DomainFailoverResult(
                        name, STATUS_FAILED, f"drain failed: {exc}"))
                continue
            for name in domains[lo:lo + batch_size]:
                report.results.append(self._failover_one(name, to_cluster))
        self.log.info("managed failover finished", to=to_cluster,
                      succeeded=report.succeeded,
                      degraded_drains=report.drain_degraded,
                      failed=sum(1 for r in report.results
                                 if r.status == STATUS_FAILED))
        return report

    def _failover_one(self, name: str,
                      to_cluster: str) -> DomainFailoverResult:
        try:
            current = self.clusters.active.stores.domain.by_name(name)
        except Exception as exc:
            return DomainFailoverResult(name, STATUS_FAILED, str(exc))
        if len(current.clusters) < 2:
            return DomainFailoverResult(name, STATUS_SKIPPED,
                                        "local (single-cluster) domain")
        if current.active_cluster == to_cluster:
            return DomainFailoverResult(name, STATUS_SKIPPED,
                                        f"already active in {to_cluster}")
        try:
            # (the batch loop already drained replication for this batch)
            # flip through the active side's UpdateDomain (validated,
            #    notification-ordered, failover-version advanced)
            source = self._box(current.active_cluster)
            updated = source.frontend.update_domain(
                name, active_cluster=to_cluster)
            # 3. stream the flip to the peer
            self.clusters.replicate_domains()
            # 4. the new active side regenerates outstanding tasks
            #    (standby promotion sweep, task_refresher)
            _refresh_domain_tasks(self._box(to_cluster), name)
            # 5. verify convergence
            for box in (self.clusters.active, self.clusters.standby):
                d = box.stores.domain.by_name(name)
                if d.active_cluster != to_cluster:
                    raise RuntimeError(
                        f"{box.cluster_name} still says active="
                        f"{d.active_cluster}")
            self.log.info("domain failed over", domain=name, to=to_cluster,
                          failover_version=updated.failover_version)
            return DomainFailoverResult(name, STATUS_SUCCESS,
                                        new_failover_version=(
                                            updated.failover_version))
        except Exception as exc:  # per-domain isolation, batcher posture
            self.log.error("domain failover failed", domain=name,
                           error=str(exc))
            return DomainFailoverResult(name, STATUS_FAILED, str(exc))

    def rebalance(self, home_cluster: str = "primary") -> FailoverReport:
        """Rebalance workflow (failovermanager/rebalance.go): move every
        GLOBAL domain whose active cluster is not its home back home."""
        mis_homed = [d.name
                     for d in self.clusters.active.stores.domain.list_domains()
                     if len(d.clusters) > 1 and d.active_cluster != home_cluster]
        return self.managed_failover(mis_homed, to_cluster=home_cluster)
