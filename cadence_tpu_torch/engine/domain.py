"""Domain update/deprecate + attribute validation.

Reference: common/domain/handler.go (UpdateDomain/DeprecateDomain) and
common/domain/attrValidator.go — retention bounds, replication-config
rules (clusters can be added, never removed; the active cluster must be a
member), and the failover-version bump when the active cluster moves.
Updates bump the notification version so caches/watchers can observe
change order (DomainCache refresh contract).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

from .cluster import ClusterMetadata
from .persistence import (
    DOMAIN_STATUS_DEPRECATED,
    DOMAIN_STATUS_REGISTERED,
    DomainInfo,
)

MIN_RETENTION_DAYS = 1  # attrValidator.go minRetentionDays


class DomainValidationError(Exception):
    """attrValidator rejection (BadRequestError in the reference)."""


class DomainNotActiveError(Exception):
    """A global domain's active-cluster API hit a PASSIVE cluster
    (types.DomainNotActiveError): callers should retry against the
    active cluster — or go through the cluster redirection frontend,
    which forwards for them (engine/redirection.py)."""

    def __init__(self, domain: str, active_cluster: str,
                 current_cluster: str) -> None:
        super().__init__(
            f"domain {domain} is active in {active_cluster!r}, not "
            f"{current_cluster!r}")
        self.domain = domain
        self.active_cluster = active_cluster
        self.current_cluster = current_cluster

    def __reduce__(self):
        # pickle-safe across the wire: default exception reduction passes
        # self.args (the formatted message) to __init__, whose signature
        # is the three fields — reconstruct from those instead
        return (DomainNotActiveError,
                (self.domain, self.active_cluster, self.current_cluster))


def require_active(info, local_cluster: str) -> None:
    """Active-cluster gate for mutating APIs on GLOBAL domains
    (historyEngine's domain-active check). Local (single-cluster)
    domains are always active wherever they live."""
    if len(info.clusters) > 1 and info.active_cluster != local_cluster:
        raise DomainNotActiveError(info.name, info.active_cluster,
                                   local_cluster)


def validate_retention(retention_days: int) -> None:
    if retention_days < MIN_RETENTION_DAYS:
        raise DomainValidationError(
            f"retention {retention_days}d below minimum "
            f"{MIN_RETENTION_DAYS}d (attrValidator.go)")


def validate_cluster_change(info: DomainInfo,
                            clusters: Optional[Sequence[str]],
                            active_cluster: Optional[str],
                            meta: ClusterMetadata) -> None:
    new_clusters = tuple(clusters) if clusters is not None else info.clusters
    if not new_clusters:
        raise DomainValidationError("domain must have at least one cluster")
    for c in new_clusters:
        if c not in meta.cluster_names:
            raise DomainValidationError(
                f"cluster {c!r} not in the cluster group {meta.cluster_names}")
    removed = set(info.clusters) - set(new_clusters)
    if removed:
        # validateDomainReplicationConfigClustersDoesNotRemove
        raise DomainValidationError(
            f"clusters can only be added, not removed (removing {sorted(removed)})")
    target_active = (active_cluster if active_cluster is not None
                     else info.active_cluster)
    if target_active not in new_clusters:
        raise DomainValidationError(
            f"active cluster {target_active!r} is not in {new_clusters}")


def update_domain(stores, name: str, *, local_cluster: str,
                  meta: Optional[ClusterMetadata] = None,
                  retention_days: Optional[int] = None,
                  description: Optional[str] = None,
                  clusters: Optional[Sequence[str]] = None,
                  active_cluster: Optional[str] = None,
                  history_archival_uri: Optional[str] = None) -> DomainInfo:
    """UpdateDomain (workflowHandler.go:386 → domain/handler.go): validate,
    apply, bump notification version; moving the active cluster is a
    FAILOVER and advances the failover version to the target's next slot
    (so events written after the update stamp the new version — the NDC
    ordering contract)."""
    meta = meta or ClusterMetadata()
    info = stores.domain.by_name(name)
    if info.status == DOMAIN_STATUS_DEPRECATED:
        raise DomainValidationError(f"domain {name} is deprecated")
    if retention_days is not None:
        validate_retention(retention_days)
    if clusters is not None or active_cluster is not None:
        # replication-config rules apply only when the config changes: a
        # description-only update must not re-litigate an existing cluster
        # set against a different cluster group's metadata
        validate_cluster_change(info, clusters, active_cluster, meta)
    if history_archival_uri:
        from .archival import ArchivalError, archiver_for
        try:
            archiver_for(history_archival_uri)
        except ArchivalError as exc:
            raise DomainValidationError(str(exc))

    updated = replace(info)
    if retention_days is not None:
        updated.retention_days = retention_days
    if description is not None:
        updated.description = description
    if clusters is not None:
        updated.clusters = tuple(clusters)
    if history_archival_uri is not None:
        updated.history_archival_uri = history_archival_uri
    if active_cluster is not None and active_cluster != info.active_cluster:
        updated.active_cluster = active_cluster
        updated.failover_version = meta.next_failover_version(
            active_cluster, info.failover_version)
        updated.is_active = active_cluster == local_cluster
    updated.notification_version = info.notification_version + 1
    stores.domain.update(updated)
    return updated


def deprecate_domain(stores, name: str) -> DomainInfo:
    """DeprecateDomain: new starts are rejected; running workflows finish
    (domain/handler.go DeprecateDomain)."""
    info = stores.domain.by_name(name)
    updated = replace(info,
                      status=DOMAIN_STATUS_DEPRECATED,
                      notification_version=info.notification_version + 1)
    stores.domain.update(updated)
    return updated


def require_startable(info: DomainInfo) -> None:
    """Starts (incl. signal-with-start's start arm) need a live domain."""
    if info.status != DOMAIN_STATUS_REGISTERED:
        raise DomainValidationError(
            f"domain {info.name} is deprecated; new workflows are rejected")
