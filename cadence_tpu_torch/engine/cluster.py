"""Cluster-group metadata: failover versions.

Reference: common/cluster/metadata.go — each cluster in a group has an
initial failover version; a domain's failover version encodes which cluster
is active (version % increment == cluster's initial version), and failover
bumps it to the target cluster's next slot. Event versions are stamped from
the domain failover version, which is how the NDC layer orders histories
across clusters (version histories).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class ClusterMetadata:
    cluster_names: tuple = ("primary", "standby")
    initial_versions: Dict[str, int] = field(
        default_factory=lambda: {"primary": 1, "standby": 2})
    failover_version_increment: int = 10

    def initial_failover_version(self, cluster: str) -> int:
        return self.initial_versions[cluster]

    def cluster_for_version(self, version: int) -> str:
        rem = version % self.failover_version_increment
        for name, init in self.initial_versions.items():
            if init % self.failover_version_increment == rem:
                return name
        raise ValueError(f"no cluster for failover version {version}")

    def next_failover_version(self, target_cluster: str,
                              current_version: int) -> int:
        """cluster/metadata.go GetNextFailoverVersion: always advance by a
        full increment past the current version's window (Go truncated
        division, not Python floor division)."""
        init = self.initial_versions[target_cluster]
        inc = self.failover_version_increment
        windows = int((current_version - init) / inc)  # trunc toward zero
        return init + (windows + 1) * inc
