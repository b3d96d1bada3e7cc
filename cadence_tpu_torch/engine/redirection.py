"""Cluster redirection: route active-cluster APIs to the active cluster.

Reference: service/frontend/clusterRedirectionHandler.go +
clusterRedirectionPolicy.go — for GLOBAL domains, the frontend of a
passive cluster forwards the domain's active-cluster APIs (start,
signal, signal-with-start, cancel, terminate, reset) to the active
cluster instead of failing with DomainNotActive; reads and worker APIs
serve locally. Policies: "noop" (never forward — callers see the
DomainNotActiveError) and "selected-apis-forwarding" (the default
forwarding set).
"""
from __future__ import annotations

from typing import Callable, Dict

#: the selected-apis forwarding set (clusterRedirectionPolicy.go
#: selectedAPIsForwardingRedirectionPolicyAPIAllowlist)
FORWARDED_APIS = frozenset({
    "start_workflow_execution",
    "signal_workflow_execution",
    "signal_with_start_workflow_execution",
    "request_cancel_workflow_execution",
    "terminate_workflow_execution",
    "reset_workflow_execution",
})

POLICY_NOOP = "noop"
POLICY_SELECTED_APIS = "selected-apis-forwarding"


class ClusterRedirectionFrontend:
    """Wraps a cluster's frontend; forwards the active-cluster APIs of
    global domains whose active cluster is elsewhere."""

    def __init__(self, local, remotes: Dict[str, object],
                 local_cluster: str,
                 policy: str = POLICY_SELECTED_APIS) -> None:
        if policy not in (POLICY_NOOP, POLICY_SELECTED_APIS):
            raise ValueError(f"unknown redirection policy {policy!r}")
        self.local = local
        self.remotes = dict(remotes)
        self.local_cluster = local_cluster
        self.policy = policy

    def _target(self, domain: str):
        """The frontend that should serve this domain's active APIs."""
        info = self.local.stores.domain.by_name(domain)
        if (len(info.clusters) > 1  # global domain
                and info.active_cluster != self.local_cluster
                and info.active_cluster in self.remotes):
            return self.remotes[info.active_cluster]
        return self.local

    def __getattr__(self, method: str) -> Callable:
        if method.startswith("_"):
            raise AttributeError(method)
        local_impl = getattr(self.local, method)
        if self.policy == POLICY_NOOP or method not in FORWARDED_APIS:
            return local_impl

        def forwarding(domain, *args, **kwargs):
            return getattr(self._target(domain), method)(domain, *args,
                                                         **kwargs)

        return forwarding
