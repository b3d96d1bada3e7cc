"""Dynamic config: runtime knobs consumed as live closures.

Reference: common/dynamicconfig — ~350 typed constants
(dynamicconfig/constants.go) resolved through a Client
(clientInterface.go:40) with domain/shard/task-list filters, consumed as
closures (service/history/config/config.go) so updates apply without
restarts. This module keeps the same shape: named keys with defaults,
filterable overrides, `set()` for live updates, and `*_property` accessors
returning closures.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple


# -- knob names (dynamicconfig/constants.go analog; the knobs in use) -------

# kernel / payload capacities (PayloadLayout; SURVEY §7 "measured, never
# silent" — these bound the device tables, overflow falls back to oracle)
KEY_MAX_ACTIVITIES = "kernel.maxPendingActivities"
KEY_MAX_TIMERS = "kernel.maxPendingTimers"
KEY_MAX_CHILDREN = "kernel.maxPendingChildren"
KEY_MAX_REQUEST_CANCELS = "kernel.maxPendingRequestCancels"
KEY_MAX_SIGNALS = "kernel.maxPendingSignals"
KEY_MAX_VERSION_HISTORY_ITEMS = "kernel.maxVersionHistoryItems"
KEY_MAX_BRANCHES = "kernel.maxVersionHistoryBranches"
# engine / queues
KEY_QUEUE_BATCH_SIZE = "history.queueBatchSize"
# multi-level processing queues (queue/split_policy.go): a domain whose
# observed transfer backlog in one shard exceeds the threshold splits to
# its own level (own ack, own reads) so it cannot starve siblings
KEY_QUEUE_SPLIT_THRESHOLD = "history.queueSplitThreshold"
KEY_QUEUE_MAX_LEVEL = "history.queueMaxLevel"
# matching scale-out (matchingEngine.getAllPartitions / forwarder.go)
KEY_MATCHING_NUM_PARTITIONS = "matching.numTasklistPartitions"
KEY_RETENTION_DAYS_DEFAULT = "domain.defaultRetentionDays"
# frontend quotas (quotas/ratelimiter.go seat)
KEY_FRONTEND_RPS = "frontend.rps"
KEY_FRONTEND_DOMAIN_RPS = "frontend.domainRPS"
KEY_FRONTEND_BURST = "frontend.burst"
# size/count limits (decision/checker.go blob checks, size_limit_test.go
# history growth enforcement); 0 disables a limit
KEY_BLOB_SIZE_LIMIT_WARN = "limit.blobSizeWarn"
KEY_BLOB_SIZE_LIMIT_ERROR = "limit.blobSizeError"
KEY_HISTORY_COUNT_LIMIT_WARN = "limit.historyCountWarn"
KEY_HISTORY_COUNT_LIMIT_ERROR = "limit.historyCountError"
KEY_HISTORY_SIZE_LIMIT_WARN = "limit.historySizeWarn"
KEY_HISTORY_SIZE_LIMIT_ERROR = "limit.historySizeError"
# pagination: the default/maximum page any list-shaped API returns
KEY_HISTORY_PAGE_SIZE = "limit.historyPageSize"
KEY_VISIBILITY_PAGE_SIZE = "limit.visibilityPageSize"
# rpc resilience tier (common/backoff retry policies + outbound breakers):
# client retry policy for cross-process calls ...
KEY_RPC_RETRY_MAX_ATTEMPTS = "rpc.retryMaxAttempts"
KEY_RPC_RETRY_INIT_INTERVAL_MS = "rpc.retryInitIntervalMs"
KEY_RPC_RETRY_MAX_INTERVAL_MS = "rpc.retryMaxIntervalMs"
KEY_RPC_RETRY_EXPIRATION_S = "rpc.retryExpirationSeconds"
# ... per-target circuit breakers ...
KEY_RPC_BREAKER_FAILURE_THRESHOLD = "rpc.breakerFailureThreshold"
KEY_RPC_BREAKER_RESET_TIMEOUT_S = "rpc.breakerResetSeconds"
# ... and the wire chaos spec ("drop=0.05,sever=0.03,delay=0.1,seed=7";
# empty = no chaos; the CADENCE_TPU_CHAOS env var is the cross-process
# equivalent for subprocess clusters)
KEY_WIRE_CHAOS = "rpc.wireChaos"

#: durability crashpoint spec ("" = disarmed), e.g.
#: "site=wal.append.after-write,hit=3,mode=kill" (engine/crashpoints.py)
KEY_CRASHPOINT = "durability.crashpoint"

_DEFAULTS: Dict[str, Any] = {
    KEY_MAX_ACTIVITIES: 16,
    KEY_MAX_TIMERS: 16,
    KEY_MAX_CHILDREN: 8,
    KEY_MAX_REQUEST_CANCELS: 8,
    KEY_MAX_SIGNALS: 8,
    KEY_MAX_VERSION_HISTORY_ITEMS: 8,
    KEY_MAX_BRANCHES: 2,
    KEY_QUEUE_BATCH_SIZE: 100,
    KEY_QUEUE_SPLIT_THRESHOLD: 500,
    KEY_QUEUE_MAX_LEVEL: 2,
    KEY_MATCHING_NUM_PARTITIONS: 1,
    KEY_RETENTION_DAYS_DEFAULT: 1,
    KEY_FRONTEND_RPS: 0,          # 0 = unlimited
    KEY_FRONTEND_DOMAIN_RPS: 0,
    KEY_FRONTEND_BURST: 0,        # 0 = burst == rps
    KEY_BLOB_SIZE_LIMIT_WARN: 256 * 1024,        # the reference's defaults
    KEY_BLOB_SIZE_LIMIT_ERROR: 2 * 1024 * 1024,
    KEY_HISTORY_COUNT_LIMIT_WARN: 150_000,
    KEY_HISTORY_COUNT_LIMIT_ERROR: 200_000,
    KEY_HISTORY_SIZE_LIMIT_WARN: 50 * 1024 * 1024,
    KEY_HISTORY_SIZE_LIMIT_ERROR: 200 * 1024 * 1024,
    KEY_HISTORY_PAGE_SIZE: 1000,
    KEY_VISIBILITY_PAGE_SIZE: 1000,
    KEY_RPC_RETRY_MAX_ATTEMPTS: 6,
    KEY_RPC_RETRY_INIT_INTERVAL_MS: 50,
    KEY_RPC_RETRY_MAX_INTERVAL_MS: 1000,
    KEY_RPC_RETRY_EXPIRATION_S: 30,
    KEY_RPC_BREAKER_FAILURE_THRESHOLD: 5,
    KEY_RPC_BREAKER_RESET_TIMEOUT_S: 5,
    KEY_WIRE_CHAOS: "",
    KEY_CRASHPOINT: "",
}


class DynamicConfig:
    """Key → value store with filterable overrides and live updates."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, Any] = dict(overrides or {})
        #: (key, ("domain", domain_name)) → value etc.
        self._filtered: Dict[Tuple[str, Tuple[str, str]], Any] = {}

    def get(self, key: str, default: Any = None, *,
            domain: Optional[str] = None) -> Any:
        """Most-specific wins: domain filter → global override → built-in
        default → caller default (dynamicconfig filter precedence)."""
        with self._lock:
            if domain is not None:
                v = self._filtered.get((key, ("domain", domain)))
                if v is not None:
                    return v
            if key in self._values:
                return self._values[key]
        if key in _DEFAULTS:
            return _DEFAULTS[key]
        return default

    def set(self, key: str, value: Any, *,
            domain: Optional[str] = None) -> None:
        """Live update (file_based_client poll / configstore write analog)."""
        with self._lock:
            if domain is not None:
                self._filtered[(key, ("domain", domain))] = value
            else:
                self._values[key] = value

    def int_property(self, key: str, default: int = 0
                     ) -> Callable[..., int]:
        """A closure the consumer calls at use time, so updates apply live
        (service/history/config/config.go pattern)."""
        def prop(domain: Optional[str] = None) -> int:
            return int(self.get(key, default, domain=domain))
        return prop

    # -- kernel layout -----------------------------------------------------

    def payload_layout(self):
        """The kernel capacities as a PayloadLayout — tunable without code
        edits."""
        from ..core.checksum import PayloadLayout
        return PayloadLayout(
            max_version_history_items=int(self.get(KEY_MAX_VERSION_HISTORY_ITEMS)),
            max_activities=int(self.get(KEY_MAX_ACTIVITIES)),
            max_timers=int(self.get(KEY_MAX_TIMERS)),
            max_children=int(self.get(KEY_MAX_CHILDREN)),
            max_request_cancels=int(self.get(KEY_MAX_REQUEST_CANCELS)),
            max_signals=int(self.get(KEY_MAX_SIGNALS)),
            max_branches=int(self.get(KEY_MAX_BRANCHES)),
        )
