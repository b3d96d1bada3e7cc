"""Consistent-hashring membership.

Reference: common/membership/hashring.go:50-70 (ring over a PeerProvider,
replica points per member) and resolver.go:47-75 — Lookup(service, key)
routes workflow IDs to hosts. The ring rebuilds on membership change and
the shard controller reacts by acquiring/releasing shards
(shard/controller.go:381 acquireShards).
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Callable, Dict, List, Optional

REPLICA_POINTS = 100  # hashring replicaPoints analog


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hashring with replica points per member."""

    def __init__(self, members: Optional[List[str]] = None) -> None:
        self._lock = threading.Lock()
        self._members: List[str] = []
        self._ring: List[int] = []
        self._owners: Dict[int, str] = {}
        self._listeners: List[Callable[[], None]] = []
        #: monotonic change counter: bumps on every effective add/remove,
        #: so "did the ring move while I looked away?" is one int compare
        #: (chaos campaigns use it as the membership-flap witness)
        self._generation = 0
        if members:
            for m in members:
                self.add_member(m)

    def _rebuild(self) -> None:
        self._ring = []
        self._owners = {}
        for m in self._members:
            for i in range(REPLICA_POINTS):
                h = _hash(f"{m}#{i}")
                self._owners[h] = m
                self._ring.append(h)
        self._ring.sort()

    def add_member(self, member: str) -> None:
        with self._lock:
            if member in self._members:
                return
            self._members.append(member)
            self._generation += 1
            self._rebuild()
        self._notify()

    def remove_member(self, member: str) -> None:
        with self._lock:
            if member not in self._members:
                return
            self._members.remove(member)
            self._generation += 1
            self._rebuild()
        self._notify()

    def members(self) -> List[str]:
        with self._lock:
            return list(self._members)

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def lookup(self, key: str) -> str:
        """Owner of `key` (resolver.go:169 LookupByAddress path)."""
        with self._lock:
            if not self._ring:
                raise RuntimeError("hashring has no members")
            h = _hash(key)
            idx = bisect.bisect_right(self._ring, h)
            if idx == len(self._ring):
                idx = 0
            return self._owners[self._ring[idx]]

    def subscribe(self, listener: Callable[[], None]) -> None:
        with self._lock:
            self._listeners.append(listener)

    def unsubscribe(self, listener: Callable[[], None]) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def _notify(self) -> None:
        for fn in list(self._listeners):
            fn()


def shard_id_for_workflow(workflow_id: str, num_shards: int) -> int:
    """workflowID → shardID (common/config/config.go:170-173 uses
    farm.Fingerprint32 % numShards; any stable hash serves the contract)."""
    return _hash("wf:" + workflow_id) % num_shards
