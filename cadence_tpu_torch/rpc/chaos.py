"""Wire-level chaos: drop, delay, sever — and asymmetric partitions.

Reference: the store tier already has `engine/faults.py`
(persistenceErrorInjectionClients.go analog — errors injected BEFORE the
target method runs). This module is the same discipline one layer down,
at the TRANSPORT: the client-side request path of every wire call can be

- DELAYED  (a jittered sleep before the frame is written — latency
  injection; bounded, so deadline budgets absorb it),
- DROPPED  (the connection is closed before ANY request byte is sent —
  the classic connect-then-die peer),
- SEVERED  (a PARTIAL frame is written, then the socket is torn down —
  the peer sees a mid-stream FIN and discards the torn frame).

All three are injected on the REQUEST leg only, before the server can
have dispatched anything: a torn frame never unpickles (rpc/wire.py
`_read_exact` raises "peer closed mid-frame" and the handler drops the
connection), so an injected fault ALWAYS means "nothing was applied".
That is the property that makes `ChaosError` universally retryable and
lets the chaos soak demand byte-identical mutable-state checksums
against a fault-free run — at-least-once delivery with zero divergence.

Configuration (cross-process, so subprocess clusters inherit it):

    CADENCE_TPU_CHAOS="drop=0.05,sever=0.03,delay=0.1,delay_ms=10,seed=7"

or programmatically via `install(WireChaos(...))` / `uninstall()`; the
same spec string can ride dynamicconfig (KEY_WIRE_CHAOS) into a
ServiceHost. Seeded RNG keeps runs reproducible.

The PARTITION table (`PartitionTable`, below) is the deterministic
sibling of the probabilistic injector: a per-peer-pair block list
consulted on every outbound dial/call, so a campaign can sever
host A → store while store → A and B → store stay healthy — a real
ASYMMETRIC partition, because each process owns its own table. Blocked
calls raise ChaosError before any byte leaves the process (the same
nothing-was-applied guarantee), and pairs heal on schedule via the
`admin_partition` wire op (rpc/server.py) or `heal`/`heal_all` here.
Boot-time blocks ride CADENCE_TPU_PARTITION="block=host:port;host:port".
"""
from __future__ import annotations

import os
import random
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.metrics import DEFAULT_REGISTRY

#: registry scope for partition-table counters (per-process; a host's
#: /metrics therefore shows the partitions IT enforces as dialer)
SCOPE_PARTITION = "rpc.partition"
M_PART_BLOCKED_SENDS = "blocked-sends"
M_PART_BLOCKS = "blocks"
M_PART_HEALS = "heals"
M_PART_ACTIVE = "active-pairs"


class ChaosError(ConnectionError):
    """An injected transport fault. Guaranteed nothing-was-applied (the
    request never reached a dispatchable frame), so every client tier may
    retry it regardless of the op's idempotency."""


class WireChaos:
    """Seeded fault decider + injector for the client request path.

    Probabilities are per-call and independent; `delay_ms` is the MAX
    latency injected (actual delay is uniform in [0, delay_ms])."""

    def __init__(self, drop: float = 0.0, sever: float = 0.0,
                 delay: float = 0.0, delay_ms: float = 10.0,
                 seed: int = 0) -> None:
        self.drop = drop
        self.sever = sever
        self.delay = delay
        self.delay_ms = delay_ms
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected_drops = 0
        self.injected_severs = 0
        self.injected_delays = 0

    def _roll(self) -> tuple:
        with self._lock:
            return (self._rng.random(), self._rng.random(),
                    self._rng.random(), self._rng.random())

    def before_send(self, sock: socket.socket,
                    header: bytes, body: bytes) -> None:
        """Called by the wire just before a request frame is written.
        Raises ChaosError (after closing `sock`) for drop/sever; sleeps
        for delay; returns normally to let the real send proceed."""
        r_delay, r_jitter, r_drop, r_sever = self._roll()
        if self.delay > 0 and r_delay < self.delay:
            with self._lock:
                self.injected_delays += 1
            time.sleep(r_jitter * self.delay_ms / 1000.0)
        if self.drop > 0 and r_drop < self.drop:
            with self._lock:
                self.injected_drops += 1
            _teardown(sock)
            raise ChaosError("chaos: connection dropped before send")
        if self.sever > 0 and r_sever < self.sever:
            with self._lock:
                self.injected_severs += 1
            # mid-stream sever: leak a partial frame so the peer's
            # _read_exact sees a torn body, then hard-close
            try:
                sock.sendall(header + body[: max(1, len(body) // 2)])
            except OSError:
                pass
            _teardown(sock)
            raise ChaosError("chaos: connection severed mid-frame")

    def counts(self) -> dict:
        with self._lock:
            return {"drops": self.injected_drops,
                    "severs": self.injected_severs,
                    "delays": self.injected_delays}


def _teardown(sock: socket.socket) -> None:
    """RST-ish teardown: no graceful shutdown handshake."""
    try:
        sock.close()
    except OSError:
        pass


# -- process-wide installation ----------------------------------------------

_ACTIVE: Optional[WireChaos] = None
_ENV = "CADENCE_TPU_CHAOS"
_LOADED_ENV = False
_LOAD_LOCK = threading.Lock()


def parse_kv_spec(spec: str, casts: dict) -> dict:
    """Shared "k=v,k=v" spec parser for the fault-injection env vars
    (CADENCE_TPU_CHAOS here, CADENCE_TPU_STORE_FAULTS in storeserver).
    Unknown keys raise — a typo'd spec silently doing nothing is worse
    than failing loudly at boot."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        cast = casts.get(key)
        if cast is None:
            raise ValueError(f"unknown knob {key!r} in {spec!r}")
        out[key] = cast(value.strip())
    return out


def parse_spec(spec: str) -> WireChaos:
    """"drop=0.05,sever=0.03,delay=0.1,delay_ms=10,seed=7" → WireChaos."""
    return WireChaos(**parse_kv_spec(
        spec, {"drop": float, "sever": float, "delay": float,
               "delay_ms": float, "seed": int}))


def install(chaos: Optional[WireChaos]) -> None:
    """Programmatic installation (tests); None uninstalls."""
    global _ACTIVE, _LOADED_ENV
    _ACTIVE = chaos
    _LOADED_ENV = True  # explicit choice overrides the env default


def uninstall() -> None:
    install(None)


def active() -> Optional[WireChaos]:
    """The process's chaos injector, lazily loaded from CADENCE_TPU_CHAOS
    on first use (subprocess cluster hosts pick it up with zero plumbing).
    Fast path: one global read when chaos was never configured."""
    global _ACTIVE, _LOADED_ENV
    if not _LOADED_ENV:
        with _LOAD_LOCK:
            if not _LOADED_ENV:
                spec = os.environ.get(_ENV, "")
                if spec:
                    _ACTIVE = parse_spec(spec)
                _LOADED_ENV = True
    return _ACTIVE


# -- asymmetric partitions --------------------------------------------------

#: endpoint key: (host, port); host "*" matches any host at that port
Endpoint = Tuple[str, int]


class PartitionTable:
    """Per-peer-pair partition state for the CURRENT process as dialer.

    Severing is directional by construction: blocking (host, port) here
    stops THIS process from reaching that endpoint, while the reverse
    direction is governed by the peer's own table — so A↔store and A↔B
    can be cut independently (and independently of B↔store), which is
    exactly the asymmetry real switch/iptables partitions produce.

    `check` raises ChaosError BEFORE any connect/send, preserving the
    nothing-was-applied contract that makes the error retryable; healing
    a pair immediately restores traffic (pooled sockets were torn down
    by the failed calls and redial on the next attempt)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blocked: set = set()
        self.blocked_sends = 0
        #: counter sink — a ServiceHost rebinds this to ITS registry at
        #: boot so the partitions a host enforces show on its /metrics
        self.registry = DEFAULT_REGISTRY

    @staticmethod
    def _key(host: str, port: int) -> Endpoint:
        return (str(host), int(port))

    def block(self, host: str, port: int) -> None:
        with self._lock:
            self._blocked.add(self._key(host, port))
            n = len(self._blocked)
        self.registry.inc(SCOPE_PARTITION, M_PART_BLOCKS)
        self.registry.gauge(SCOPE_PARTITION, M_PART_ACTIVE, n)

    def heal(self, host: str, port: int) -> None:
        with self._lock:
            self._blocked.discard(self._key(host, port))
            n = len(self._blocked)
        self.registry.inc(SCOPE_PARTITION, M_PART_HEALS)
        self.registry.gauge(SCOPE_PARTITION, M_PART_ACTIVE, n)

    def heal_all(self) -> None:
        with self._lock:
            had = len(self._blocked)
            self._blocked.clear()
        if had:
            self.registry.inc(SCOPE_PARTITION, M_PART_HEALS, had)
        self.registry.gauge(SCOPE_PARTITION, M_PART_ACTIVE, 0)

    def pairs(self) -> List[Endpoint]:
        with self._lock:
            return sorted(self._blocked)

    def is_blocked(self, address: Endpoint) -> bool:
        host, port = address[0], int(address[1])
        with self._lock:
            if not self._blocked:
                return False
            return ((host, port) in self._blocked
                    or ("*", port) in self._blocked)

    def check(self, address: Endpoint) -> None:
        """Raise ChaosError iff `address` is severed from this process.
        Called by the wire before every dial AND every pooled send, so a
        partition installed mid-stream cuts an already-open connection's
        next call too."""
        if self.is_blocked(address):
            with self._lock:
                self.blocked_sends += 1
            self.registry.inc(SCOPE_PARTITION, M_PART_BLOCKED_SENDS)
            raise ChaosError(
                f"partition: {address[0]}:{address[1]} unreachable")

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"blocked_sends": self.blocked_sends,
                    "active_pairs": len(self._blocked)}


_PARTITIONS: Optional[PartitionTable] = None
_PARTITION_ENV = "CADENCE_TPU_PARTITION"
_PARTITIONS_LOADED = False


def _parse_endpoint(text: str) -> Endpoint:
    """"host:port" or bare "port" (host wildcard) → endpoint key."""
    text = text.strip()
    host, sep, port = text.rpartition(":")
    if not sep:
        return ("*", int(text))
    return (host or "*", int(port))


def parse_partition_spec(spec: str) -> PartitionTable:
    """"block=127.0.0.1:7001;7002" → PartitionTable (";"-separated
    endpoints inside the value; parse_kv_spec owns the k=v framing so a
    typo'd knob still fails loudly)."""
    kv = parse_kv_spec(spec, {"block": str})
    table = PartitionTable()
    for part in kv.get("block", "").split(";"):
        if part.strip():
            table.block(*_parse_endpoint(part))
    return table


def partitions() -> PartitionTable:
    """The process's partition table, created on first use (admin ops
    need somewhere to install blocks even when the env set none)."""
    global _PARTITIONS, _PARTITIONS_LOADED
    with _LOAD_LOCK:
        _load_partitions_env_locked()
        if _PARTITIONS is None:
            _PARTITIONS = PartitionTable()
        return _PARTITIONS


def active_partitions() -> Optional[PartitionTable]:
    """Fast-path accessor for the wire: None (one global read) when no
    partition was ever configured in this process."""
    global _PARTITIONS
    if not _PARTITIONS_LOADED:
        with _LOAD_LOCK:
            _load_partitions_env_locked()
    return _PARTITIONS


def _load_partitions_env_locked() -> None:
    global _PARTITIONS, _PARTITIONS_LOADED
    if not _PARTITIONS_LOADED:
        spec = os.environ.get(_PARTITION_ENV, "")
        if spec:
            _PARTITIONS = parse_partition_spec(spec)
        _PARTITIONS_LOADED = True


def check_partition(address: Endpoint) -> None:
    """Wire hook: raise ChaosError when this process is partitioned from
    `address`. No-op (single global read) when no table exists."""
    table = active_partitions()
    if table is not None:
        table.check(address)
