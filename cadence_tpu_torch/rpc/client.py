"""Client proxies: stores, engines, and matching across the wire.

Reference: client/ wraps every inter-service call (history peer resolver
by workflowID→shard→host, matching by task list) behind typed clients;
here the same seams are generic method-forwarding proxies over wire.py —
the duck typing that lets the whole engine tier run unmodified against a
remote store server (the persistence managers' interface IS the contract,
dataManagerInterfaces.go analog).

Resilience tier (common/backoff retry policies + outbound middleware):
every `_Pool` call consults a per-target CIRCUIT BREAKER (open targets
shed immediately as CircuitOpenError), carries the caller's DEADLINE
budget on the envelope, and retries SAFE failures under an exponential
full-jitter `RetryPolicy`:

- chaos-injected transport faults (`ChaosError`) — guaranteed
  nothing-was-applied by construction (rpc/chaos.py), always retryable;
- `TransientStoreError` — the store-tier injector raises BEFORE the
  target method runs (engine/faults.py), always retryable;
- connection/timeout failures — retried only for ops classified
  IDEMPOTENT (reads, membership, pings, polls whose matched tasks the
  server requeues on a dead socket); a lost response on a mutation is
  surfaced to the caller, who owns the resend decision.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from ..engine.faults import TransientStoreError
from ..utils import deadline as deadline_mod
from ..utils import tracing
from ..utils.backoff import NO_BACKOFF, RetryPolicy
from ..utils.circuitbreaker import (
    DEFAULT_BREAKERS,
    BreakerRegistry,
    CircuitOpenError,
)
from ..utils.deadline import DeadlineExceeded
from .chaos import ChaosError
from .wire import Connection, WireError

#: every sub-store a Stores bundle exposes (persistence.Stores fields)
SUBSTORES = ("shard", "history", "task", "domain", "visibility", "queue",
             "shard_tasks", "execution", "snapshot")

#: metrics scope for the client resilience tier
SCOPE_RPC_CLIENT = "rpc.client"

#: store-method prefixes that are read-only → safe to retry even after a
#: lost response (nothing to double-apply)
_READ_PREFIXES = ("get", "list", "by_", "as_", "read", "peek", "size",
                  "describe", "count", "scan", "current", "history_host")

#: top-level ops that are idempotent end to end: membership upserts,
#: liveness, and matching polls (a matched task delivered to a dead
#: socket is requeued by the serving side — rpc/server._MATCHING_POLLS)
_IDEMPOTENT_OPS = {"hb", "peers", "ping", "admin_metrics"}
_IDEMPOTENT_MATCHING = {"poll_and_wait_decision", "poll_and_wait_activity",
                        "poll_for_decision_task", "poll_for_activity_task",
                        "describe_task_list"}


def _is_idempotent(request) -> bool:
    """May this request be blindly re-sent after a LOST RESPONSE?"""
    if not isinstance(request, tuple) or not request:
        return False
    op = request[0]
    if op in _IDEMPOTENT_OPS:
        return True
    if op == "store" and len(request) >= 3:
        return str(request[2]).startswith(_READ_PREFIXES)
    if op == "matching" and len(request) >= 2:
        return request[1] in _IDEMPOTENT_MATCHING
    return False


def _default_retry_policy() -> RetryPolicy:
    return RetryPolicy(init_interval_s=0.05, max_interval_s=1.0,
                       backoff_coefficient=2.0, max_attempts=6,
                       expiration_s=30.0)


def retry_policy_from_config(config) -> RetryPolicy:
    """Build the client policy from dynamicconfig knobs (rpc.retry*) —
    ServiceHost wires one shared policy through every outbound proxy."""
    from ..utils import dynamicconfig as dc
    return RetryPolicy(
        init_interval_s=float(config.get(dc.KEY_RPC_RETRY_INIT_INTERVAL_MS))
        / 1000.0,
        max_interval_s=float(config.get(dc.KEY_RPC_RETRY_MAX_INTERVAL_MS))
        / 1000.0,
        max_attempts=int(config.get(dc.KEY_RPC_RETRY_MAX_ATTEMPTS)),
        expiration_s=float(config.get(dc.KEY_RPC_RETRY_EXPIRATION_S)))


class _RemoteSubStore:
    def __init__(self, pool: "_Pool", sub: str) -> None:
        self._pool = pool
        self._sub = sub

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        pool, sub = self._pool, self._sub

        def invoke(*args, **kwargs):
            return pool.call(("store", sub, method, args, kwargs))

        invoke.__name__ = f"{sub}.{method}"
        return invoke


class _Pool:
    """Per-thread connections to one address (engine transactions issue
    several store calls in sequence; a per-thread socket keeps them
    pipelined without cross-talk), fronted by the shared per-target
    circuit breaker and the retry policy described in the module doc."""

    def __init__(self, address: Tuple[str, int],
                 metrics=None,
                 breakers: Optional[BreakerRegistry] = None,
                 retry_policy: Optional[RetryPolicy] = None) -> None:
        self.address = address
        self.metrics = metrics
        self.breakers = breakers if breakers is not None else DEFAULT_BREAKERS
        self.retry_policy = (retry_policy if retry_policy is not None
                             else _default_retry_policy())
        #: resolved once — the target never changes, and for_target takes
        #: the registry-wide lock (hot path: several store calls per
        #: engine transaction across every handler thread)
        self._breaker = self.breakers.for_target(address)
        self._local = threading.local()

    # -- connection lifecycle ---------------------------------------------

    def _connection(self) -> Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = Connection(self.address)
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        """Stale-connection poisoning fix: after ANY transport failure the
        per-thread Connection is discarded, so the next call dials fresh
        instead of reusing an object wedged on a dead peer (peer restart
        between calls must not poison the thread's slot)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _metrics(self):
        if self.metrics is not None:
            return self.metrics
        from ..utils.metrics import DEFAULT_REGISTRY
        return DEFAULT_REGISTRY

    # -- the resilient call path ------------------------------------------

    def call(self, request):
        breaker = self._breaker
        idempotent = _is_idempotent(request)
        attempt = 0
        started = time.monotonic()
        while True:
            if not breaker.allow():
                self._metrics().inc(SCOPE_RPC_CLIENT, "breaker-rejected")
                raise CircuitOpenError(
                    f"circuit open for {self.address[0]}:{self.address[1]}")
            try:
                result = self._call_once(request)
            except DeadlineExceeded:
                # budget exhaustion is the CALLER's timeout, not evidence
                # against the peer: neither a breaker failure nor retried —
                # but a held half-open probe slot must be released, or the
                # breaker wedges HALF_OPEN forever
                breaker.on_probe_abandoned()
                self._metrics().inc(SCOPE_RPC_CLIENT, "deadline-expired")
                raise
            except BaseException as exc:
                retryable = self._classify(exc, idempotent)
                # a LOCAL failure (encode raised before any byte left this
                # process) says NOTHING about the peer: charge neither way,
                # only release a held half-open probe slot
                if getattr(exc, "_wire_local", False):
                    breaker.on_probe_abandoned()
                    raise
                # a RELAYED error (the peer answered ("err", exc) — its OWN
                # outbound hop may have failed) is a healthy peer talking:
                # it must not open THIS target's breaker or drop a live
                # socket, even when the payload is ConnectionError-shaped
                relayed = getattr(exc, "_wire_relayed", False)
                if (isinstance(exc, (ConnectionError, OSError, WireError))
                        and not relayed):
                    # a transport failure with the caller's deadline budget
                    # EXHAUSTED is the same case as DeadlineExceeded above,
                    # just detected mid-flight: the socket timeout was
                    # clamped to the remaining budget (wire.effective_
                    # timeout), so a healthy peer at normal latency still
                    # times out. Charging the breaker here would let a few
                    # tight-deadline callers open it against a healthy
                    # target for everyone. Drop the socket (its stream
                    # state is unknown) but stay breaker-neutral.
                    current = deadline_mod.current()
                    if current is not None and current.remaining() <= 0:
                        breaker.on_probe_abandoned()
                    else:
                        breaker.on_failure()
                    self._drop_connection()
                else:
                    # a typed SERVICE error is a healthy peer answering
                    breaker.on_success()
                if not retryable:
                    raise
                sleep_s = self.retry_policy.next_interval(
                    attempt, time.monotonic() - started)
                if sleep_s == NO_BACKOFF:
                    raise
                current = deadline_mod.current()
                if current is not None and current.remaining() <= sleep_s:
                    raise  # the budget cannot absorb another attempt
                self._metrics().inc(SCOPE_RPC_CLIENT, "retries")
                attempt += 1
                time.sleep(sleep_s)
                continue
            breaker.on_success()
            return result

    def _call_once(self, request):
        # the calling thread's active span and deadline budget ride the
        # envelope, so the serving side parents its span on ours AND
        # rejects work whose budget is already gone (cross-hop stitching
        # + cross-hop deadlines on the same seam)
        conn = self._connection()
        try:
            return conn.call(
                deadline_mod.inject(tracing.inject(request)))
        except (ConnectionError, OSError, WireError) as exc:
            # a RELAYED ConnectionError-shaped payload arrived on a
            # perfectly live socket (the peer answered): keep it pooled
            if not getattr(exc, "_wire_relayed", False):
                self._drop_connection()
            raise

    @staticmethod
    def _classify(exc: BaseException, idempotent: bool) -> bool:
        """Is this failure safe to retry for THIS request?

        The dangerous case is a LOST RESPONSE: the op may have passed its
        commit point, so blind resend double-applies — hence transport
        faults retry only for idempotent requests. A typed injected fault
        is different even when RELAYED from a deeper hop: the failing op
        RAISED, so its transaction never committed, and re-executing the
        whole mutation heals through the commit-point design (history
        writes are id-stable overwrites, the state update is a fenced
        CAS last — tests/test_faults.py torn-tail semantics; the chaos
        soak's byte-identical checksums are the empirical check)."""
        if isinstance(exc, (ChaosError, TransientStoreError)):
            return True
        if isinstance(exc, CircuitOpenError):
            return False
        if isinstance(exc, (ConnectionError, OSError, WireError)):
            return idempotent
        return False


class RemoteStores:
    """Duck-typed `Stores` whose sub-stores forward over the wire. The
    authoritative locks, CAS conditions, and range-ID fences all evaluate
    in the store-server process — which is what makes fencing hold across
    HOSTS, exactly as the reference's DB-evaluated conditional writes do."""

    def __init__(self, address: Tuple[str, int], metrics=None,
                 breakers: Optional[BreakerRegistry] = None,
                 retry_policy: Optional[RetryPolicy] = None) -> None:
        self.address = address
        self._pool = _Pool(address, metrics=metrics, breakers=breakers,
                           retry_policy=retry_policy)
        for sub in SUBSTORES:
            setattr(self, sub, _RemoteSubStore(self._pool, sub))

    def heartbeat(self, name: str, port: int,
                  address: str = "127.0.0.1") -> None:
        self._pool.call(("hb", name, port, address))

    def peers(self, ttl: float):
        return self._pool.call(("peers", ttl))

    def ping(self) -> str:
        return self._pool.call(("ping",))


class _RemoteMethod:
    """A dotted method path on a remote engine: callable, and further
    attribute access extends the path (`engine.queries.attach(...)` →
    path "queries.attach" resolved by getattr-chain on the owning host)."""

    def __init__(self, pool: "_Pool", workflow_id: str, path: str) -> None:
        self._pool = pool
        self._workflow_id = workflow_id
        self._path = path

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _RemoteMethod(self._pool, self._workflow_id,
                             f"{self._path}.{name}")

    def __call__(self, *args, **kwargs):
        return self._pool.call(("engine", self._workflow_id, self._path,
                                args, kwargs))


class RemoteEngine:
    """History-engine proxy: forwards any engine method for workflows the
    local host does not own to the owning host (the client/history
    peer-resolver redirect, SURVEY §3.1 PROCESS BOUNDARY)."""

    def __init__(self, address: Tuple[str, int], workflow_id: str,
                 metrics=None,
                 breakers: Optional[BreakerRegistry] = None,
                 retry_policy: Optional[RetryPolicy] = None) -> None:
        self._pool = _Pool(address, metrics=metrics, breakers=breakers,
                           retry_policy=retry_policy)
        self._workflow_id = workflow_id

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        return _RemoteMethod(self._pool, self._workflow_id, method)


class _RoutedMethod:
    """Dotted method path issued as an engine_routed op (any live host of
    the TARGET CLUSTER forwards to its ring's owner)."""

    def __init__(self, cluster: "RemoteCluster", workflow_id: str,
                 path: str) -> None:
        self._cluster = cluster
        self._workflow_id = workflow_id
        self._path = path

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _RoutedMethod(self._cluster, self._workflow_id,
                             f"{self._path}.{name}")

    def __call__(self, *args, **kwargs):
        return self._cluster._call_routed(self._workflow_id, self._path,
                                          args, kwargs)


class RemoteCluster:
    """A PEER CLUSTER reached through its store server: live hosts are
    discovered from the peer's heartbeat table (no static host config —
    the cluster-group yaml's rpcAddress plus membership, collapsed), and
    engine calls enter through any live host's engine_routed op.

    Reference: common/rpc/outbounds.go crossDCCaller + cluster-group
    config (config/development_xdc_cluster0.yaml:71-94)."""

    #: rounds of peer-list refresh before giving up on the whole cluster
    MAX_ROUNDS = 4

    def __init__(self, store_address: Tuple[str, int],
                 peer_ttl: float = 3.0, metrics=None,
                 breakers: Optional[BreakerRegistry] = None,
                 retry_policy: Optional[RetryPolicy] = None) -> None:
        self.store_address = store_address
        self.metrics = metrics
        self.breakers = breakers if breakers is not None else DEFAULT_BREAKERS
        self.retry_policy = retry_policy
        self.stores = RemoteStores(store_address, metrics=metrics,
                                   breakers=breakers,
                                   retry_policy=retry_policy)
        self.peer_ttl = peer_ttl
        self._host_pools: dict = {}
        #: jittered backoff BETWEEN peer-list refresh rounds (the old code
        #: hammered a one-shot snapshot with zero delay); max_attempts ==
        #: MAX_ROUNDS so the LAST round raises immediately instead of
        #: sleeping a dead backoff first
        self._round_policy = RetryPolicy(init_interval_s=0.05,
                                         max_interval_s=0.5,
                                         max_attempts=self.MAX_ROUNDS)

    def live_host_pools(self):
        """One _Pool per live peer host, preferring already-open pools.
        Peers dial the ADVERTISED host from the heartbeat table (old
        2-tuple entries imply loopback)."""
        peers = self.stores.peers(self.peer_ttl)
        pools = []
        for entry in peers:
            key = ((entry[2], entry[1]) if len(entry) > 2
                   else ("127.0.0.1", entry[1]))
            if key not in self._host_pools:
                self._host_pools[key] = _Pool(
                    key, metrics=self.metrics, breakers=self.breakers,
                    retry_policy=self.retry_policy)
            pools.append(self._host_pools[key])
        return pools

    def _call_routed(self, workflow_id: str, path: str, args, kwargs):
        """Try every live host; on a whole-round failure RE-FETCH the
        heartbeat peer list (hosts that died since the last snapshot drop
        out, restarts re-appear) and back off with jitter before the next
        round. Breaker-open hosts are skipped — a dead entry host sheds
        instantly instead of eating a connect timeout per call."""
        last: Exception = ConnectionError(
            f"no live hosts behind store {self.store_address}")
        started = time.monotonic()
        for round_no in range(self.MAX_ROUNDS):
            try:
                pools = self.live_host_pools()
            except (ConnectionError, OSError) as exc:
                pools, last = [], exc
            for pool in pools:
                try:
                    return pool.call(("engine_routed", workflow_id, path,
                                      args, kwargs))
                except CircuitOpenError as exc:
                    last = exc  # shed: next host, no wire time burned
                except (ConnectionError, OSError) as exc:
                    # entry host died between heartbeat and call: next one
                    last = exc
            sleep_s = self._round_policy.next_interval(
                round_no, time.monotonic() - started)
            if sleep_s == NO_BACKOFF:
                break
            current = deadline_mod.current()
            if current is not None and current.remaining() <= sleep_s:
                break
            time.sleep(sleep_s)
        raise last

    def engine(self, workflow_id: str) -> "_RoutedMethod":
        """An engine proxy routed via any live host of this cluster."""

        class _Root:
            def __getattr__(_self, method: str):
                if method.startswith("_"):
                    raise AttributeError(method)
                return _RoutedMethod(self, workflow_id, method)

        return _Root()


class RemoteMatching:
    """Matching proxy for task lists owned by another host. Long polls
    travel as a server-side blocking op (the gRPC long-poll analog), so no
    live ParkedPoll object ever crosses the wire. Shares the process's
    breaker registry, so a dead matching owner sheds instantly."""

    def __init__(self, address: Tuple[str, int], metrics=None,
                 breakers: Optional[BreakerRegistry] = None,
                 retry_policy: Optional[RetryPolicy] = None) -> None:
        self._pool = _Pool(address, metrics=metrics, breakers=breakers,
                           retry_policy=retry_policy)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        pool = self._pool

        def invoke(*args, **kwargs):
            return pool.call(("matching", method, args, kwargs))

        return invoke
