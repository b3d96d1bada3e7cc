"""Cluster launcher: real OS processes, one wire, shared fenced store.

Reference: docker/docker-compose*.yml runs the four roles + DB as separate
containers; host/testcluster.go builds the in-process equivalent. This is
the process-level deployment for tests and local clusters:

    cluster = launch(num_hosts=2)      # store server + N service hosts
    fe = cluster.frontend(0)           # any host's frontend, over TCP
    fe.register_domain("d")
    fe.start_workflow_execution(...)
    cluster.kill_host(1)               # SIGKILL; TTL drops it from the
                                       # ring; survivors steal its shards

Every control-plane byte crosses real sockets; fenced writes evaluate in
the store-server process, so range-ID fencing holds across hosts.

Every process runs its device work on the one device `launch` names: None
means the card, and a service host that finds no card exits at boot, so
`launch` raises rather than hand out a cluster that serves from the CPU;
the CPU is used only when the caller names it. A serving cluster on the
card builds the kernel library once, before any host starts.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Tuple

from .client import _Pool
from .wire import call


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class FrontendClient:
    """Frontend over the wire: any method of engine/frontend.Frontend.

    Retries ShardOwnershipLostError with backoff — the retryable-client
    tier (client/frontend wrappers): shard movement mid-request is a
    ROUTINE transient in a live cluster (steal, flap, re-acquire), and the
    fence guarantees a retry lands on a valid owner or fails honestly.
    ServiceBusy (a breaker shedding somewhere downstream) and
    TransientStoreError (injected pre-apply, never partially committed)
    are retried the same way; breaker-open on THIS client's own target
    surfaces as a typed ServiceBusy once retries exhaust, so callers
    degrade instead of queueing behind a dead host.

    Caveat (same as the pre-existing ConnectionRefusedError retry): a
    ServiceBusy can fire AFTER a mutation partially applied on the
    serving host (create committed, then a forward hit an open breaker),
    so a retried start may surface WorkflowAlreadyStartedError — callers
    treat that as success (the run is fully usable with history-first
    ordering; see tests/test_faults.py)."""

    RETRIES = 8
    BACKOFF_S = 0.25

    def __init__(self, address: Tuple[str, int]) -> None:
        self.address = address
        self._pool = _Pool(address)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        pool = self._pool

        def invoke(*args, **kwargs):
            from ..engine.controller import ShardNotOwnedError
            from ..engine.faults import TransientStoreError
            from ..engine.persistence import ShardOwnershipLostError
            from ..utils.circuitbreaker import CircuitOpenError, ServiceBusy

            # ConnectionRefusedError: an outbound hop inside the serving
            # host hit a dead peer before the ring noticed — nothing was
            # applied (the connect failed), so retrying is safe
            last = None
            for attempt in range(self.RETRIES):
                try:
                    return pool.call(("frontend", method, args, kwargs))
                except (ShardOwnershipLostError, ShardNotOwnedError,
                        ConnectionRefusedError, ServiceBusy,
                        TransientStoreError) as exc:
                    last = exc
                    time.sleep(self.BACKOFF_S * (attempt + 1))
                except CircuitOpenError as exc:
                    # this client's own breaker shed the call: back off for
                    # the breaker's reset window, then probe again
                    last = ServiceBusy(str(exc))
                    time.sleep(self.BACKOFF_S * (attempt + 1))
            raise last

        return invoke


class Cluster:
    def __init__(self, store_port: int, hosts: Dict[str, int],
                 procs: Dict[str, subprocess.Popen],
                 store_proc: subprocess.Popen,
                 http_ports: Dict[str, int] = None,
                 spawn_host=None, wal: str = "",
                 store_cmd=None, store_env=None) -> None:
        self.store_port = store_port
        #: WAL path of the store server ("" = in-memory): a killed
        #: region's store can relaunch from it for post-mortem recovery
        self.wal = wal
        self.hosts = hosts          # name → port
        self.procs = procs          # name → process
        self.store_proc = store_proc
        #: name → HTTP scrape port (/metrics, /health, /traces)
        self.http_ports = dict(http_ports or {})
        #: launch()'s host-spawn closure (same store, same knobs) — the
        #: planned-rebalance seam: add_host grows the ring mid-life and
        #: the losing hosts migrate their moving shards' resident state
        self._spawn_host = spawn_host
        #: exact store-server invocation (argv + env) — kill_store /
        #: relaunch_store replay it so a WAL-backed store can SIGKILL and
        #: recover on the SAME port mid-campaign (gen/cluster_chaos.py)
        self._store_cmd = list(store_cmd) if store_cmd else None
        self._store_env = dict(store_env) if store_env else None

    def frontend(self, index_or_name) -> FrontendClient:
        name = (index_or_name if isinstance(index_or_name, str)
                else sorted(self.hosts)[index_or_name])
        return FrontendClient(("127.0.0.1", self.hosts[name]))

    def ping(self, name: str):
        return call(("127.0.0.1", self.hosts[name]), ("ping",), timeout=5)

    def admin(self, name: str, op: str, *args, timeout: float = 30):
        """One admin wire op against a host (admin_metrics,
        admin_cluster, admin_drain, ...)."""
        return call(("127.0.0.1", self.hosts[name]), (op,) + args,
                    timeout=timeout)

    def add_host(self, name: str = "") -> str:
        """Planned rebalance: spawn one more service host against the
        same store server and wait until every live ring converges on
        the grown membership (the losing hosts' shard release — and
        their resident-state out-migration — happens on their own beat
        threads as the ring change lands). Returns the new host name."""
        if self._spawn_host is None:
            raise RuntimeError("this cluster was not built by launch()")
        name = name or f"host-{len(self.hosts)}"
        if name in self.hosts:
            raise ValueError(f"host {name!r} already exists")
        port, http_port, proc = self._spawn_host(name)
        self.hosts[name] = port
        self.http_ports[name] = http_port
        self.procs[name] = proc
        _wait_listening(port, proc)
        want = {n for n in self.hosts if self.procs[n].poll() is None}
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            views = []
            for n in sorted(want):
                try:
                    views.append(set(self.ping(n)[3]))
                except Exception:
                    views.append(set())
            if all(v >= want for v in views):
                return name
            time.sleep(0.05)
        raise TimeoutError(f"ring never converged after adding {name}")

    def owned_shards(self) -> Dict[str, List[int]]:
        out = {}
        for name in self.hosts:
            if self.procs[name].poll() is None:
                try:
                    out[name] = self.ping(name)[2]
                except Exception:
                    out[name] = []
        return out

    def kill_host(self, name: str, sig: int = signal.SIGKILL) -> None:
        self.procs[name].send_signal(sig)
        if sig == signal.SIGKILL:
            self.procs[name].wait(timeout=10)

    def pause_host(self, name: str) -> None:
        """SIGSTOP: the host stops beating but believes it is alive — the
        classic partitioned-owner scenario the range fence exists for."""
        self.procs[name].send_signal(signal.SIGSTOP)

    def resume_host(self, name: str) -> None:
        self.procs[name].send_signal(signal.SIGCONT)

    def kill_store(self) -> None:
        """SIGKILL the store-server process mid-traffic. Every host call
        fails retryably until relaunch_store(); only meaningful with a
        durable WAL (an in-memory store's state dies with it)."""
        if self.store_proc.poll() is None:
            self.store_proc.kill()
            self.store_proc.wait(timeout=10)

    def relaunch_store(self) -> None:
        """Respawn the store server with its original argv/env on the
        SAME port: boot recovery replays the WAL it was killed with
        (rpc/storeserver.serve → engine/durability.recover_stores), so
        hosts' pooled connections redial and the fleet resumes. The
        caller fscks `self.wal` BEFORE calling this when it wants the
        recovery gated clean (the campaign oracle does)."""
        if self._store_cmd is None:
            raise RuntimeError("this cluster was not built by launch()")
        if self.store_proc.poll() is None:
            raise RuntimeError("store server still running")
        self.store_proc = subprocess.Popen(self._store_cmd,
                                           env=self._store_env)
        _wait_listening(self.store_port, self.store_proc)

    # -- asymmetric partitions (rpc/chaos.PartitionTable over the wire) ----

    def _endpoint(self, dst: str) -> Tuple[str, int]:
        """"store" or a host name → the (host, port) its dialers use."""
        if dst == "store":
            return ("127.0.0.1", self.store_port)
        return ("127.0.0.1", self.hosts[dst])

    def sever(self, src: str, dst: str) -> dict:
        """Block src's OUTBOUND leg to `dst` ("store" or a host name).
        Asymmetric by construction: dst → src and every other pair keep
        flowing until severed themselves."""
        host, port = self._endpoint(dst)
        return self.admin(src, "admin_partition", "block", host, port)

    def heal(self, src: str, dst: str) -> dict:
        host, port = self._endpoint(dst)
        return self.admin(src, "admin_partition", "heal", host, port)

    def heal_all_partitions(self) -> None:
        """Campaign teardown: clear every live host's partition table so
        the closing gates (checksums, verify_all) read a healed fleet."""
        for name in self.hosts:
            if self.procs[name].poll() is None:
                try:
                    self.admin(name, "admin_partition", "heal_all",
                               timeout=10)
                except Exception:
                    pass

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        if self.store_proc.poll() is None:
            self.store_proc.kill()
        for p in list(self.procs.values()) + [self.store_proc]:
            try:
                p.wait(timeout=10)
            except Exception:
                pass


def _wait_listening(port: int, proc: subprocess.Popen,
                    timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"process exited rc={proc.returncode} before listening")
        try:
            call(("127.0.0.1", port), ("ping",), timeout=2)
            return
        except Exception:
            time.sleep(0.05)
    raise TimeoutError(f"port {port} not serving after {timeout}s")


class WireBox:
    """One wire cluster seen through the FailoverManager/worker 'box'
    duck type: .cluster_name, .frontend, .stores, .route — all backed by
    sockets (the in-process Onebox surface, served remotely)."""

    def __init__(self, name: str, cluster: Cluster) -> None:
        from .client import RemoteCluster, RemoteStores

        self.cluster_name = name
        self.wire = cluster
        self.frontend = cluster.frontend(0)
        self.stores = RemoteStores(("127.0.0.1", cluster.store_port))
        self._remote = RemoteCluster(("127.0.0.1", cluster.store_port))

    def route(self, workflow_id: str):
        return self._remote.engine(workflow_id)

    # -- Onebox pump-surface shims (TaskPoller.drain compatibility): the
    # -- service hosts run their own pump threads, so a client-side pump
    # -- tick is just a short yield to let them progress
    def pump_once(self) -> int:
        time.sleep(0.05)
        return 0

    class _NoBacklog:
        @staticmethod
        def backlog() -> int:
            return 0

    matching = _NoBacklog()


class ClusterGroup:
    """A multi-cluster group of real wire clusters (two store servers,
    N service hosts each; replication/domain/cross-cluster consumers
    poll peers over sockets — the XDC deployment of
    docker-compose-multiclusters + development_xdc_cluster{0,1}.yaml).

    Exposes the same .active/.standby/.replicate* surface the in-process
    ReplicatedClusters offers, so FailoverManager runs against real
    processes unchanged — except replicate() here WAITS for the hosts'
    own pumps to drain (consumers run in the service hosts, not in this
    client)."""

    DRAIN_TIMEOUT_S = 30.0

    def __init__(self, clusters: Dict[str, Cluster]) -> None:
        from ..engine.cluster import ClusterMetadata

        self.clusters = clusters
        self.meta = ClusterMetadata(cluster_names=tuple(sorted(clusters)))
        self.boxes = {name: WireBox(name, c) for name, c in clusters.items()}

    @property
    def active(self) -> WireBox:
        return self.boxes["primary"]

    @property
    def standby(self) -> WireBox:
        return self.boxes["standby"]

    def register_global_domain(self, name: str,
                               retention_days: int = 1) -> str:
        """Register on the active side only; domain replication carries it
        to every peer (worker/replicator). Blocks until the peers have it."""
        domain_id = self.active.frontend.register_domain(
            name, retention_days=retention_days, is_active=True,
            clusters=self.meta.cluster_names, active_cluster="primary",
            failover_version=self.meta.initial_failover_version("primary"))
        deadline = time.monotonic() + self.DRAIN_TIMEOUT_S
        others = [b for n, b in self.boxes.items() if n != "primary"]
        while time.monotonic() < deadline:
            if all(self._has_domain(b, name) for b in others):
                return domain_id
            time.sleep(0.05)
        raise TimeoutError(f"domain {name} never replicated to peers")

    @staticmethod
    def _has_domain(box: WireBox, name: str) -> bool:
        try:
            box.stores.domain.by_name(name)
            return True
        except Exception:
            return False

    # -- drain waits (the hosts' leader pumps do the actual work) ----------

    def _wait_consumed(self, src: str, dst: str, queue: str,
                      ack_key: str) -> None:
        tail = self.boxes[src].stores.queue.size(queue)
        deadline = time.monotonic() + self.DRAIN_TIMEOUT_S
        while time.monotonic() < deadline:
            ack = self.boxes[dst].stores.queue.get_ack(ack_key, dst)
            if ack >= tail:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"{dst} consumed {ack}/{tail} of {src}'s {queue}")

    def replicate(self) -> int:
        from ..engine.replication import REPLICATION_QUEUE

        self._wait_consumed("primary", "standby", REPLICATION_QUEUE,
                            "repl-from:primary")
        return 0

    def replicate_reverse(self) -> int:
        from ..engine.replication import REPLICATION_QUEUE

        self._wait_consumed("standby", "primary", REPLICATION_QUEUE,
                            "repl-from:standby")
        return 0

    def replicate_domains(self) -> int:
        from ..engine.domainrepl import DOMAIN_REPLICATION_QUEUE

        self._wait_consumed("primary", "standby", DOMAIN_REPLICATION_QUEUE,
                            "domainrepl-from:primary")
        self._wait_consumed("standby", "primary", DOMAIN_REPLICATION_QUEUE,
                            "domainrepl-from:standby")
        return 0

    def stop(self) -> None:
        for c in self.clusters.values():
            c.stop()


def _role_env(env_extra, env_per_role, role: str, generic: str):
    """Compose one process's environment overlay: `env_extra` (every
    process) + the generic-role overlay ("host"/"store") + the exact
    role-name overlay (e.g. "host-1", "primary-host-0"), later layers
    winning. Loadgen uses the per-role seam to hand EACH host its own
    quota knobs (CADENCE_TPU_QUOTAS — a cluster RPS budget split across
    hosts because every host's token buckets are local)."""
    env = dict(env_extra or {})
    per = env_per_role or {}
    env.update(per.get(generic, {}))
    env.update(per.get(role, {}))
    return env


def process_env() -> Dict[str, str]:
    """The environment every spawned process starts from: this one, with
    the repository root on PYTHONPATH so `-m cadence_tpu_torch...`
    resolves from any working directory."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def device_name(device) -> str:
    """The `--device` argument of a spawned process: the device named,
    or "cuda" (the card) for None."""
    return "cuda" if device is None else str(device)


def _serving_on(base_env, env_extra, env_per_role) -> bool:
    """Whether the launch's hosts run the serving tier."""
    from ..engine.serving import ENABLE_ENV

    env = dict(base_env, **_role_env(env_extra, env_per_role, "host", "host"))
    return env.get(ENABLE_ENV, "0") in ("1", "true", "on")


def launch_group(cluster_names=("primary", "standby"), num_hosts: int = 2,
                 num_shards: int = 8, hb_interval: float = 0.15,
                 ttl: float = 3.0, env_extra=None,
                 env_per_role=None, wal_dir: str = "",
                 device=None) -> ClusterGroup:
    """Launch a multi-cluster group: per cluster one store server + N
    service hosts, every host configured with the peer clusters' store
    addresses (the cluster-group config) so its leader runs the inbound
    replication/domain/cross-cluster consumers against real sockets.

    `env_extra` lands in EVERY spawned process; `env_per_role` overlays
    it per role: keys are "store", "host", or an exact process name —
    here host names carry the cluster prefix ("primary-host-0").
    `wal_dir` gives each region's store server a WAL under it (one file
    per cluster name) — the region-failover scenario relaunches a
    kill -9'd region's store from its WAL for post-mortem verification.
    Every process of every region runs on `device` (None: the card)."""
    store_ports = {name: free_port() for name in cluster_names}
    clusters: Dict[str, Cluster] = {}
    try:
        for name in cluster_names:
            peers = [f"{p}=127.0.0.1:{store_ports[p]}"
                     for p in cluster_names if p != name]
            clusters[name] = launch(
                num_hosts=num_hosts, num_shards=num_shards,
                hb_interval=hb_interval, ttl=ttl, cluster_name=name,
                store_port=store_ports[name], peer_specs=peers,
                wal=(os.path.join(wal_dir, f"{name}-store.wal")
                     if wal_dir else ""),
                env_extra=env_extra, env_per_role=env_per_role,
                device=device)
    except Exception:
        for c in clusters.values():
            c.stop()
        raise
    return ClusterGroup(clusters)


def launch(num_hosts: int = 2, num_shards: int = 8, wal: str = "",
           hb_interval: float = 0.15, ttl: float = 3.0,
           cluster_name: str = "primary", store_port: int = 0,
           peer_specs=(), env_extra=None, env_per_role=None,
           device=None) -> Cluster:
    """Spawn the store server + `num_hosts` service hosts as OS processes.
    The TTL must comfortably exceed worst-case heartbeat jitter (a
    GIL-starved beat thread on a loaded host): a too-tight TTL makes the
    failure detector flap, and every flap is a spurious steal — safe
    (fencing holds) but churny. Test-sized here; production stretches both.
    `env_extra` lands in every spawned process — the chaos soak sets
    CADENCE_TPU_CHAOS / CADENCE_TPU_STORE_FAULTS through it.
    `env_per_role` overlays env_extra for individual processes: keys are
    "store", "host" (every service host), or an exact host name
    ("host-0"; with peer_specs, "<cluster>-host-0") — the loadgen hands
    each host its own CADENCE_TPU_QUOTAS knobs through this seam.
    `device` is where every process runs its device work (None: the
    card; a host without one exits at boot and this raises)."""
    base_env = process_env()
    device_arg = device_name(device)
    if device_arg.startswith("cuda") and _serving_on(
            base_env, env_extra, env_per_role):
        # one build before the hosts start, so their boot loads finish
        # instead of racing one nvcc each into the same build directory
        from ..ops import _build
        _build.build()

    store_port = store_port or free_port()
    store_cmd = [sys.executable, "-m", "cadence_tpu_torch.rpc.storeserver",
                 "--port", str(store_port), "--device", device_arg]
    if wal:
        store_cmd += ["--wal", wal]
    store_env = dict(base_env)
    store_env.update(_role_env(env_extra, env_per_role, "store", "store"))
    store_proc = subprocess.Popen(store_cmd, env=store_env)
    _wait_listening(store_port, store_proc)

    hosts: Dict[str, int] = {}
    procs: Dict[str, subprocess.Popen] = {}
    http_ports: Dict[str, int] = {}

    def spawn_host(name: str):
        """One service-host process against this cluster's store (shared
        by launch's initial fleet and Cluster.add_host's rebalance)."""
        port = free_port()
        http_port = free_port()
        cmd = [sys.executable, "-m", "cadence_tpu_torch.rpc.server",
               "--name", name, "--port", str(port),
               "--store", f"127.0.0.1:{store_port}",
               "--num-shards", str(num_shards),
               "--hb-interval", str(hb_interval), "--ttl", str(ttl),
               "--cluster-name", cluster_name,
               "--http-port", str(http_port), "--device", device_arg]
        for spec in peer_specs:
            cmd += ["--peer", spec]
        host_env = dict(base_env)
        host_env.update(_role_env(env_extra, env_per_role, name, "host"))
        return port, http_port, subprocess.Popen(cmd, env=host_env)

    for i in range(num_hosts):
        name = f"{cluster_name}-host-{i}" if peer_specs else f"host-{i}"
        hosts[name], http_ports[name], procs[name] = spawn_host(name)
    try:
        for name, port in hosts.items():
            _wait_listening(port, procs[name])
    except BaseException:
        # a host that never came up (one without a card exits at boot)
        # takes down the store server and every host spawned beside it:
        # the caller gets no Cluster to stop
        Cluster(store_port, hosts, procs, store_proc).stop()
        raise
    # let every host's RING converge on the full peer set before handing
    # the cluster out (a host still on a single-member ring believes it
    # owns every shard → spurious steal churn on first requests)
    deadline = time.monotonic() + 10
    want = set(hosts)
    while time.monotonic() < deadline:
        views = []
        for name, port in hosts.items():
            try:
                ping = call(("127.0.0.1", port), ("ping",), timeout=2)
                views.append(set(ping[3]))
            except Exception:
                views.append(set())
        if all(v >= want for v in views):
            break
        time.sleep(0.05)
    return Cluster(store_port, hosts, procs, store_proc,
                   http_ports=http_ports, spawn_host=spawn_host, wal=wal,
                   store_cmd=store_cmd, store_env=store_env)
