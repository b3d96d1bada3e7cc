"""Fleet chaos campaigns: seeded fault schedules against a REAL cluster.

`gen/interleave.py` proves the single-process serving tier converges to
byte-identical state under crashpoint kills and injected faults. This
module is the same discipline one deployment tier up: a seeded CAMPAIGN
drives a live workload schedule against a multi-host wire cluster
(`rpc/cluster.launch` — real OS processes, real sockets) while a
campaign planner fires FLEET-level faults between workload ops:

- real SIGKILL of service-host processes mid-traffic (survivors steal
  the dead host's shards after the heartbeat TTL);
- real SIGKILL of the store-server process, its WAL fsck'd clean and
  the store relaunched on the same port (boot recovery replays the WAL
  under the hosts' feet — `rpc/storeserver.serve`);
- ASYMMETRIC network partitions (rpc/chaos.PartitionTable through the
  `admin_partition` wire op): host A → store severed while store → A
  and B → store keep flowing, healed on schedule. A host partitioned
  from the store stops heartbeating, so the partition doubles as a
  membership drop — and the heal as a rejoin + shard steal-back;
- membership FLAPS (SIGSTOP until the TTL evicts the host from every
  survivor's ring, then SIGCONT): the restored host re-acquires its
  stolen shards through the range fence, witnessed by the
  `controller/fenced-evictions` counter.

The acceptance oracle is the chaos-soak bar applied fleet-wide: final
per-workflow payload checksums byte-identical to a fault-free run of
the SAME seed, `wal fsck` clean on every killed store's recovered WAL,
zero divergence on every `tpu.serving`/`tpu.migration`/replication
parity counter across all hosts, and a closing `verify_all` over the
remote store (both regions when `regions=2`). What makes byte-identity
achievable under real kills: every workload op is retried to
CONVERGENCE with deterministic request ids (signal dedup, benign
already-started), and decisions dispatch from STORE truth
(`_complete_once`, the `gen/interleave._direct_decision` seat) rather
than from matching's lossy in-memory queues — so an op's history effect
is a function of replicated state, never of which process died when.
Storm profiles (`profile="storm"`: reset/cron/retry churn) gate on
self-consistency only (fsck + parity + verify_all): their terminal
state is legitimately timing-dependent.

On failure, `gen/shrink.py`'s ddmin generalizes to campaign schedules:
`shrink_campaign` reduces the combined workload+fault op list to a
1-minimal reproducer replayable from `(seed, kept_indices)` alone
(`CampaignShrinkReport.reproduce`), and the scenario dumps every live
process's flight-recorder ring beside the failing doc.

Every process a campaign launches, and its closing verify, runs on the
campaign's `device`: None means the card, and a host without one exits
at boot, so the launch raises.
"""
from __future__ import annotations

import json
import os
import random
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..core.checksum import DEFAULT_LAYOUT, crc32_of_row, payload_row
from ..core.enums import (
    EMPTY_EVENT_ID,
    DecisionType,
    EventType,
    WorkflowState,
)
from ..core.events import RetryPolicy
from ..engine import walcheck
from ..engine.controller import ShardNotOwnedError
from ..engine.faults import TransientStoreError
from ..engine.history_engine import Decision, InvalidRequestError, TaskToken
from ..engine.persistence import (
    EntityNotExistsError,
    ShardOwnershipLostError,
    WorkflowAlreadyStartedError,
)
from ..engine.tpu_engine import TPUReplayEngine
from ..rpc.chaos import ChaosError
from ..rpc.client import RemoteCluster, RemoteStores
from ..rpc.cluster import Cluster, launch, launch_group
from ..rpc.wire import call as wire_call
from ..utils.circuitbreaker import CircuitOpenError, ServiceBusy

DOMAIN = "fleet-chaos"
TL = "fleet-tl"
WF_PREFIX = "fcwf"

#: workload verbs a campaign schedule may carry
WORKLOAD_KINDS = ("start", "signal", "complete", "sws", "reset",
                  "terminate")
#: fleet-fault verbs the planner interleaves into the schedule
FAULT_KINDS = ("kill_host", "kill_store", "partition", "heal_partition",
               "flap_begin", "flap_end")

PROFILES = ("steady", "storm")

TRAJECTORY_SCHEMA = "cadence-tpu/fleetchaos-trajectory/v1"
_TRAJ_PATTERN = "CHAOS_r{:02d}.json"


@dataclass(frozen=True)
class CampaignOp:
    """One schedule slot: a workload verb or a fleet fault. Host targets
    are INDICES into the sorted host-name list (index 0 — the driver's
    stable frontend — is never a fault victim), so the same campaign
    replays against any naming scheme (plain and region-prefixed)."""

    kind: str
    wf: int = -1        # workload target (WF_PREFIX-<wf>)
    seq: int = -1       # per-workflow sequence (signal/sws naming)
    host: int = -1      # fault victim index (1-based into sorted hosts)
    peer: str = ""      # partition far end: "store" or "host:<i>"
    flag: str = ""      # start/complete modifier: "cron"/"retry"/"fail"

    def as_dict(self) -> dict:
        out = {"kind": self.kind}
        for key in ("wf", "seq", "host"):
            if getattr(self, key) >= 0:
                out[key] = getattr(self, key)
        for key in ("peer", "flag"):
            if getattr(self, key):
                out[key] = getattr(self, key)
        return out


def build_campaign(seed: int, num_workflows: int = 6,
                   signals_per_wf: int = 2, num_hosts: int = 3,
                   kills: int = 1, store_kills: int = 0,
                   partitions: int = 1, flaps: int = 0,
                   profile: str = "steady") -> List[CampaignOp]:
    """The seeded campaign grammar: per-workflow op chains (start →
    signals → store-truth complete, plus reset/cron/retry churn in the
    storm profile) randomly merged into one schedule, then fleet faults
    inserted at seeded positions — flaps in the first half, partitions
    cut in the middle third and healed before the kill band, store
    kills mid-schedule, host kills in the final third (so every fault
    fires MID-traffic and a partitioned host is healed before it can be
    killed). Deterministic: same arguments ⇒ same op list, which is
    what lets a `CampaignShrinkReport` replay from coordinates alone."""
    if profile not in PROFILES:
        raise ValueError(f"unknown campaign profile {profile!r}")
    if num_hosts < 2 and (kills or partitions or flaps):
        raise ValueError("fleet faults need at least 2 hosts "
                         "(host index 0 is the protected coordinator)")
    kills = min(kills, num_hosts - 1)
    rng = random.Random(f"fleet:{seed}:{profile}:{num_workflows}:"
                        f"{signals_per_wf}:{num_hosts}")

    chains: List[List[CampaignOp]] = []
    for w in range(num_workflows):
        flag = ""
        if profile == "storm":
            flag = rng.choice(("", "", "", "cron", "retry"))
        chain = [CampaignOp("start", wf=w, flag=flag)]
        chain += [CampaignOp("signal", wf=w, seq=s)
                  for s in range(signals_per_wf)]
        chain.append(CampaignOp(
            "complete", wf=w, flag=("fail" if flag == "retry" else flag)))
        if profile == "storm" and flag == "":
            extra = rng.choice(("reset", "terminate", "sws", ""))
            if extra == "sws":
                chain.append(CampaignOp("sws", wf=w, seq=signals_per_wf))
            elif extra:
                chain.append(CampaignOp(extra, wf=w))
        chains.append(chain)

    ops: List[CampaignOp] = []
    live = [c for c in chains if c]
    while live:
        chain = rng.choice(live)
        ops.append(chain.pop(0))
        live = [c for c in chains if c]

    n = len(ops)
    victims = list(range(1, num_hosts))
    kill_victims = victims[-kills:] if kills else []
    flap_victims = [v for v in victims if v not in kill_victims]
    if flaps and not flap_victims:
        raise ValueError("flaps need a non-coordinator host that "
                         "survives every kill")

    inserts = []  # (workload index, tiebreak, fault op)
    for f in range(flaps):
        victim = flap_victims[f % len(flap_victims)]
        begin = rng.randrange(max(1, n // 6), max(2, n // 3))
        end = rng.randrange(max(begin + 1, n // 3), max(begin + 2, n // 2))
        inserts.append((begin, 0, CampaignOp("flap_begin", host=victim)))
        inserts.append((end, 1, CampaignOp("flap_end", host=victim)))
    for p in range(partitions):
        src = victims[p % len(victims)]
        peers = ["store"] + [f"host:{i}" for i in range(num_hosts)
                             if i != src]
        peer = rng.choice(peers)
        cut = rng.randrange(max(1, n // 3), max(2, n // 2))
        heal = rng.randrange(max(cut + 1, n // 2),
                             max(cut + 2, 2 * n // 3))
        inserts.append((cut, 2, CampaignOp("partition", host=src,
                                           peer=peer)))
        inserts.append((heal, 3, CampaignOp("heal_partition", host=src,
                                            peer=peer)))
    for _ in range(store_kills):
        inserts.append((rng.randrange(max(1, n // 2), max(2, 2 * n // 3)),
                        4, CampaignOp("kill_store")))
    for victim in kill_victims:
        inserts.append((rng.randrange(max(1, 2 * n // 3), max(2, n)),
                        5, CampaignOp("kill_host", host=victim)))

    inserts.sort(key=lambda t: (t[0], t[1]))
    out: List[CampaignOp] = []
    cursor = 0
    for idx, op in enumerate(ops):
        while cursor < len(inserts) and inserts[cursor][0] <= idx:
            out.append(inserts[cursor][2])
            cursor += 1
        out.append(op)
    out.extend(item[2] for item in inserts[cursor:])
    return out


class CampaignDriver:
    """Executes one campaign against a live wire cluster. Workload ops
    retry to convergence through the full fault surface (partitions are
    ChaosError, kills are connection errors, steals are ownership
    errors) with deterministic request ids; fault ops drive the fleet
    (kill/relaunch/sever/heal/flap) and record their witnesses."""

    BENIGN = (WorkflowAlreadyStartedError, InvalidRequestError,
              EntityNotExistsError)
    RETRYABLE = (ChaosError, ConnectionError, OSError, TimeoutError,
                 ServiceBusy, CircuitOpenError, TransientStoreError,
                 ShardOwnershipLostError, ShardNotOwnedError)

    def __init__(self, cluster: Cluster, seed: int, faults: bool = True,
                 max_attempts: int = 80, converge_s: float = 90.0) -> None:
        self.cluster = cluster
        self.seed = seed
        self.faults = faults
        self.max_attempts = max_attempts
        self.converge_s = converge_s
        self.stores = RemoteStores(("127.0.0.1", cluster.store_port))
        self.remote = RemoteCluster(("127.0.0.1", cluster.store_port))
        self.started: List[str] = []
        self.retries = 0
        self.kills = 0
        self.store_kills = 0
        self.partitions_cut = 0
        self.partitions_healed = 0
        self.flaps = 0
        self.skipped: List[str] = []
        self.fsck_reports: List[dict] = []
        self._paused: set = set()
        self._responded: set = set()
        self._failed: set = set()
        self._domain_id: Optional[str] = None

    # -- plumbing ----------------------------------------------------------

    def _host_name(self, index: int) -> str:
        return sorted(self.cluster.hosts)[index]

    def _live_hosts(self) -> List[str]:
        return [name for name in sorted(self.cluster.hosts)
                if self.cluster.procs[name].poll() is None
                and name not in self._paused]

    def _frontend(self):
        live = self._live_hosts()
        if not live:
            raise RuntimeError("campaign has no live host left")
        return self.cluster.frontend(live[0])

    def _domain(self) -> str:
        if self._domain_id is None:
            self._domain_id = self._retrying(
                lambda: self.stores.domain.by_name(DOMAIN).domain_id)
        return self._domain_id

    def _retrying(self, op):
        """Run `op()` to convergence. `op` must be self-contained
        (re-resolves all state per attempt) — the retry-safety contract
        that keeps an op's history effect deterministic under kills."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            if attempt:
                self.retries += 1
                time.sleep(min(1.0, 0.1 * attempt))
            try:
                return op()
            except self.BENIGN:
                return None
            except self.RETRYABLE as exc:
                last = exc
        raise RuntimeError(
            f"campaign op did not converge after {self.max_attempts} "
            f"attempts (last: {type(last).__name__}: {last})")

    def register(self) -> None:
        self._retrying(lambda: self._frontend().register_domain(DOMAIN))

    # -- workload ----------------------------------------------------------

    @staticmethod
    def wf_name(index: int) -> str:
        return f"{WF_PREFIX}-{index}"

    def execute(self, op: CampaignOp) -> None:
        if op.kind in FAULT_KINDS:
            self._exec_fault(op)
        elif op.kind == "start":
            self._start(op)
        elif op.kind == "signal":
            self._signal(op)
        elif op.kind == "complete":
            self._complete(op)
        elif op.kind == "sws":
            self._sws(op)
        elif op.kind == "reset":
            self._reset(op)
        elif op.kind == "terminate":
            self._terminate(op)
        else:
            raise ValueError(f"unknown campaign op {op.kind!r}")

    def _start(self, op: CampaignOp) -> None:
        wf = self.wf_name(op.wf)
        retry = (RetryPolicy(initial_interval_seconds=1,
                             backoff_coefficient=2.0,
                             maximum_interval_seconds=4,
                             maximum_attempts=2)
                 if op.flag == "retry" else None)
        cron = "* * * * *" if op.flag == "cron" else ""
        # 3600s timeouts: no decision/execution timer may fire
        # asynchronously mid-campaign — a timeout event appended by a
        # host's timer pump (not by a driver op) would shift history
        # bytes between the fault-free and chaotic runs
        self._retrying(lambda: self._frontend().start_workflow_execution(
            DOMAIN, wf, "fleet-type", TL, execution_timeout=3600,
            decision_timeout=3600, cron_schedule=cron, retry_policy=retry))
        if wf not in self.started:
            self.started.append(wf)

    def _signal(self, op: CampaignOp) -> None:
        wf = self.wf_name(op.wf)
        self._retrying(
            lambda: self._frontend().signal_workflow_execution(
                DOMAIN, wf, f"sig-{op.seq}",
                request_id=f"fc:{self.seed}:{wf}:{op.seq}"))

    def _sws(self, op: CampaignOp) -> None:
        wf = self.wf_name(op.wf)
        self._retrying(
            lambda: self._frontend().signal_with_start_workflow_execution(
                DOMAIN, wf, f"sws-{op.seq}", "fleet-type", TL,
                execution_timeout=3600, decision_timeout=3600,
                request_id=f"fc-sws:{self.seed}:{wf}:{op.seq}"))
        if wf not in self.started:
            self.started.append(wf)

    def _terminate(self, op: CampaignOp) -> None:
        wf = self.wf_name(op.wf)
        self._retrying(
            lambda: self._frontend().terminate_workflow_execution(
                DOMAIN, wf, reason="fleet-terminate-storm"))

    def _complete(self, op: CampaignOp) -> None:
        """Drive the workflow's current run to completion from STORE
        truth, retried until the close is observable — the convergence
        loop that absorbs the started-but-reply-lost ambiguity a real
        SIGKILL creates (the decision re-dispatches from state)."""
        wf = self.wf_name(op.wf)
        deadline = time.monotonic() + self.converge_s
        while True:
            if self._retrying(lambda: self._complete_once(wf, op.flag)):
                return
            if time.monotonic() > deadline:
                raise RuntimeError(f"{wf} never completed in "
                                   f"{self.converge_s:.0f}s")
            time.sleep(0.2)

    def _complete_once(self, wf: str, flag: str) -> bool:
        domain_id = self._domain()
        if flag == "cron" and wf in self._responded:
            return True  # the cron respawn stays open by design
        try:
            run = self.stores.execution.get_current_run_id(domain_id, wf)
            ms = self.stores.execution.get_workflow(domain_id, wf, run)
        except EntityNotExistsError:
            return True  # shrunk slice without the start op: nothing to do
        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            return True
        if info.decision_schedule_id == EMPTY_EVENT_ID:
            return False  # retry-backoff timer not fired yet
        engine = self.remote.engine(wf)
        if info.decision_started_id > 0:
            token = TaskToken(domain_id=domain_id, workflow_id=wf,
                              run_id=run,
                              schedule_id=info.decision_schedule_id,
                              started_id=info.decision_started_id,
                              attempt=info.decision_attempt)
        else:
            token = engine.record_decision_task_started(
                domain_id, wf, run, info.decision_schedule_id,
                request_id=f"fc-dts:{wf}:{run}:"
                           f"{info.decision_schedule_id}")
        decisions = [Decision(DecisionType.CompleteWorkflowExecution,
                              {"result": b"fleet-done"})]
        if flag == "fail" and wf not in self._failed:
            # the retry-storm arm: fail the FIRST attempt so the
            # workflow retry policy spawns a backoff run
            self._failed.add(wf)
            decisions = [Decision(DecisionType.FailWorkflowExecution,
                                  {"reason": "fleet-retry-storm"})]
        self._frontend().respond_decision_task_completed(token, decisions)
        self._responded.add(wf)
        return False  # loop re-reads state (retry/cron runs continue)

    def _reset(self, op: CampaignOp) -> None:
        """Storm reset: rewind a (typically completed) run to its only
        decision boundary — the new run stays open with a fresh pending
        decision, which the self-consistency gates must absorb."""
        wf = self.wf_name(op.wf)

        def body():
            domain_id = self._domain()
            run = self.stores.execution.get_current_run_id(domain_id, wf)
            events = self.stores.history.read_events(domain_id, wf, run)
            finish = next((e.id for e in events
                           if e.event_type == EventType.DecisionTaskCompleted),
                          None)
            if finish is None:
                return None
            self._frontend().reset_workflow_execution(
                DOMAIN, wf, decision_finish_event_id=finish,
                reason="fleet-reset-storm")

        self._retrying(body)

    # -- fleet faults ------------------------------------------------------

    def _peer_name(self, peer: str) -> str:
        if peer == "store":
            return "store"
        return self._host_name(int(peer.split(":", 1)[1]))

    def _exec_fault(self, op: CampaignOp) -> None:
        if not self.faults:
            return
        if op.kind == "kill_host":
            name = self._host_name(op.host)
            if self.cluster.procs[name].poll() is not None:
                self.skipped.append(f"kill_host:{name}:already-dead")
                return
            self.cluster.kill_host(name)
            self.kills += 1
        elif op.kind == "kill_store":
            self.cluster.kill_store()
            report = walcheck.fsck(self.cluster.wal)
            self.fsck_reports.append({
                "at": f"store-kill-{self.store_kills + 1}",
                "ok": report.ok,
                "findings": [f.as_dict() for f in report.findings]})
            self.cluster.relaunch_store()
            self.store_kills += 1
        elif op.kind == "partition":
            name = self._host_name(op.host)
            if self.cluster.procs[name].poll() is not None:
                self.skipped.append(f"partition:{name}:dead")
                return
            self.cluster.sever(name, self._peer_name(op.peer))
            self.partitions_cut += 1
        elif op.kind == "heal_partition":
            name = self._host_name(op.host)
            if self.cluster.procs[name].poll() is not None:
                self.skipped.append(f"heal:{name}:dead")
                return
            self.cluster.heal(name, self._peer_name(op.peer))
            self.partitions_healed += 1
        elif op.kind == "flap_begin":
            name = self._host_name(op.host)
            if self.cluster.procs[name].poll() is not None:
                self.skipped.append(f"flap:{name}:dead")
                return
            self.cluster.pause_host(name)
            self._paused.add(name)
            self._await_ring(lambda members: name not in members,
                             f"{name} never dropped from the ring")
            self.flaps += 1
        elif op.kind == "flap_end":
            name = self._host_name(op.host)
            if name not in self._paused:
                self.skipped.append(f"flap_end:{name}:not-paused")
                return
            self.cluster.resume_host(name)
            self._paused.discard(name)
            self._await_ring(lambda members: name in members,
                             f"{name} never rejoined the ring")

    def _await_ring(self, pred, what: str, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            members = self._ring_view()
            if members is not None and pred(members):
                return
            time.sleep(0.1)
        raise TimeoutError(f"ring: {what}")

    def _ring_view(self) -> Optional[set]:
        for name in self._live_hosts():
            try:
                return set(self.cluster.ping(name)[3])
            except Exception:
                continue
        return None

    def summary(self) -> dict:
        return {"kills": self.kills, "store_kills": self.store_kills,
                "partitions_cut": self.partitions_cut,
                "partitions_healed": self.partitions_healed,
                "flaps": self.flaps, "retries": self.retries,
                "skipped": list(self.skipped),
                "workflows_started": list(self.started)}


# ---------------------------------------------------------------------------
# Fleet gates
# ---------------------------------------------------------------------------


def collect_checksums(stores, workflows: Sequence[str],
                      attempts: int = 40) -> Dict[str, dict]:
    """Per-workflow `(payload crc, close status)` from the authoritative
    store — run-ids excluded (`payload_row`), so a fault-free and a
    chaotic run of the same seed must agree byte for byte. Reads retry:
    the store may still be redialing right after a relaunch."""
    out: Dict[str, dict] = {}
    domain_id = None
    for attempt in range(attempts):
        try:
            domain_id = stores.domain.by_name(DOMAIN).domain_id
            break
        except (ConnectionError, OSError, TimeoutError):
            time.sleep(0.25)
    for wf in workflows:
        for attempt in range(attempts):
            try:
                run = stores.execution.get_current_run_id(domain_id, wf)
                ms = stores.execution.get_workflow(domain_id, wf, run)
                out[wf] = {
                    "crc": int(crc32_of_row(payload_row(ms))),
                    "close_status": int(ms.execution_info.close_status),
                }
                break
            except (ConnectionError, OSError, TimeoutError):
                time.sleep(0.25)
            except EntityNotExistsError:
                out[wf] = {"crc": None, "close_status": None}
                break
    return out


#: (scope, counter) pairs whose fleet-wide sum must be ZERO at campaign
#: close — the parity oracle over every device-serving tier
PARITY_COUNTERS = (("tpu.serving", "parity-divergence"),
                   ("tpu.migration", "parity-divergence"),
                   ("replication.task-processor",
                    "device-parity-divergence"))

#: (scope, counter) membership/fence witnesses summed for the doc
WITNESS_COUNTERS = (("membership", "ring-drops"),
                    ("membership", "ring-joins"),
                    ("controller", "fenced-evictions"),
                    ("rpc.partition", "blocked-sends"),
                    ("replication.task-processor", "backpressure-shed"))


def sum_fleet_counters(cluster: Cluster) -> dict:
    """Sum the parity + witness counters over every LIVE host's metrics
    registry (the admin_metrics wire op — each host's own registry, the
    one its /metrics scrape serves)."""
    sums: Dict[str, int] = {}
    hosts_seen = 0
    for name in sorted(cluster.hosts):
        if cluster.procs[name].poll() is not None:
            continue
        try:
            snap = wire_call(("127.0.0.1", cluster.hosts[name]),
                             ("admin_metrics",), timeout=10)["snapshot"]
        except Exception:
            continue
        hosts_seen += 1
        for scope, counter in PARITY_COUNTERS + WITNESS_COUNTERS:
            key = f"{scope}/{counter}"
            sums[key] = sums.get(key, 0) + int(
                snap.get(scope, {}).get(counter, 0))
    parity = sum(sums.get(f"{scope}/{counter}", 0)
                 for scope, counter in PARITY_COUNTERS)
    return {"hosts_seen": hosts_seen, "parity_divergence": parity,
            "counters": sums}


def verify_fleet(cluster: Cluster, device=None) -> dict:
    """Closing oracle↔device verification over the REMOTE store
    (loadgen/scenarios discipline, including the live-cluster torn-read
    re-verify loop: a REAL divergence survives every re-read)."""
    stores = RemoteStores(("127.0.0.1", cluster.store_port))
    engine = TPUReplayEngine(stores, DEFAULT_LAYOUT, device=device)
    result = engine.verify_all()
    divergent = list(result.divergent)
    first_pass = len(divergent)
    for _ in range(3):
        if not divergent:
            break
        time.sleep(1.0)
        divergent = list(engine.verify_all(divergent).divergent)
    return {"total": result.total,
            "verified_on_device": result.verified_on_device,
            "divergent": len(divergent),
            "divergent_first_pass": first_pass,
            "ok": not divergent}


def collect_flightrec(cluster: Cluster, last_n: int = 120) -> dict:
    """Every live process's flight-recorder ring (admin_flightrec wire
    op) — the forensic payload a failing campaign dumps beside its doc."""
    rings = {}
    for name in sorted(cluster.hosts):
        if cluster.procs[name].poll() is not None:
            continue
        try:
            rings[name] = cluster.admin(name, "admin_flightrec", last_n,
                                        timeout=10)
        except Exception as exc:
            rings[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return rings


# ---------------------------------------------------------------------------
# Campaign runs and the scenario
# ---------------------------------------------------------------------------


def run_campaign(campaign: Sequence[CampaignOp], *, seed: int,
                 num_hosts: int = 3, num_shards: int = 8,
                 profile: str = "steady", faults: bool = True,
                 regions: int = 1, env_extra=None, device=None) -> dict:
    """Execute one campaign op list against a FRESH cluster (or 2-region
    group) and collect every gate. `faults=False` replays the identical
    workload with the fault ops skipped — the baseline the byte-identity
    oracle compares against."""
    tmp = tempfile.mkdtemp(prefix="fleetchaos-")
    env = {"CADENCE_TPU_SERVING": "1"}
    env.update(env_extra or {})
    group = None
    if regions == 2:
        group = launch_group(num_hosts=num_hosts, num_shards=num_shards,
                             wal_dir=tmp, env_extra=env, device=device)
        cluster = group.clusters["primary"]
    else:
        cluster = launch(num_hosts=num_hosts, num_shards=num_shards,
                         wal=os.path.join(tmp, "store.wal"),
                         env_extra=env, device=device)
    started = time.monotonic()
    doc: dict = {"profile": profile, "faults": faults, "regions": regions}
    try:
        driver = CampaignDriver(cluster, seed, faults=faults)
        if group is not None:
            group.register_global_domain(DOMAIN)
        else:
            driver.register()
        for op in campaign:
            driver.execute(op)
        cluster.heal_all_partitions()
        doc.update(driver.summary())
        doc["checksums"] = collect_checksums(driver.stores, driver.started)
        doc["counters"] = sum_fleet_counters(cluster)
        doc["verify"] = verify_fleet(cluster, device)
        doc["fsck_on_kill"] = driver.fsck_reports
        if group is not None:
            group.replicate()
            group.replicate_domains()
            standby = group.clusters["standby"]
            doc["standby_checksums"] = collect_checksums(
                RemoteStores(("127.0.0.1", standby.store_port)),
                driver.started)
            doc["verify_standby"] = verify_fleet(standby, device)
        gates_failed = (
            doc["verify"]["divergent"] > 0
            or doc["counters"]["parity_divergence"] > 0
            or any(not r["ok"] for r in driver.fsck_reports))
        if gates_failed:
            doc["flightrec"] = collect_flightrec(cluster)
    except Exception as exc:
        doc["error"] = f"{type(exc).__name__}: {exc}"
        try:
            doc["flightrec"] = collect_flightrec(cluster)
        except Exception:
            pass
        raise
    finally:
        doc["duration_s"] = round(time.monotonic() - started, 3)
        if group is not None:
            group.stop()
        else:
            cluster.stop()
        # post-mortem fsck of every region's WAL, now that no process
        # is appending — the recovered-WAL-is-clean half of the oracle
        walpaths = ([c.wal for c in group.clusters.values()]
                    if group is not None else [cluster.wal])
        doc["fsck_final"] = []
        for path in walpaths:
            if path and os.path.exists(path):
                report = walcheck.fsck(path)
                doc["fsck_final"].append({
                    "wal": os.path.basename(path), "ok": report.ok,
                    "findings": [f.as_dict() for f in report.findings]})
    return doc


def cluster_campaign_scenario(seed: int = 20260806, num_hosts: int = 3,
                              num_shards: int = 8, num_workflows: int = 6,
                              signals_per_wf: int = 2, kills: int = 1,
                              store_kills: int = 1, partitions: int = 1,
                              flaps: int = 1, profile: str = "steady",
                              regions: int = 1,
                              shrink_on_failure: bool = False,
                              env_extra=None, device=None) -> dict:
    """The fleet chaos acceptance scenario: run the seeded campaign
    fault-free (baseline), then with every fault live, and gate on

    - byte-identical per-workflow checksums (steady profile only —
      storm terminal state is timing-dependent by design),
    - fsck-clean recovery of every killed store WAL (and the final
      WALs post-shutdown),
    - zero fleet-wide parity divergence,
    - a clean closing verify_all (both regions when regions=2).

    On failure with `shrink_on_failure`, ddmin reduces the campaign to
    a 1-minimal op list (EXPENSIVE: every predicate call replays a
    baseline+chaos pair) and embeds the reproducible report."""
    campaign = build_campaign(seed, num_workflows=num_workflows,
                              signals_per_wf=signals_per_wf,
                              num_hosts=num_hosts, kills=kills,
                              store_kills=store_kills,
                              partitions=partitions, flaps=flaps,
                              profile=profile)
    started = time.monotonic()
    baseline = None
    if profile == "steady":
        baseline = run_campaign(campaign, seed=seed, num_hosts=num_hosts,
                                num_shards=num_shards, profile=profile,
                                faults=False, regions=regions,
                                env_extra=env_extra, device=device)
    chaotic = run_campaign(campaign, seed=seed, num_hosts=num_hosts,
                           num_shards=num_shards, profile=profile,
                           faults=True, regions=regions,
                           env_extra=env_extra, device=device)

    identical = True
    if baseline is not None:
        identical = baseline["checksums"] == chaotic["checksums"]
        if regions == 2:
            identical = (identical and chaotic.get("standby_checksums")
                         == chaotic["checksums"])
    fsck_ok = (all(r["ok"] for r in chaotic["fsck_on_kill"])
               and all(r["ok"] for r in chaotic["fsck_final"]))
    parity_ok = chaotic["counters"]["parity_divergence"] == 0
    verify_ok = chaotic["verify"]["ok"] and (
        regions != 2 or chaotic["verify_standby"]["ok"])
    ok = bool(identical and fsck_ok and parity_ok and verify_ok)

    doc = {
        "scenario": "cluster_campaign", "seed": seed, "profile": profile,
        "num_hosts": num_hosts, "num_shards": num_shards,
        "regions": regions, "campaign_ops": len(campaign),
        "workflows": num_workflows, "signals_per_wf": signals_per_wf,
        "planned": {"kills": kills, "store_kills": store_kills,
                    "partitions": partitions, "flaps": flaps},
        "executed": {k: chaotic[k] for k in
                     ("kills", "store_kills", "partitions_cut",
                      "partitions_healed", "flaps", "retries", "skipped")},
        "checksums_identical": identical,
        "fsck_clean": fsck_ok,
        "parity_divergence": chaotic["counters"]["parity_divergence"],
        "witnesses": chaotic["counters"]["counters"],
        "verify": chaotic["verify"],
        "baseline": baseline, "chaotic": chaotic,
        "duration_s": round(time.monotonic() - started, 3),
        "ok": ok,
    }
    if regions == 2:
        doc["verify_standby"] = chaotic["verify_standby"]
    if not ok and shrink_on_failure:
        predicate = live_campaign_predicate(
            seed=seed, num_hosts=num_hosts, num_shards=num_shards,
            profile=profile, regions=regions, env_extra=env_extra,
            device=device)
        try:
            report = shrink_campaign(
                seed, predicate, num_workflows=num_workflows,
                signals_per_wf=signals_per_wf, num_hosts=num_hosts,
                kills=kills, store_kills=store_kills,
                partitions=partitions, flaps=flaps, profile=profile,
                max_calls=24)
            doc["shrink"] = report.summary()
        except Exception as exc:
            doc["shrink"] = {"error": f"{type(exc).__name__}: {exc}"}
    return doc


# ---------------------------------------------------------------------------
# Campaign shrinking (gen/shrink.py's ddmin over the op axis)
# ---------------------------------------------------------------------------


@dataclass
class CampaignShrinkReport:
    """One campaign shrink outcome, reproducible from the generator
    coordinates plus the kept op indices — nothing else."""

    seed: int
    profile: str
    num_workflows: int
    signals_per_wf: int
    num_hosts: int
    kills: int
    store_kills: int
    partitions: int
    flaps: int
    kept_indices: List[int] = field(default_factory=list)
    original_ops: int = 0
    shrunk_ops: int = 0
    predicate_calls: int = 0
    kept_kinds: List[str] = field(default_factory=list)

    def reproduce(self) -> List[CampaignOp]:
        """Regenerate the minimal failing schedule from the seed alone."""
        full = build_campaign(self.seed, num_workflows=self.num_workflows,
                              signals_per_wf=self.signals_per_wf,
                              num_hosts=self.num_hosts, kills=self.kills,
                              store_kills=self.store_kills,
                              partitions=self.partitions, flaps=self.flaps,
                              profile=self.profile)
        return [full[i] for i in self.kept_indices]

    def summary(self) -> dict:
        return {"seed": self.seed, "profile": self.profile,
                "num_workflows": self.num_workflows,
                "signals_per_wf": self.signals_per_wf,
                "num_hosts": self.num_hosts, "kills": self.kills,
                "store_kills": self.store_kills,
                "partitions": self.partitions, "flaps": self.flaps,
                "kept_indices": list(self.kept_indices),
                "ops": f"{self.original_ops} -> {self.shrunk_ops}",
                "predicate_calls": self.predicate_calls,
                "kept_kinds": list(self.kept_kinds)}


def shrink_campaign(seed: int,
                    failing: Callable[[List[CampaignOp]], bool], *,
                    num_workflows: int = 6, signals_per_wf: int = 2,
                    num_hosts: int = 3, kills: int = 1,
                    store_kills: int = 0, partitions: int = 1,
                    flaps: int = 0, profile: str = "steady",
                    max_calls: int = 400) -> CampaignShrinkReport:
    """ddmin over the campaign's combined workload+fault op list —
    `gen/shrink.shrink_batches` is generic over any sequence, and a
    campaign slice is always replayable (the driver treats ops against
    never-started workflows as benign). The report's coordinates alone
    reproduce the 1-minimal schedule."""
    from .shrink import shrink_batches

    campaign = build_campaign(seed, num_workflows=num_workflows,
                              signals_per_wf=signals_per_wf,
                              num_hosts=num_hosts, kills=kills,
                              store_kills=store_kills,
                              partitions=partitions, flaps=flaps,
                              profile=profile)
    kept, calls = shrink_batches(list(campaign), failing,
                                 max_calls=max_calls)
    minimal = [campaign[i] for i in kept]
    return CampaignShrinkReport(
        seed=seed, profile=profile, num_workflows=num_workflows,
        signals_per_wf=signals_per_wf, num_hosts=num_hosts, kills=kills,
        store_kills=store_kills, partitions=partitions, flaps=flaps,
        kept_indices=list(kept), original_ops=len(campaign),
        shrunk_ops=len(minimal), predicate_calls=calls,
        kept_kinds=sorted({op.kind for op in minimal}))


def injected_regression_predicate(
        poison_wf: int) -> Callable[[List[CampaignOp]], bool]:
    """The campaign twin of `shrink.poisoned_parity_predicate`: a
    deterministic stand-in for "a host kill corrupts the next signal to
    workflow `poison_wf`" — failing iff the slice contains a kill_host
    op with a signal to `poison_wf` somewhere AFTER it. The 1-minimal
    witness is exactly {one kill, one later signal}, which is what the
    shrinker tests pin without ever launching a cluster."""

    def failing(ops: Sequence[CampaignOp]) -> bool:
        seen_kill = False
        for op in ops:
            if op.kind == "kill_host":
                seen_kill = True
            elif (seen_kill and op.kind == "signal"
                  and op.wf == poison_wf):
                return True
        return False

    return failing


def pick_poison_wf(campaign: Sequence[CampaignOp]) -> Optional[int]:
    """The first workflow with a signal after the first kill — the
    deterministic poison target `injected_regression_predicate` needs
    (None when the schedule has no such pair)."""
    seen_kill = False
    for op in campaign:
        if op.kind == "kill_host":
            seen_kill = True
        elif seen_kill and op.kind == "signal":
            return op.wf
    return None


def live_campaign_predicate(*, seed: int, num_hosts: int,
                            num_shards: int = 8, profile: str = "steady",
                            regions: int = 1, env_extra=None, device=None
                            ) -> Callable[[List[CampaignOp]], bool]:
    """The REAL failure predicate: replay the op slice against a fresh
    baseline+chaos cluster pair and report whether the gates fail.
    Each call costs two cluster launches — budget `max_calls` tightly.
    A slice that ERRORS (rather than diverging) is NOT the failure
    being chased (the shrink.py discipline)."""

    def failing(ops: List[CampaignOp]) -> bool:
        if not ops:
            return False
        try:
            base = run_campaign(ops, seed=seed, num_hosts=num_hosts,
                                num_shards=num_shards, profile=profile,
                                faults=False, regions=regions,
                                env_extra=env_extra, device=device)
            chaos = run_campaign(ops, seed=seed, num_hosts=num_hosts,
                                 num_shards=num_shards, profile=profile,
                                 faults=True, regions=regions,
                                 env_extra=env_extra, device=device)
        except Exception:
            return False
        identical = base["checksums"] == chaos["checksums"]
        fsck_ok = (all(r["ok"] for r in chaos["fsck_on_kill"])
                   and all(r["ok"] for r in chaos["fsck_final"]))
        return not (identical and fsck_ok
                    and chaos["counters"]["parity_divergence"] == 0
                    and chaos["verify"]["ok"])

    return failing


def write_chaos_trajectory(doc: dict, root: str = ".",
                           path: Optional[str] = None) -> str:
    """Write one campaign's document to `path` or the next free
    CHAOS_r0N.json slot under `root`; returns the path."""
    if path is None:
        n = 1
        while os.path.exists(os.path.join(root, _TRAJ_PATTERN.format(n))):
            n += 1
        path = os.path.join(root, _TRAJ_PATTERN.format(n))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"schema": TRAJECTORY_SCHEMA, **doc}, fh, indent=2,
                  sort_keys=True, default=str)
        fh.write("\n")
    return path
