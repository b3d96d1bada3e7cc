"""End-to-end load scenarios against a real wire cluster.

The scenario everything else exists for — `overload_scenario` — is the
admission-control proof from Cadence's operational playbook: drive one
domain (the AGGRESSOR) at a multiple of its per-domain quota while a
second domain (the VICTIM) runs normal mixed traffic on the same
cluster, optionally under seeded wire chaos in every host process.
The system passes when overload degrades by SHEDDING, not by latency
collapse:

- ≥ 90% of the aggressor's overflow (traffic beyond its quota capacity)
  is rejected as a typed ServiceBusy — visible both client-side (the
  generator's shed counts) and server-side (`quotas/*` on /metrics);
- the victim domain's p99 (measured from intended send time — open
  loop, no coordinated omission) stays within its SLO;
- every workflow the traffic produced verifies oracle↔device with zero
  checksum divergence — overload and shedding never corrupt state.

The quota is enforced PER HOST (each host's token buckets are local),
so the scenario splits the cluster-wide budget across hosts through the
`env_per_role` seam of `rpc/cluster.launch` — exactly how a production
deployment divides a domain's global RPS across frontends.

Every scenario runs its device work (each host's tiers, the in-process
boxes, the closing verify) on the one device its `device` names: None
means the card, and without one the scenario raises; the CPU is used
only when the caller names it.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from .generator import DecisionCompleters, LoadGenerator
from .mixes import (
    START_ONLY_MIX,
    STANDARD_MIX,
    DomainPlan,
    build_schedule,
)
from .slo import SLO, evaluate_slos

VICTIM_DOMAIN = "lg-victim"
AGGRESSOR_DOMAIN = "lg-aggressor"

#: the chaos spec the scenario uses when chaos is requested without an
#: explicit spec (mirrors tests/test_chaos_soak.py rates)
DEFAULT_CHAOS_SPEC = "drop=0.04,sever=0.02,delay=0.1,delay_ms=8,seed=17"

#: seeded store-fault spec for overload-with-store-chaos runs: writes in
#: the store-server process raise TransientStoreError BEFORE they apply
#: (engine/faults.FaultInjector), so the retry tier heals them without
#: double-applying — the same nothing-was-applied contract the wire
#: chaos keeps (tests/test_chaos_soak.py rates)
DEFAULT_STORE_FAULT_SPEC = "rate=0.04,seed=13"


def _collect_quota_metrics(cluster) -> Dict[str, object]:
    """Per-host quotas/* counters over the admin wire op + one raw
    /metrics body (the operator surface the shed counters live on)."""
    import urllib.request

    from ..rpc.wire import call as wire_call

    per_host: Dict[str, Dict[str, float]] = {}
    for name, port in cluster.hosts.items():
        snap = wire_call(("127.0.0.1", port), ("admin_metrics",),
                         timeout=10)["snapshot"]
        per_host[name] = dict(snap.get("quotas", {}))
    scrape_port = sorted(cluster.http_ports.values())[0]
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{scrape_port}/metrics", timeout=10
    ).read().decode("utf-8")
    shed_total = sum(float(h.get("shed", 0)) for h in per_host.values())
    admitted_total = sum(float(h.get("admitted", 0))
                         for h in per_host.values())
    return {"per_host": per_host, "shed_total": shed_total,
            "admitted_total": admitted_total,
            "prometheus_has_shed": "cadence_shed_total" in body,
            "prometheus_sample": [line for line in body.splitlines()
                                  if line.startswith("cadence_shed")
                                  or line.startswith("cadence_admitted")]}


def _verify_cluster_state(cluster, device=None) -> Dict[str, object]:
    """Oracle↔device checksum verification over the REMOTE store: the
    whole point of running it from here is that RemoteStores duck-types
    Stores, so TPUReplayEngine replays every persisted history on device
    and compares against the authoritative mutable states across the
    wire — the zero-divergence contract applied to loadgen traffic."""
    from ..core.checksum import DEFAULT_LAYOUT
    from ..engine.tpu_engine import TPUReplayEngine
    from ..rpc.client import RemoteStores

    stores = RemoteStores(("127.0.0.1", cluster.store_port))
    engine = TPUReplayEngine(stores, DEFAULT_LAYOUT, device=device)
    result = engine.verify_all()
    # the cluster is LIVE under the verify (real-clock hosts still pump
    # timers — a decision timeout can commit between a key's history
    # read and its execution-row read, a torn comparison that is not a
    # divergence): re-verify only the flagged keys until they read
    # stable — a REAL divergence survives every re-read, a mid-commit
    # phantom clears on the next one
    divergent = list(result.divergent)
    first_pass = len(divergent)
    for _ in range(3):
        if not divergent:
            break
        time.sleep(1.0)
        divergent = list(engine.verify_all(divergent).divergent)
    closed = 0
    for info in stores.domain.list_domains():
        closed += len(stores.visibility.list_closed(info.domain_id))
    return {"total": result.total,
            "verified_on_device": result.verified_on_device,
            "escalated": len(result.escalated),
            "fallback": len(result.fallback),
            "divergent": len(divergent),
            "divergent_first_pass": first_pass,
            "completed_workflows": closed,
            "ok": not divergent}


def _run_harness(plans, schedule, duration_s: float, num_hosts: int,
                 num_shards: int, workers: int, chaos_spec: str,
                 verify: bool, env_per_role=None, device=None):
    """The shared wire-cluster lifecycle every scenario runs: launch →
    prepare/seed → completer fleet → (chaos window) open-loop run →
    drain → quota scrape → oracle↔device verify → teardown. Client-side
    wire chaos joins for the measured window only (setup and post-run
    verification read cleanly, like the chaos soak's discipline);
    host-side chaos from the env stays on for the whole cluster life.
    Returns (load, quota_metrics, verify_doc)."""
    from ..rpc import chaos as chaos_mod
    from ..rpc.cluster import launch

    env_extra = ({"CADENCE_TPU_CHAOS": chaos_spec} if chaos_spec else {})
    cluster = launch(num_hosts=num_hosts, num_shards=num_shards,
                     env_extra=env_extra, env_per_role=env_per_role,
                     device=device)
    try:
        clients = [cluster.frontend(i) for i in range(num_hosts)]
        gen = LoadGenerator(clients, schedule, plans, workers=workers)
        gen.prepare()
        # admission counters can move during prepare too (a pool seed on
        # the quota-limited domain sheds server-side and the generator
        # retries it): baseline AFTER prepare, so `*_run` deltas cover
        # exactly the measured window and compare one-for-one with the
        # generator's client-side counts
        pre = _collect_quota_metrics(cluster)
        counter = {"n": 0}

        def completer_client():
            counter["n"] += 1
            return cluster.frontend(counter["n"] % num_hosts)

        completers = DecisionCompleters(
            completer_client, [p.domain for p in plans])
        completers.start()
        if chaos_spec:
            chaos_mod.install(chaos_mod.parse_spec(chaos_spec))
        try:
            load = gen.run()
        finally:
            chaos_mod.uninstall()
        # drain: let the completers finish the admitted churn backlog
        drain_deadline = time.monotonic() + max(5.0, duration_s)
        last = -1
        while time.monotonic() < drain_deadline:
            time.sleep(0.5)
            if completers.completed == last:
                break
            last = completers.completed
        completers.stop()
        load.completed_churn = completers.completed

        quota_metrics = _collect_quota_metrics(cluster)
        quota_metrics["shed_total_run"] = (
            quota_metrics["shed_total"] - pre["shed_total"])
        quota_metrics["admitted_total_run"] = (
            quota_metrics["admitted_total"] - pre["admitted_total"])
        verify_doc = (_verify_cluster_state(cluster, device) if verify
                      else None)
    finally:
        chaos_mod.uninstall()
        cluster.stop()
    return load, quota_metrics, verify_doc


def overload_scenario(duration_s: float = 8.0, num_hosts: int = 2,
                      victim_rps: float = 4.0,
                      aggressor_quota_rps: float = 4.0,
                      overdrive: float = 2.0,
                      chaos_spec: str = "",
                      store_fault_spec: str = "",
                      seed: int = 20260803,
                      victim_p99_slo_ms: float = 2500.0,
                      workers: int = 32,
                      verify: bool = True,
                      pool_size: int = 6,
                      num_shards: int = 8, device=None) -> dict:
    """Run the two-domain overload scenario; returns the trajectory doc
    (see module docstring for the contract it gates).

    Default rates are sized for the test deployment (every role is a
    GIL-bound Python process sharing one store server, ~20-40 admitted
    ops/s cluster-wide): the aggressor's 2x overdrive must overflow its
    QUOTA, not the cluster's raw capacity, and the dispatch pool must
    never become the bottleneck — an open-loop harness whose own workers
    backlog is re-introducing the coordinated omission it exists to
    prevent. Production deployments scale the same knobs up."""
    per_host_quota = aggressor_quota_rps / num_hosts
    if per_host_quota < 1.0:
        # the burst=0→rps alias caps each host's bucket at per_host_quota
        # tokens: below 1.0, try_consume(1) can NEVER succeed and every
        # aggressor request (including prepare's pool seed) sheds forever
        raise ValueError(
            f"aggressor_quota_rps={aggressor_quota_rps} split over "
            f"{num_hosts} hosts gives each a {per_host_quota} rps bucket "
            "(burst aliases to rps): capacity below one token can never "
            "admit a request — raise the quota or lower num_hosts")
    env_per_role = {"host": {
        "CADENCE_TPU_QUOTAS": f"domain.{AGGRESSOR_DOMAIN}={per_host_quota}"}}
    if store_fault_spec:
        # store chaos rides the per-role seam like the per-host quotas:
        # only the STORE server process injects (engine/faults pre-apply
        # TransientStoreError), so the shed/SLO gate is proven to hold
        # with the persistence tier flapping under overload too
        env_per_role["store"] = {
            "CADENCE_TPU_STORE_FAULTS": store_fault_spec}

    plans = [
        DomainPlan(VICTIM_DOMAIN, victim_rps, mix=STANDARD_MIX,
                   pool_size=pool_size),
        DomainPlan(AGGRESSOR_DOMAIN, aggressor_quota_rps * overdrive,
                   mix=START_ONLY_MIX, pool_size=1),
    ]
    schedule = build_schedule(plans, duration_s, seed)
    load, quota_metrics, verify_doc = _run_harness(
        plans, schedule, duration_s, num_hosts, num_shards, workers,
        chaos_spec, verify, env_per_role=env_per_role, device=device)

    # -- admission accounting ---------------------------------------------
    agg = load.totals(AGGRESSOR_DOMAIN)
    vic = load.totals(VICTIM_DOMAIN)
    # bucket capacity over the ACTUAL wall window (token refill does not
    # stop when the run overshoots its intended duration): rate * window
    # + burst, where burst defaults to one second's tokens per host (the
    # documented burst=0 alias), summed across hosts
    window = max(duration_s, load.duration_s)
    capacity = aggressor_quota_rps * window + per_host_quota * num_hosts
    overflow = max(0.0, agg.sent - capacity)
    # both shed origins count as rejected overflow (a breaker shed under
    # chaos still rejected the request with a typed ServiceBusy), but
    # only quota sheds (`shed`) have matching server-side counters
    shed_ratio = (((agg.shed + agg.shed_busy) / overflow)
                  if overflow > 0 else 1.0)

    slos = [SLO(domain=VICTIM_DOMAIN, p99_ms=victim_p99_slo_ms,
                max_error_rate=0.2)]
    slo_report = evaluate_slos(load, slos)

    doc = {
        "scenario": "overload",
        "run": {
            "duration_s": duration_s, "num_hosts": num_hosts,
            "num_shards": num_shards, "seed": seed,
            "victim_rps": victim_rps,
            "aggressor_quota_rps": aggressor_quota_rps,
            "aggressor_quota_rps_per_host": per_host_quota,
            "overdrive": overdrive, "chaos": chaos_spec,
            "store_faults": store_fault_spec,
            "workers": workers,
        },
        "traffic": load.as_dict(),
        "admission": {
            "aggressor": {
                "sent": agg.sent, "ok": agg.ok, "shed": agg.shed,
                "shed_busy": agg.shed_busy, "errors": agg.errors,
                "capacity_estimate": round(capacity, 1),
                "overflow_estimate": round(overflow, 1),
                "shed_ratio_of_overflow": round(min(shed_ratio, 1.0), 4),
            },
            "victim": {
                "sent": vic.sent, "ok": vic.ok, "shed": vic.shed,
                "shed_busy": vic.shed_busy, "errors": vic.errors,
            },
            "max_retry_after_s": load.max_retry_after_s,
            "scrape": quota_metrics,
        },
        "slo": slo_report.as_dict(),
        "verify": verify_doc,
    }
    doc["ok"] = bool(
        slo_report.ok
        and shed_ratio >= 0.9
        and quota_metrics["shed_total_run"] > 0
        and (verify_doc is None or verify_doc["divergent"] == 0))
    return doc


def serving_scenario(duration_s: float = 4.0, rps: float = 160.0,
                     workers: int = 16, pool_size: int = 12,
                     seed: int = 20260803, num_shards: int = 4,
                     serving_batch: int = 8,
                     serving_wait_us: int = 80000, device=None) -> dict:
    """The device-serving tier comparison (the tier's acceptance run):
    the SAME seeded open-loop schedule of decision transactions (signals
    against a long-lived pool — each one is a full history-engine
    transaction: load → apply → persist) driven twice against a fresh
    in-process cluster, tier OFF then tier ON, recording per-mode
    decision-transaction p50/p99, and for the ON mode the scheduler's
    launches/sec, coalescing factor and parity counters.

    The tier's contract, gated in `doc["ok"]`:
    - coalescing: concurrent committed transactions fold into shared
      device launches (factor > 1.5 — one launch serves several
      transactions' appends, the micro-batching claim);
    - latency: the handoff is post-commit and fire-and-forget, so the
      decision-transaction p99 with the tier ON must be no worse than
      with it OFF (the device twin costs the request path nothing);
    - parity: every served transaction's device payload checksum equals
      the oracle's committed row — divergence counter 0, and the
      post-run full verify stays green with the resident pool the tier
      maintained.

    Runs in-process (Onebox) on purpose: the comparison isolates the
    engine transaction loop from wire/chaos noise; the wire-cluster
    tier rides the same CADENCE_TPU_SERVING knob in production."""
    from ..engine.onebox import Onebox
    from ..utils import metrics as m
    from .mixes import OP_SIGNAL, TrafficMix, trace_digest

    domain = "lg-serving"
    mix = TrafficMix("serving-signal", {OP_SIGNAL: 1.0})
    plans = [DomainPlan(domain, rps, mix=mix, pool_size=pool_size)]
    schedule = build_schedule(plans, duration_s, seed)

    modes: Dict[str, dict] = {}
    for mode in ("off", "on"):
        box = Onebox(num_hosts=1, num_shards=num_shards, device=device)
        if mode == "on":
            scheduler = box.enable_serving()
            # fixed flush width (pow2 bucket of 8) and every suffix
            # event-bucket launched once, so the measured window never
            # pays a first launch mid-run (a stalled drain deepens the
            # folds, and the NEXT bucket stalls too — the snowball
            # scheduler.warm exists to prevent); window
            # wide enough that concurrent transactions genuinely
            # coalesce
            scheduler.max_batch = serving_batch
            scheduler.max_wait_us = serving_wait_us
            scheduler.warm()
        gen = LoadGenerator([box.frontend], schedule, plans,
                            workers=workers, pump=box.pump_once)
        gen.prepare(setup_deadline_s=120.0)
        # warmup (both modes, identical populations): two signal rounds
        # per pool workflow launch the from-state suffix shapes BEFORE
        # the measured window — first launches are deployment warmup, not
        # steady-state decision latency (same discipline as the reset
        # warmup in LoadGenerator._warm_reset_path)
        from .mixes import pool_workflow_ids
        for rnd in range(2):
            for wf in pool_workflow_ids(plans[0]):
                box.frontend.signal_workflow_execution(
                    domain, wf, "lg-warmup",
                    request_id=f"lg-warm-{rnd}-{wf}")
            if mode == "on":
                box.serving.drain(timeout=120.0)
        pre_txns = box.metrics.counter(m.SCOPE_TPU_SERVING,
                                       m.M_SERVING_TXNS)
        pre_launches = box.metrics.counter(m.SCOPE_TPU_SERVING,
                                           m.M_SERVING_LAUNCHES)
        load = gen.run()
        if mode == "on":
            # settle: the tier is async by design — drain the coalescing
            # queue (and any in-flight flush) before reading counters
            box.serving.drain(timeout=60.0)
        pct = load.percentiles(OP_SIGNAL)
        t = load.totals(domain)
        doc_mode = {
            "sent": t.sent, "ok": t.ok, "errors": t.errors,
            "duration_s": round(load.duration_s, 3),
            "decision_p50_ms": round(pct["p50"] * 1000, 3),
            "decision_p99_ms": round(pct["p99"] * 1000, 3),
        }
        if mode == "on":
            txns = box.metrics.counter(m.SCOPE_TPU_SERVING,
                                       m.M_SERVING_TXNS) - pre_txns
            launches = box.metrics.counter(
                m.SCOPE_TPU_SERVING, m.M_SERVING_LAUNCHES) - pre_launches
            stats = box.serving.stats()
            doc_mode.update({
                "serving": stats,
                "window_transactions": txns,
                "window_launches": launches,
                "launches_per_sec": round(launches / load.duration_s, 2),
                "coalescing_factor": round(txns / launches, 3)
                if launches else 0.0,
            })
        verify = box.tpu.verify_all()
        doc_mode["verify"] = {"total": verify.total,
                              "divergent": len(verify.divergent),
                              "resident_served": len(verify.resident),
                              "ok": bool(verify.ok)}
        if mode == "on":
            box.serving.stop()
        modes[mode] = doc_mode

    on, off = modes["on"], modes["off"]
    doc = {
        "scenario": "serving",
        "run": {"duration_s": duration_s, "rps": rps, "workers": workers,
                "pool_size": pool_size, "seed": seed,
                "num_shards": num_shards, "serving_batch": serving_batch,
                "serving_wait_us": serving_wait_us,
                "trace_digest": trace_digest(schedule)},
        "off": off,
        "on": on,
        "comparison": {
            "coalescing_factor": on.get("coalescing_factor", 0.0),
            "p99_on_ms": on["decision_p99_ms"],
            "p99_off_ms": off["decision_p99_ms"],
            "p99_on_le_off": bool(on["decision_p99_ms"]
                                  <= off["decision_p99_ms"]),
            "parity_divergence": on["serving"]["parity_divergence"],
        },
    }
    doc["ok"] = bool(
        on.get("coalescing_factor", 0.0) > 1.5
        and doc["comparison"]["p99_on_le_off"]
        and on["serving"]["parity_divergence"] == 0
        and on["verify"]["divergent"] == 0
        and off["verify"]["divergent"] == 0)
    return doc


def _host_metrics(cluster, names=None) -> Dict[str, dict]:
    """One admin_metrics snapshot per (live) host: {host: {scope: {...}}}."""
    from ..rpc.wire import call as wire_call

    out: Dict[str, dict] = {}
    for name in sorted(names if names is not None else cluster.hosts):
        if cluster.procs[name].poll() is not None:
            continue
        try:
            out[name] = wire_call(("127.0.0.1", cluster.hosts[name]),
                                  ("admin_metrics",),
                                  timeout=15)["snapshot"]
        except Exception:
            continue
    return out


def _counter_delta(current: Dict[str, dict], baseline: Dict[str, dict],
                   scope: str, metric: str, hosts=None) -> float:
    """Summed per-host counter movement between two scrape snapshots."""
    total = 0.0
    for name, snap in current.items():
        if hosts is not None and name not in hosts:
            continue
        now = float(snap.get(scope, {}).get(metric, 0.0))
        base = float(baseline.get(name, {}).get(scope, {})
                     .get(metric, 0.0))
        total += max(0.0, now - base)
    return total


def _kill_window(samples, kill_clock: Dict[str, float], t0: float) -> dict:
    """The latencies of the ops the kill window held up: every op due
    before the steal's end (the run's end if the steal never ended) and
    not done before the SIGKILL, beside those of the other ops; p99 by
    nearest rank."""
    import math

    from .mixes import OP_SIGNAL

    def pct_ms(lats, q):
        if not lats:
            return None
        lats = sorted(lats)
        return round(lats[max(0, math.ceil(len(lats) * q) - 1)] * 1000, 3)

    if "kill" not in kill_clock:
        return {"kill_at_s": None}
    start = kill_clock["kill"] - t0
    end = (kill_clock["steal"] - t0 if "steal" in kill_clock
           else max((at for at, _, _ in samples), default=start))
    held = [at <= end and at + lat >= start for at, _, lat in samples]
    inside = [(k, lat) for (_, k, lat), h in zip(samples, held) if h]
    outside = [(k, lat) for (_, k, lat), h in zip(samples, held) if not h]
    sig_in = [lat for k, lat in inside if k == OP_SIGNAL]
    sig_out = [lat for k, lat in outside if k == OP_SIGNAL]
    return {"kill_at_s": round(start, 3),
            "steal_s": (round(end - start, 3) if "steal" in kill_clock
                        else None),
            "ops": len(inside), "signals": len(sig_in),
            "p99_ms": pct_ms([lat for _, lat in inside], 0.99),
            "signal_p50_ms": pct_ms(sig_in, 0.5),
            "signal_p99_ms": pct_ms(sig_in, 0.99),
            "signal_max_ms": pct_ms(sig_in, 1.0),
            "signals_outside": len(sig_out),
            "signal_p99_ms_outside": pct_ms(sig_out, 0.99)}


def cluster_serving_scenario(duration_s: float = 12.0, num_hosts: int = 3,
                             rps: float = 16.0, pool_size: int = 16,
                             kill_at_frac: float = 0.5,
                             seed: int = 20260804,
                             p99_slo_ms: float = 8000.0,
                             workers: int = 24, num_shards: int = 8,
                             hb_interval: float = 0.15, ttl: float = 1.5,
                             hydration_floor: float = 0.8,
                             verify: bool = True, device=None) -> dict:
    """Multi-host device serving under host death (the multi-host
    acceptance run): a wire cluster with the serving tier ON in every host process
    (each host its own serving mesh / resident pool / ServingScheduler
    over its ring slice, snapshot policy aggressive so the shared store
    stays fresh), driven by a seeded signal-dominant open-loop schedule
    against the SURVIVING hosts' frontends — and mid-window one host is
    SIGKILLed. The TTL drops it from the ring, the survivors steal its
    shards, and the migration tier (engine/migration.py) warm-starts the
    stolen state from persisted snapshots + batch-range reads.

    The subsystem's contract, gated in `doc["ok"]`:
    - the victim domain's p99 (clocked from intended send time — the
      kill window's failover stalls are IN the number) holds its SLO
      and the error rate stays bounded;
    - zero parity divergence everywhere: the serving tier's gated
      per-transaction counter, the migration tier's hydration parity,
      and the post-run oracle↔device verify over the store;
    - the survivors' post-kill admits for the stolen shards are
      ≥ `hydration_floor` snapshot-hydrated (migrated-in vs cold/stale
      steals) — warm failover, not a replay storm;
    - `events_per_sec_cluster` is recorded next to the per-pod number
      (the first events/s/CLUSTER north star: summed device-replayed
      events across every host over the measured window).

    `hosts` reports each host's serving stats, kernel launches (its
    `tpu.launches` gauges) by its boot warm-up, over its life and over the
    measured window, and launch shapes: the survivors' at the end, the
    victim's just before its kill (or the error that read met).
    `kill_window` holds the latencies of the ops in flight or due between
    the SIGKILL and the moment the survivors own every shard the victim
    owned, beside the other ops'."""
    import threading

    from ..rpc.cluster import launch
    from ..utils import metrics as cm
    from .mixes import OP_QUERY, OP_SIGNAL, OP_START, TrafficMix

    env_extra = {
        "CADENCE_TPU_SERVING": "1",
        # every parity-clean append refreshes the shared snapshot store:
        # host death can land anywhere and the survivors still hydrate
        "CADENCE_TPU_SNAPSHOT_MIN_EVENTS": "1",
        "CADENCE_TPU_SNAPSHOT_EVERY_EVENTS": "1",
        # a narrow flush width + trimmed warm shapes keep the hosts'
        # boot warm-up (rpc/server: serving_warmed) fast on small boxes;
        # the drive below never folds past these buckets
        "CADENCE_TPU_SERVING_BATCH": "8",
        "CADENCE_TPU_SERVING_WARM_EVENTS": "16,32,64",
    }
    domain = VICTIM_DOMAIN
    # signal-dominant: signals are full history-engine transactions on
    # the long-lived pool — the hot resident state whose migration the
    # scenario gates; the start tail keeps churn (and its completers)
    # exercising cold admits without letting sub-second-old workflows
    # dominate the steal-time population
    mix = TrafficMix("cluster-serving",
                     {OP_SIGNAL: 0.7, OP_START: 0.15, OP_QUERY: 0.15})
    plans = [DomainPlan(domain, rps, mix=mix, pool_size=pool_size)]
    schedule = build_schedule(plans, duration_s, seed)

    cluster = launch(num_hosts=num_hosts, num_shards=num_shards,
                     hb_interval=hb_interval, ttl=ttl,
                     env_extra=env_extra, device=device)
    victim_host = sorted(cluster.hosts)[-1]
    survivors = [n for n in sorted(cluster.hosts) if n != victim_host]
    kill_scrape: Dict[str, dict] = {}
    victim_doc: Dict[str, object] = {}
    owned_before = {}
    #: perf_counter of the SIGKILL and of the steal's end
    kill_clock: Dict[str, float] = {}
    #: (intended send offset, op kind, latency) of every op sent
    samples: List[tuple] = []
    try:
        # the LB view: traffic only ever targets hosts that stay alive —
        # the kill exercises the HISTORY-tier failover (shard steal +
        # state migration), which is where the resident state lives
        # hold traffic until every host's serving tier is WARM (the boot
        # warm-up compiles the flush kernels in the background): a
        # mid-window compile would stall the victim's drain long enough
        # that its pre-kill snapshots never land — deployment warmup,
        # the same discipline every serving scenario keeps
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            docs = {}
            for n in sorted(cluster.hosts):
                try:
                    docs[n] = cluster.admin(n, "admin_cluster")
                except Exception:
                    pass
            if len(docs) == len(cluster.hosts) and all(
                    d.get("serving_warmed") for d in docs.values()):
                break
            time.sleep(0.5)
        else:
            raise TimeoutError("serving tier never warmed on all hosts")
        warm_scrape = _host_metrics(cluster)
        clients = [cluster.frontend(n) for n in survivors]
        gen = LoadGenerator(clients, schedule, plans, workers=workers)
        record = gen._record

        def record_timed(op, **kw):
            samples.append((op.at_s, op.kind, kw["latency"]))
            record(op, **kw)

        gen._record = record_timed
        gen.prepare(setup_deadline_s=120.0)
        counter = {"n": 0}

        def completer_client():
            counter["n"] += 1
            return cluster.frontend(survivors[counter["n"]
                                              % len(survivors)])

        completers = DecisionCompleters(completer_client, [domain])
        completers.start()
        start_scrape = _host_metrics(cluster)
        owned_before.update(cluster.owned_shards())

        def killer():
            time.sleep(max(0.1, duration_s * kill_at_frac))
            # baseline right before the kill: the hydration gate is on
            # POST-KILL deltas, and the victim's contribution to the
            # cluster events number ends here
            kill_scrape.update(_host_metrics(cluster))
            try:
                victim_doc.update(cluster.admin(victim_host,
                                                "admin_cluster"))
            except Exception as exc:
                victim_doc["error"] = f"{type(exc).__name__}: {exc}"
            kill_clock["kill"] = time.perf_counter()
            cluster.kill_host(victim_host)
            # the steal ends when the survivors own every victim shard
            taken = set(owned_before.get(victim_host, []))
            deadline = time.monotonic() + ttl * 10
            while time.monotonic() < deadline:
                owned = cluster.owned_shards()
                if taken <= {s for n in survivors for s in owned.get(n, [])}:
                    kill_clock["steal"] = time.perf_counter()
                    break
                time.sleep(0.05)

        kill_thread = threading.Thread(target=killer, daemon=True)
        kill_thread.start()
        load = gen.run()
        kill_thread.join(timeout=30)
        # settle: let the survivors finish stealing/hydrating and the
        # completers drain the churn backlog
        deadline = time.monotonic() + max(5.0, ttl * 4)
        last = -1
        while time.monotonic() < deadline:
            time.sleep(0.5)
            if completers.completed == last:
                break
            last = completers.completed
        completers.stop()
        load.completed_churn = completers.completed

        end_scrape = _host_metrics(cluster, names=survivors)
        cluster_docs = {n: cluster.admin(n, "admin_cluster")
                        for n in survivors}
        owned_after = cluster.owned_shards()
        verify_doc = (_verify_cluster_state(cluster, device) if verify
                      else None)
    finally:
        cluster.stop()

    # -- the warm-failover accounting ---------------------------------------
    mig_in = _counter_delta(end_scrape, kill_scrape,
                            cm.SCOPE_TPU_MIGRATION, cm.M_MIG_IN)
    mig_cold = _counter_delta(end_scrape, kill_scrape,
                              cm.SCOPE_TPU_MIGRATION, cm.M_MIG_COLD)
    mig_stale = _counter_delta(end_scrape, kill_scrape,
                               cm.SCOPE_TPU_MIGRATION, cm.M_MIG_STALE)
    # young steals (record-less sub-floor histories — a start committed
    # moments before the kill) are reported but NOT charged against the
    # warm-failover ratio: the snapshot policy's own min_events floor
    # deems them not worth a record, and their "cold replay" is a few
    # events, not a storm
    mig_young = _counter_delta(end_scrape, kill_scrape,
                               cm.SCOPE_TPU_MIGRATION, cm.M_MIG_YOUNG)
    steals = mig_in + mig_cold + mig_stale
    hydration_ratio = (mig_in / steals) if steals > 0 else 0.0
    # divergence is summed over the SURVIVORS' whole life (end_scrape)
    # PLUS the victim's pre-kill window (kill_scrape still includes it)
    # — a divergence the victim recorded before dying counts too
    victim_pre_kill = {k: v for k, v in kill_scrape.items()
                       if k == victim_host}
    serving_divergence = _counter_delta(
        end_scrape, {}, cm.SCOPE_TPU_SERVING, cm.M_SERVING_DIVERGENCE) \
        + _counter_delta(victim_pre_kill, {}, cm.SCOPE_TPU_SERVING,
                         cm.M_SERVING_DIVERGENCE)
    migration_divergence = _counter_delta(
        end_scrape, {}, cm.SCOPE_TPU_MIGRATION, cm.M_MIG_DIVERGENCE) \
        + _counter_delta(victim_pre_kill, {}, cm.SCOPE_TPU_MIGRATION,
                         cm.M_MIG_DIVERGENCE)

    # -- events/s/cluster: device-replayed events summed over every host
    # (survivors over the whole window + the victim up to its death)
    def events_of(scrapes, base, hosts):
        return (_counter_delta(scrapes, base, cm.SCOPE_TPU_RESIDENT,
                               cm.M_RESIDENT_EVENTS_APPENDED, hosts=hosts)
                + _counter_delta(scrapes, base, cm.SCOPE_TPU_REPLAY,
                                 cm.M_EVENTS_REPLAYED, hosts=hosts))

    window = max(duration_s, load.duration_s)
    events_cluster = events_of(end_scrape, start_scrape, set(survivors)) \
        + events_of(kill_scrape, start_scrape, {victim_host})
    per_host_events = {
        n: events_of(end_scrape, start_scrape, {n}) for n in survivors}
    per_host_events[victim_host] = events_of(kill_scrape, start_scrape,
                                             {victim_host})
    events_per_sec_pod = max(
        (e / window for e in per_host_events.values()), default=0.0)

    pct = load.percentiles(OP_SIGNAL)
    # error bound matches overload_scenario's victim convention (0.2):
    # requests IN FLIGHT to the victim at the SIGKILL instant surface as
    # honest connection errors (the retry tier only re-sends faults that
    # provably applied nothing), so a kill window always costs a few
    slos = [SLO(domain=domain, p99_ms=p99_slo_ms, max_error_rate=0.2)]
    slo_report = evaluate_slos(load, slos)
    kill_window = _kill_window(samples, kill_clock, gen._t0)
    victim_shards_taken = set(owned_before.get(victim_host, [])) <= set(
        s for n in survivors for s in owned_after.get(n, []))

    # -- each host's serving stats and kernel launches (its tpu.launches
    # gauges), the survivors' at the end and the victim's before its kill
    from ..rpc.server import SCOPE_LAUNCHES

    last_scrape = {n: end_scrape.get(n, {}) for n in survivors}
    last_scrape[victim_host] = kill_scrape.get(victim_host, {})
    last_doc = dict(cluster_docs)
    last_doc[victim_host] = victim_doc
    hosts_doc = {}
    for n, snap in last_scrape.items():
        life = snap.get(SCOPE_LAUNCHES, {})
        base = start_scrape.get(n, {}).get(SCOPE_LAUNCHES, {})
        warm = warm_scrape.get(n, {}).get(SCOPE_LAUNCHES, {})
        hosts_doc[n] = {
            "serving": last_doc[n].get("serving"),
            "error": last_doc[n].get("error"),
            "warm_launches": {k: int(v) for k, v in warm.items() if v},
            "launches": {k: int(v) for k, v in life.items() if v},
            "window_launches": {k: int(v - base.get(k, 0.0))
                                for k, v in life.items()
                                if v > base.get(k, 0.0)},
            "launch_shapes": [list(s) for s in
                              last_doc[n].get("launch_shapes", [])]}

    doc = {
        "scenario": "cluster-serving",
        "run": {"duration_s": duration_s, "num_hosts": num_hosts,
                "num_shards": num_shards, "rps": rps,
                "pool_size": pool_size, "seed": seed,
                "kill_at_frac": kill_at_frac, "ttl": ttl,
                "victim_host": victim_host, "survivors": survivors,
                "workers": workers, "hydration_floor": hydration_floor},
        "traffic": load.as_dict(),
        "latency": {"signal_p50_ms": round(pct["p50"] * 1000, 3),
                    "signal_p99_ms": round(pct["p99"] * 1000, 3)},
        "slo": slo_report.as_dict(),
        "kill_window": kill_window,
        "failover": {
            "owned_before": {n: sorted(v)
                             for n, v in owned_before.items()},
            "owned_after": {n: sorted(v) for n, v in owned_after.items()},
            "victim_shards_taken": bool(victim_shards_taken),
            "migrated_in": mig_in, "cold_steals": mig_cold,
            "young_steals": mig_young, "stale_snapshots": mig_stale,
            "hydration_ratio": round(hydration_ratio, 4),
            "suffix_events": _counter_delta(
                end_scrape, kill_scrape, cm.SCOPE_TPU_MIGRATION,
                cm.M_MIG_SUFFIX_EVENTS),
        },
        "parity": {
            "serving_divergence": serving_divergence,
            "migration_divergence": migration_divergence,
        },
        "cluster": {n: {"owned_shards": d["owned_shards"],
                        "migration": d["migration"],
                        "resident_entries":
                            (d["resident"] or {}).get("entries", 0)}
                    for n, d in cluster_docs.items()},
        "north_star": {
            "events_per_sec_cluster": round(events_cluster / window, 1),
            "events_per_sec_pod": round(events_per_sec_pod, 1),
            "events_replayed_cluster": events_cluster,
            "window_s": round(window, 3),
        },
        "verify": verify_doc,
        "hosts": hosts_doc,
    }
    doc["ok"] = bool(
        slo_report.ok
        and victim_shards_taken
        and steals > 0
        and hydration_ratio >= hydration_floor
        and serving_divergence == 0
        and migration_divergence == 0
        and (verify_doc is None or verify_doc["divergent"] == 0))
    return doc


def _wait_for(predicate, timeout: float, what: str) -> float:
    """Poll `predicate` every 0.2 s; raise TimeoutError after `timeout`.
    Returns the seconds waited."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if predicate():
            return time.perf_counter() - t0
        time.sleep(0.2)
    raise TimeoutError(f"{what} within {timeout} s")


def _host_launches(cluster, name: str) -> Dict[str, int]:
    """One live host's kernel launches (its admin_metrics `tpu.launches`)."""
    from ..rpc.server import SCOPE_LAUNCHES

    snap = cluster.admin(name, "admin_metrics")["snapshot"]
    return {k: int(v) for k, v in snap.get(SCOPE_LAUNCHES, {}).items() if v}


def _oracle_row_mismatches(stores, rows: dict) -> List[tuple]:
    """The resident rows whose CRC or branch differs from the oracle's at
    the row's content address (the batches the pinned state covers,
    replayed through the StateBuilder), or whose address is not in the
    store."""
    import numpy as np

    from ..core.checksum import (DEFAULT_LAYOUT, STICKY_ROW_INDEX,
                                 crc32_of_row, payload_row)
    from ..engine.cache import batch_crc
    from ..oracle.state_builder import StateBuilder

    bad = []
    for key, (crc, branch, addr) in rows.items():
        batch_count, tail_crc = addr
        batches = stores.history.as_history_batches(*key)
        prefix = batches[:batch_count]
        if (batch_count > len(batches)
                or int(batch_crc(prefix[-1])) != tail_crc):
            bad.append(key)
            continue
        ms = StateBuilder().replay_history(prefix)
        oracle = payload_row(ms, DEFAULT_LAYOUT)
        oracle[STICKY_ROW_INDEX] = 0
        if (crc != int(crc32_of_row(np.asarray(oracle, dtype=np.int64)))
                or branch != int(ms.version_histories.current_index)):
            bad.append(key)
    return bad


def planned_rebalance_scenario(num_hosts: int = 2, num_shards: int = 8,
                               pool_size: int = 12, rounds: int = 2,
                               device=None) -> dict:
    """A planned rebalance of a serving wire cluster, each step timed:
    `num_hosts` serving hosts (every one's tier on `device`, None = the
    card) take a pool of workflows through a start, one decision and
    `rounds` signal rounds; once the serving tier is quiet one host joins
    the ring. The losers snapshot and evict the moving rows and the
    gainer hydrates them (engine/migration.py). The shape of
    tests/test_cluster_serving.py test_planned_rebalance_byte_parity.

    Gated in `doc["gates"]` and `doc["ok"]`: the gainer migrated rows in
    with zero parity divergence and a loser migrated rows out; every
    resident row the gainer serves equals the oracle's CRC and branch at
    its content address; each moved key still at its pre-move address
    has the CRC the losing host held.

    `hosts` reports each host's kernel launches (its `tpu.launches`) over
    its life and over the traffic and hydration (`window_launches`: the
    first hosts' after their boot warm-up, read before any traffic; the
    gainer's less that warm-up, which every host of the run makes alike)
    and its launch shapes."""
    from ..rpc.client import RemoteStores
    from ..rpc.cluster import launch

    domain, task_list = "cs-domain", "cs-tl"
    env = {"CADENCE_TPU_SERVING": "1", "CADENCE_TPU_SNAPSHOT_MIN_EVENTS": "1",
           "CADENCE_TPU_SNAPSHOT_EVERY_EVENTS": "1",
           "CADENCE_TPU_SERVING_BATCH": "8",
           "CADENCE_TPU_SERVING_WARM_EVENTS": "16,32"}
    walls: Dict[str, float] = {}
    t0 = time.perf_counter()
    cluster = launch(num_hosts=num_hosts, num_shards=num_shards,
                     env_extra=env, device=device)
    try:
        walls["launch"] = time.perf_counter() - t0
        walls["warm"] = _wait_for(lambda: all(
            cluster.admin(n, "admin_cluster").get("serving_warmed")
            for n in sorted(cluster.hosts)), 600, "serving never warmed")
        warm = {n: _host_launches(cluster, n) for n in sorted(cluster.hosts)}
        t = time.perf_counter()
        fe = cluster.frontend(0)
        fe.register_domain(domain)
        pool = [f"cs-wf-{i}" for i in range(pool_size)]
        for wf in pool:
            fe.start_workflow_execution(domain, wf, "t", task_list,
                                        execution_timeout=3600)
        pending = set(pool)
        deadline = time.monotonic() + 60
        while pending and time.monotonic() < deadline:
            resp = fe.poll_for_decision_task(domain, task_list,
                                             wait_seconds=0.3)
            if resp is None or resp.token is None:
                continue
            fe.respond_decision_task_completed(resp.token, [])
            pending.discard(resp.token.workflow_id)
        if pending:
            raise TimeoutError(f"pool never seeded: {sorted(pending)}")
        for rnd in range(rounds):
            for wf in pool:
                fe.signal_workflow_execution(domain, wf, f"cs-sig-{rnd}",
                                             request_id=f"cs-req-{rnd}-{wf}")
        # complete the decisions the signals scheduled until the list is
        # quiet: pending decisions would time out on the real clock and
        # keep committing transactions under the comparisons below
        idle, deadline = 0, time.monotonic() + 60
        while idle < 4 and time.monotonic() < deadline:
            resp = fe.poll_for_decision_task(domain, task_list,
                                             wait_seconds=0.3)
            if resp is None or resp.token is None:
                idle += 1
                continue
            idle = 0
            fe.respond_decision_task_completed(resp.token, [])
        walls["traffic"] = time.perf_counter() - t

        def drained():
            docs = [cluster.admin(n, "admin_cluster")
                    for n in sorted(cluster.hosts)]
            entries = sum((d["resident"] or {}).get("entries", 0)
                          for d in docs)
            depth = sum((d["serving"] or {}).get("queue_depth", 1)
                        for d in docs)
            return entries >= len(pool) and depth == 0

        walls["quiesce"] = _wait_for(drained, 120,
                                     "the serving tier never quiesced")
        moved_rows: dict = {}
        for n in sorted(cluster.hosts):
            moved_rows.update(cluster.admin(n, "admin_cluster", True)
                              .get("resident_rows", {}))
        t = time.perf_counter()
        new_host = cluster.add_host()
        walls["add_host"] = time.perf_counter() - t
        walls["hydrate"] = _wait_for(
            lambda: ((cluster.admin(new_host, "admin_cluster")
                      .get("resident", {}) or {}).get("entries", 0) > 0),
            300, f"{new_host} never hydrated a row")
        # the gainer hydrates on its own beat thread: let it finish (its
        # report and pool unchanged for a second) before reading the rows
        seen: list = []

        def settled():
            doc = cluster.admin(new_host, "admin_cluster")
            seen.append((doc["migration"], doc["resident"]["entries"]))
            return len(seen) > 5 and all(x == seen[-1] for x in seen[-6:])

        walls["hydrate_settled"] = _wait_for(
            settled, 60, f"{new_host}'s hydration never settled")
        gained = cluster.admin(new_host, "admin_cluster", True)
        mig = gained["migration"]
        losers_out = sum(cluster.admin(n, "admin_cluster")["migration"]
                         ["migrated_out"]
                         for n in sorted(cluster.hosts) if n != new_host)
        t = time.perf_counter()
        stores = RemoteStores(("127.0.0.1", cluster.store_port))
        rows = gained.get("resident_rows", {})
        oracle_bad = _oracle_row_mismatches(stores, rows)
        same = [key for key, (_, _, addr) in rows.items()
                if key in moved_rows and moved_rows[key][2] == tuple(addr)]
        moved_bad = [key for key in same
                     if moved_rows[key][0] != rows[key][0]]
        walls["oracle_check"] = time.perf_counter() - t
        walls["new_host_warm"] = _wait_for(
            lambda: cluster.admin(new_host, "admin_cluster")
            .get("serving_warmed"), 120,
            f"{new_host}'s serving tier never warmed")
        hosts = {}
        for n in sorted(cluster.hosts):
            doc = cluster.admin(n, "admin_cluster")
            life = _host_launches(cluster, n)
            base = warm.get(n, warm[sorted(warm)[0]])
            hosts[n] = {
                "serving": doc["serving"], "migration": doc["migration"],
                "resident_entries": (doc["resident"] or {}).get("entries", 0),
                "warm_launches": warm.get(n),
                "launches": life,
                "window_launches": {k: v - base.get(k, 0)
                                    for k, v in life.items()
                                    if v > base.get(k, 0)},
                "launch_shapes": [list(s) for s in doc["launch_shapes"]]}
    finally:
        cluster.stop()
    walls["total"] = time.perf_counter() - t0
    gates = {
        "rows_pinned": len(moved_rows) >= len(pool),
        "migrated_in": mig["migrated_in"] > 0,
        "migration_divergence": mig["parity_divergence"] == 0,
        "migrated_out": losers_out > 0,
        "rows_served": bool(rows),
        "rows_equal_oracle": not oracle_bad,
        "moved_keys_equal": bool(same) and not moved_bad,
    }
    return {"scenario": "planned-rebalance",
            "run": {"num_hosts": num_hosts, "num_shards": num_shards,
                    "pool_size": pool_size, "rounds": rounds},
            "new_host": new_host, "rows_before": len(moved_rows),
            "rows_hydrated": len(rows),
            "rows_equal_oracle": len(rows) - len(oracle_bad),
            "moved_keys": len(same),
            "moved_keys_equal": len(same) - len(moved_bad),
            "migrated_out": losers_out, "migration_in": mig,
            "walls_s": walls, "hosts": hosts, "gates": gates,
            "ok": all(gates.values())}


def region_failover_scenario(duration_s: float = 10.0, num_hosts: int = 2,
                             rps: float = 10.0, pool_size: int = 12,
                             kill_at_frac: float = 0.6,
                             seed: int = 20260806,
                             p99_slo_ms: float = 8000.0,
                             workers: int = 16, num_shards: int = 8,
                             hb_interval: float = 0.15, ttl: float = 1.5,
                             hydration_floor: float = 0.8,
                             max_repl_lag: int = 64,
                             verify: bool = True, device=None) -> dict:
    """Active-active multi-region failover under region kill (the
    multi-region acceptance run): TWO wire regions — each its own WAL-backed store
    server + N service hosts with the serving tier ON — continuously
    replicating (history, domain metadata, and shipped snapshot records
    all ride the replication stream; the standby leader's device applier
    keeps its HBM state hot at the bulk-ingest rate). Standard-mix
    traffic drives the active region; mid-window EVERY active-region
    process is SIGKILLed. The standby then promotes WARM: pre-flip
    snapshot hydration of its serving tier, domain flip with a failover
    version bump, task regeneration — and a second traffic phase runs
    against the promoted region.

    The contract, gated in `doc["ok"]`:
    - replication lag is bounded at the kill instant (the data-loss
      window an unplanned region failover can ever cost);
    - the promoted region's signal p99 (decision-transaction latency,
      clocked from intended send time) holds its SLO;
    - the stolen executions are ≥ `hydration_floor` warm at promotion:
      snapshot-hydrated or already device-resident via the standby's
      device-speed apply — not a cold replay storm;
    - zero parity divergence everywhere: both regions' serving tiers,
      the migration/hydration parity gates, and the replication device
      applier's own per-apply parity counter;
    - post-run oracle↔device verify is green on BOTH regions — the
      promoted one live, the killed one after relaunching its store
      server from the WAL it crashed with (fsck-clean recovery);
    - `events_per_sec_fleet` (device-replayed events summed over every
      host of every region) is recorded next to the per-region
      `events_per_sec_cluster` north star."""
    import shutil
    import subprocess
    import sys
    import tempfile
    import threading
    import types

    from ..engine.failovermanager import FailoverManager
    from ..engine.multicluster import _refresh_domain_tasks
    from ..engine.replication import REPLICATION_QUEUE
    from ..rpc.cluster import (
        _wait_listening,
        device_name,
        free_port,
        launch_group,
        process_env,
    )
    from ..utils import metrics as cm
    from .mixes import (
        OP_QUERY,
        OP_SIGNAL,
        OP_SIGNAL_WITH_START,
        OP_START,
        ScheduledOp,
        TrafficMix,
    )

    env_extra = {
        "CADENCE_TPU_SERVING": "1",
        # aggressive snapshot policy: every parity-clean append refreshes
        # the local store AND ships the record to the peer region, so the
        # kill can land anywhere and the standby still hydrates warm
        "CADENCE_TPU_SNAPSHOT_MIN_EVENTS": "1",
        "CADENCE_TPU_SNAPSHOT_EVERY_EVENTS": "1",
        "CADENCE_TPU_SERVING_BATCH": "8",
        "CADENCE_TPU_SERVING_WARM_EVENTS": "16,32,64",
    }
    domain = "lg-region"
    plans = [DomainPlan(domain, rps, mix=STANDARD_MIX,
                        pool_size=pool_size)]
    schedule = build_schedule(plans, duration_s, seed)
    # promoted-phase traffic against the STOLEN pool: signal-dominant
    # (decision transactions on the hydrated rows), a start tail for
    # post-failover admits — no resets (their compile warm-up belongs to
    # prepare, which phase 2 deliberately skips: the pool it drives is
    # the replicated one, not a freshly seeded one)
    mix2 = TrafficMix("region-promoted", {OP_SIGNAL: 0.5, OP_START: 0.2,
                                          OP_QUERY: 0.2,
                                          OP_SIGNAL_WITH_START: 0.1})
    plans2 = [DomainPlan(domain, rps, mix=mix2, pool_size=pool_size)]
    schedule2 = [
        # churn start ids restart phase-1's replicated churn ids unless
        # salted; pool/sws/query ids must NOT be salted (the stolen pool
        # is the point)
        ScheduledOp(index=op.index, at_s=op.at_s, kind=op.kind,
                    domain=op.domain,
                    workflow_id=(f"p2-{op.workflow_id}"
                                 if op.kind == OP_START
                                 else op.workflow_id), arg=op.arg)
        for op in build_schedule(plans2, duration_s, seed + 1)]

    wal_dir = tempfile.mkdtemp(prefix="cadence-region-")
    group = launch_group(("primary", "standby"), num_hosts=num_hosts,
                         num_shards=num_shards, hb_interval=hb_interval,
                         ttl=ttl, env_extra=env_extra, wal_dir=wal_dir,
                         device=device)
    pcluster = group.clusters["primary"]
    scluster = group.clusters["standby"]
    primary_hosts = sorted(pcluster.hosts)
    standby_hosts = sorted(scluster.hosts)
    kill_scrape_primary: Dict[str, dict] = {}
    lag_doc = {"lag": -1, "tail": 0}
    recover_proc = None
    try:
        # hold traffic until every host in BOTH regions is serving-warm
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            docs = []
            for cl in (pcluster, scluster):
                for n in sorted(cl.hosts):
                    try:
                        docs.append(cl.admin(n, "admin_cluster"))
                    except Exception:
                        pass
            if (len(docs) == len(pcluster.hosts) + len(scluster.hosts)
                    and all(d.get("serving_warmed") for d in docs)):
                break
            time.sleep(0.5)
        else:
            raise TimeoutError("serving tier never warmed in both regions")
        group.register_global_domain(domain)

        clients = [pcluster.frontend(n) for n in primary_hosts]
        gen = LoadGenerator(clients, schedule, plans, workers=workers)
        gen.prepare(setup_deadline_s=120.0)
        # let the seeded pool replicate before the measured window so the
        # kill-time lag number reflects steady-state streaming, not the
        # prepare burst
        group.replicate()
        counter = {"n": 0}

        def completer_client():
            counter["n"] += 1
            return pcluster.frontend(
                primary_hosts[counter["n"] % len(primary_hosts)])

        completers = DecisionCompleters(completer_client, [domain])
        completers.start()
        start_scrape_primary = _host_metrics(pcluster)
        start_scrape_standby = _host_metrics(scluster)
        t_fleet0 = time.monotonic()

        def killer():
            time.sleep(max(0.1, duration_s * kill_at_frac))
            # the pre-kill lag gate: bounded wait for the stream to be
            # caught up (traffic still flowing), then record the honest
            # number — this is the data-loss window the kill can cost
            lag_deadline = time.monotonic() + 15.0
            while True:
                try:
                    tail = group.active.stores.queue.size(REPLICATION_QUEUE)
                    ack = group.standby.stores.queue.get_ack(
                        "repl-from:primary", "standby")
                    lag_doc["lag"], lag_doc["tail"] = max(0, tail - ack), tail
                except Exception:
                    pass
                if (0 <= lag_doc["lag"] <= max_repl_lag
                        or time.monotonic() > lag_deadline):
                    break
                time.sleep(0.2)
            kill_scrape_primary.update(_host_metrics(pcluster))
            # kill -9 EVERY active-region process: serving plane first,
            # then the region's store itself
            for name in primary_hosts:
                try:
                    pcluster.kill_host(name)
                except Exception:
                    pass
            try:
                pcluster.store_proc.kill()
                pcluster.store_proc.wait(timeout=10)
            except Exception:
                pass
            # the remaining phase-1 schedule has no region to land on:
            # abort so the workers stop burning retry backoff against a
            # dead region (their in-flight errors are already recorded)
            gen.abort()

        kill_thread = threading.Thread(target=killer, daemon=True)
        kill_thread.start()
        load1 = gen.run()
        kill_thread.join(timeout=60)
        completers.stop()
        load1.completed_churn = completers.completed

        # -- warm promotion: pre-flip hydration, then flip + regenerate --
        t_promote0 = time.monotonic()
        fm = FailoverManager(group)
        prehydration = fm._prehydrate(group.standby) or {}
        group.standby.frontend.update_domain(domain,
                                             active_cluster="standby")
        _refresh_domain_tasks(group.standby, domain)
        promote_s = time.monotonic() - t_promote0

        clients2 = [scluster.frontend(n) for n in standby_hosts]
        gen2 = LoadGenerator(clients2, schedule2, plans2, workers=workers,
                             request_salt="p2-")
        counter2 = {"n": 0}

        def completer_client2():
            counter2["n"] += 1
            return scluster.frontend(
                standby_hosts[counter2["n"] % len(standby_hosts)])

        completers2 = DecisionCompleters(completer_client2, [domain])
        completers2.start()
        load2 = gen2.run()
        drain_deadline = time.monotonic() + max(5.0, ttl * 4)
        last = -1
        while time.monotonic() < drain_deadline:
            time.sleep(0.5)
            if completers2.completed == last:
                break
            last = completers2.completed
        completers2.stop()
        load2.completed_churn = completers2.completed
        window = max(2 * duration_s, time.monotonic() - t_fleet0)

        end_scrape_standby = _host_metrics(scluster)
        verify_standby = (_verify_cluster_state(scluster, device)
                          if verify else None)

        # -- the killed region comes back: relaunch its store from the
        # WAL it crashed with (recover_stores fsck runs inside the store
        # server) and verify oracle↔device over the recovered state
        verify_primary = None
        if verify:
            rport = free_port()
            recover_proc = subprocess.Popen(
                [sys.executable, "-m", "cadence_tpu_torch.rpc.storeserver",
                 "--port", str(rport), "--wal", pcluster.wal,
                 "--device", device_name(device)], env=process_env())
            _wait_listening(rport, recover_proc)
            verify_primary = _verify_cluster_state(
                types.SimpleNamespace(store_port=rport), device)
    finally:
        if recover_proc is not None and recover_proc.poll() is None:
            recover_proc.kill()
            recover_proc.wait(timeout=10)
        group.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)

    # -- warm-promotion accounting: a stolen execution is warm when its
    # HBM state was snapshot-hydrated at the flip OR already resident via
    # the standby's device-speed apply; young (sub-snapshot-floor)
    # histories are reported, not charged (same convention as
    # cluster_serving_scenario)
    warm = (prehydration.get("hydrated", 0)
            + prehydration.get("already_resident", 0))
    cold = prehydration.get("cold", 0) + prehydration.get("stale", 0)
    steals = warm + cold
    hydration_ratio = (warm / steals) if steals > 0 else 0.0

    def _life_sum(scope, metric):
        """Whole-life counter: standby over its life + primary pre-kill."""
        return (_counter_delta(end_scrape_standby, {}, scope, metric)
                + _counter_delta(kill_scrape_primary, {}, scope, metric))

    serving_divergence = _life_sum(cm.SCOPE_TPU_SERVING,
                                   cm.M_SERVING_DIVERGENCE)
    migration_divergence = _life_sum(cm.SCOPE_TPU_MIGRATION,
                                     cm.M_MIG_DIVERGENCE)
    repl_device_divergence = _life_sum(cm.SCOPE_REPLICATION,
                                       cm.M_REPL_DEVICE_DIVERGENCE)
    snapshots_installed = _counter_delta(end_scrape_standby, {},
                                         cm.SCOPE_REPLICATION,
                                         cm.M_REPL_SNAP_INSTALLED)
    device_applied = _counter_delta(end_scrape_standby, {},
                                    cm.SCOPE_REPLICATION,
                                    cm.M_REPL_DEVICE_APPLIED)

    def events_of(scrapes, base, hosts):
        return (_counter_delta(scrapes, base, cm.SCOPE_TPU_RESIDENT,
                               cm.M_RESIDENT_EVENTS_APPENDED, hosts=hosts)
                + _counter_delta(scrapes, base, cm.SCOPE_TPU_REPLAY,
                                 cm.M_EVENTS_REPLAYED, hosts=hosts))

    events_primary = events_of(kill_scrape_primary, start_scrape_primary,
                               set(primary_hosts))
    events_standby = events_of(end_scrape_standby, start_scrape_standby,
                               set(standby_hosts))
    events_fleet = events_primary + events_standby

    pct2 = load2.percentiles(OP_SIGNAL)
    slos = [SLO(domain=domain, p99_ms=p99_slo_ms, max_error_rate=0.2)]
    slo_report = evaluate_slos(load2, slos)
    lag_bounded = 0 <= lag_doc["lag"] <= max_repl_lag

    doc = {
        "scenario": "region-failover",
        "run": {"duration_s": duration_s, "num_hosts": num_hosts,
                "num_shards": num_shards, "rps": rps,
                "pool_size": pool_size, "seed": seed,
                "kill_at_frac": kill_at_frac, "ttl": ttl,
                "workers": workers, "hydration_floor": hydration_floor,
                "max_repl_lag": max_repl_lag,
                "regions": {"primary": primary_hosts,
                            "standby": standby_hosts}},
        "traffic": {"active_phase": load1.as_dict(),
                    "promoted_phase": load2.as_dict()},
        "latency": {"promoted_signal_p50_ms": round(pct2["p50"] * 1000, 3),
                    "promoted_signal_p99_ms": round(pct2["p99"] * 1000, 3)},
        "slo": slo_report.as_dict(),
        "replication": {
            "lag_at_kill": lag_doc["lag"],
            "queue_tail_at_kill": lag_doc["tail"],
            "lag_bounded": lag_bounded,
            "snapshots_installed": snapshots_installed,
            "device_applied": device_applied,
        },
        "failover": {
            "promote_s": round(promote_s, 3),
            "prehydration": prehydration,
            "warm_steals": warm, "cold_steals": cold,
            "young_steals": prehydration.get("young", 0),
            "hydration_ratio": round(hydration_ratio, 4),
        },
        "parity": {
            "serving_divergence": serving_divergence,
            "migration_divergence": migration_divergence,
            "replication_device_divergence": repl_device_divergence,
        },
        "north_star": {
            "events_per_sec_fleet": round(events_fleet / window, 1),
            "events_per_sec_cluster": round(events_standby / window, 1),
            "events_per_sec_cluster_killed_region": round(
                events_primary / window, 1),
            "events_replayed_fleet": events_fleet,
            "window_s": round(window, 3),
        },
        "verify": {"promoted_region": verify_standby,
                   "killed_region_recovered": verify_primary},
    }
    doc["ok"] = bool(
        slo_report.ok
        and lag_bounded
        and steals > 0
        and hydration_ratio >= hydration_floor
        and snapshots_installed > 0
        and serving_divergence == 0
        and migration_divergence == 0
        and repl_device_divergence == 0
        and (verify_standby is None or verify_standby["divergent"] == 0)
        and (verify_primary is None or verify_primary["divergent"] == 0))
    return doc


def mixed_scenario(duration_s: float = 8.0, num_hosts: int = 2,
                   domains: Optional[List[str]] = None,
                   rps_per_domain: float = 3.0,
                   chaos_spec: str = "", seed: int = 20260803,
                   p99_slo_ms: float = 2500.0,
                   workers: int = 16, verify: bool = True,
                   pool_size: int = 6, num_shards: int = 8,
                   mix_name: str = "standard", device=None) -> dict:
    """Plain mixed-traffic run (no quotas): the `load run` CLI verb —
    the baseline latency-trajectory recorder. `mix_name` selects the
    traffic blend (mixes.MIXES — `query-heavy` drives the visibility
    read surface; set CADENCE_TPU_VISIBILITY=1 in the environment and
    the launched store server inherits it, serving those reads from the
    columnar device tier); visibility ops get their own per-op SLO rows
    so the read path is gated alongside the write path."""
    from .mixes import MIXES, VIS_OPS

    domains = list(domains or ["lg-a", "lg-b"])
    mix = MIXES.get(mix_name, STANDARD_MIX)
    plans = [DomainPlan(d, rps_per_domain, mix=mix,
                        pool_size=pool_size) for d in domains]
    schedule = build_schedule(plans, duration_s, seed)
    load, quota_metrics, verify_doc = _run_harness(
        plans, schedule, duration_s, num_hosts, num_shards, workers,
        chaos_spec, verify, device=device)

    slos = [SLO(p99_ms=p99_slo_ms, max_error_rate=0.2)]
    if any(mix.weights.get(op, 0) > 0 for op in VIS_OPS):
        slos += [SLO(op=op, p99_ms=p99_slo_ms, max_error_rate=0.0)
                 for op in VIS_OPS]
    slo_report = evaluate_slos(load, slos)
    doc = {
        "scenario": "mixed",
        "run": {"duration_s": duration_s, "num_hosts": num_hosts,
                "num_shards": num_shards, "seed": seed,
                "domains": domains, "rps_per_domain": rps_per_domain,
                "chaos": chaos_spec, "workers": workers,
                "mix": mix.name},
        "traffic": load.as_dict(),
        "admission": {"scrape": quota_metrics},
        "slo": slo_report.as_dict(),
        "verify": verify_doc,
    }
    doc["ok"] = bool(slo_report.ok
                     and (verify_doc is None
                          or verify_doc["divergent"] == 0))
    return doc


def visibility_scenario(duration_s: float = 4.0, rps: float = 60.0,
                        workers: int = 16, pool_size: int = 8,
                        seed: int = 20260804, num_shards: int = 4,
                        staleness_bound: int = 64, device=None) -> dict:
    """The device-visibility tier comparison (the tier's acceptance
    run): the SAME seeded query-heavy open-loop schedule driven twice
    against a fresh in-process cluster — device tier OFF (host dict/set
    indexes) then ON (columnar mask kernels, per-query parity gate) —
    recording per-op List/Scan/Count p50/p99, the device/fallback path
    mix, the recorded-staleness gauge, and the parity counters.

    The tier's contract, gated in `doc["ok"]`:
    - parity: every device-served query's result ids equal the host
      store's answer under the same lock (divergence counter 0;
      host fallbacks are COUNTED, never failures);
    - staleness: the observed appender backlog at query time stays
      under the configured bound (the flush keeps reads
      read-your-writes consistent);
    - the post-run oracle↔device verify stays green (visibility reads
      never perturb execution state)."""
    import os

    from ..engine.onebox import Onebox
    from ..utils import metrics as cm
    from .mixes import QUERY_HEAVY_MIX, VIS_OPS, trace_digest

    domain = "lg-vis"
    plans = [DomainPlan(domain, rps, mix=QUERY_HEAVY_MIX,
                        pool_size=pool_size)]
    schedule = build_schedule(plans, duration_s, seed)
    vis_ops_scheduled = sum(1 for op in schedule if op.kind in VIS_OPS)

    saved = {k: os.environ.get(k) for k in
             ("CADENCE_TPU_VISIBILITY", "CADENCE_TPU_VISIBILITY_PARITY",
              "CADENCE_TPU_VISIBILITY_STALENESS")}
    modes: Dict[str, dict] = {}
    try:
        for mode in ("off", "on"):
            os.environ["CADENCE_TPU_VISIBILITY"] = \
                "1" if mode == "on" else "0"
            os.environ["CADENCE_TPU_VISIBILITY_PARITY"] = "1"
            # the bound under test IS the view's configured bound:
            # queries inside it may serve the lagging view (parity
            # skipped there by design), past it they flush inline
            os.environ["CADENCE_TPU_VISIBILITY_STALENESS"] = \
                str(staleness_bound)
            box = Onebox(num_hosts=1, num_shards=num_shards, device=device)
            gen = LoadGenerator([box.frontend], schedule, plans,
                                workers=workers, pump=box.pump_once)
            gen.prepare(setup_deadline_s=120.0)
            if mode == "on":
                # warm the kernels OUTSIDE the measured window: one
                # pass over the seeded query pool launches every mask
                # plan the schedule will replay, and a write → drain →
                # query cycle launches the delta-scatter apply kernel
                # (deployment warmup, same discipline as the serving
                # scenario — a first launch mid-window would stall the
                # flush and smear the measured p99)
                from .generator import CHURN_TYPE, churn_task_list
                from .mixes import VIS_QUERIES
                info = box.stores.domain.by_name(domain)
                for q in VIS_QUERIES:
                    box.stores.visibility.query(info.domain_id, q)
                    box.stores.visibility.count(info.domain_id, q)
                box.frontend.start_workflow_execution(
                    domain, "lg-vis-warm", CHURN_TYPE,
                    churn_task_list(domain))
                box.pump_once()
                for q in VIS_QUERIES[:2]:
                    box.stores.visibility.query(info.domain_id, q)
            load = gen.run()
            pct_list = load.percentiles("list")
            pct_count = load.percentiles("count")
            t = load.totals(domain)
            reg = box.metrics
            sc = cm.SCOPE_TPU_VISIBILITY
            doc_mode = {
                "sent": t.sent, "ok": t.ok, "errors": t.errors,
                "duration_s": round(load.duration_s, 3),
                "list_p50_ms": round(pct_list["p50"] * 1000, 3),
                "list_p99_ms": round(pct_list["p99"] * 1000, 3),
                "count_p50_ms": round(pct_count["p50"] * 1000, 3),
                "count_p99_ms": round(pct_count["p99"] * 1000, 3),
            }
            if mode == "on":
                view = box.stores.visibility._device
                staleness = reg.histogram(sc, cm.M_VIS_STALENESS)
                doc_mode.update({
                    "visibility": view.stats() if view is not None
                    else {},
                    "staleness_observed_max": (view.staleness_max
                                               if view is not None else 0),
                    "staleness_served_max": (view.served_staleness_max
                                             if view is not None else 0),
                    "staleness_p99": round(staleness.percentile(0.99), 3),
                    "device_served": reg.counter(sc,
                                                 cm.M_VIS_DEVICE_SERVED),
                    "host_fallbacks": reg.counter(
                        sc, cm.M_VIS_HOST_FALLBACKS),
                    "parity_checks": reg.counter(sc,
                                                 cm.M_VIS_PARITY_CHECKS),
                    "parity_divergence": reg.counter(sc,
                                                     cm.M_VIS_DIVERGENCE),
                })
                if view is not None:
                    view.stop()
            verify = box.tpu.verify_all()
            doc_mode["verify"] = {"total": verify.total,
                                  "divergent": len(verify.divergent),
                                  "ok": bool(verify.ok)}
            modes[mode] = doc_mode
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    on, off = modes["on"], modes["off"]
    # the gate is on SERVED staleness: a query may observe a deeper
    # backlog, but it must flush before serving past the bound
    staleness_ok = on.get("staleness_served_max", 0) <= staleness_bound
    doc = {
        "scenario": "visibility",
        "run": {"duration_s": duration_s, "rps": rps, "workers": workers,
                "pool_size": pool_size, "seed": seed,
                "num_shards": num_shards,
                "staleness_bound": staleness_bound,
                "vis_ops_scheduled": vis_ops_scheduled,
                "trace_digest": trace_digest(schedule)},
        "off": off,
        "on": on,
        "comparison": {
            "list_p99_on_ms": on["list_p99_ms"],
            "list_p99_off_ms": off["list_p99_ms"],
            "device_served": on.get("device_served", 0),
            "host_fallbacks": on.get("host_fallbacks", 0),
            "parity_divergence": on.get("parity_divergence", 0),
            "staleness_p99": on.get("staleness_p99", 0.0),
            "staleness_observed_max": on.get("staleness_observed_max", 0),
            "staleness_served_max": on.get("staleness_served_max", 0),
            "staleness_ok": bool(staleness_ok),
        },
    }
    doc["ok"] = bool(
        on.get("parity_divergence", 0) == 0
        and on.get("device_served", 0) > 0
        and on.get("parity_checks", 0) > 0
        and staleness_ok
        and on["verify"]["divergent"] == 0
        and off["verify"]["divergent"] == 0)
    return doc
