"""Operator CLI (tools/cli/app.go analog).

The reference's `cadence` CLI talks gRPC to a running cluster; this
framework's cluster state is a durable WAL directory, so the CLI opens
the WAL (recovering state exactly like a restarted host), runs the
command against an in-process cluster, and appends any mutations back to
the same WAL — the same durability story a server would have.

    python -m cadence_tpu_torch --wal ./cluster.wal domain register --name dev
    python -m cadence_tpu_torch --wal ./cluster.wal workflow start \
        --domain dev --workflow-id wf-1 --type t --task-list tl
    python -m cadence_tpu_torch --wal ./cluster.wal workflow show \
        --domain dev --workflow-id wf-1
    python -m cadence_tpu_torch --wal ./cluster.wal admin verify

Output is JSON per command for scriptability (the reference CLI's
--format json mode).

Every verb that builds the cluster, or replays, runs on one device:
`--device` (or `main`'s `device`, which `--device` overrides), None
meaning the CUDA card. It is resolved once, by `device.resolve_device`;
without a card and without `--device cpu` such a verb exits non-zero
with that function's message and never falls back to the CPU. The wire
arms (`admin cluster --host`, `admin top --http`, `admin hostprof
--host`, `admin flightrec --host`), the schema verbs and `wal
scan/clean/fsck` build no cluster and need no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any


def _resolve_device(device):
    """The device the verb runs on (None: the card); without it, exit
    non-zero with resolve_device's message, never falling back."""
    from .device import resolve_device
    try:
        return resolve_device(device)
    except RuntimeError as exc:
        print(f"cadence-tpu: error: {exc}", file=sys.stderr)
        raise SystemExit(2)


def _build_cluster(wal: str, device):
    from .engine.durability import open_durable_stores, recover_stores
    from .engine.onebox import Onebox
    from .utils.clock import RealTimeSource

    if os.path.exists(wal):
        # commands verify explicitly (admin verify/scan); recovery itself
        # skips BOTH device passes — verification and the batched device
        # rebuild — so cheap reads (`domain list`) never pay a
        # whole-cluster device replay
        stores, report = recover_stores(wal, verify_on_device=False,
                                        rebuild_on_device=False,
                                        device=device)
    else:
        stores, report = open_durable_stores(wal), None
    # the wall clock, not the test clock: retention, cron, and timeouts
    # must actually elapse in CLI-driven clusters
    box = Onebox(num_hosts=1, num_shards=4, stores=stores,
                 time_source=RealTimeSource(), device=device)
    # replay persisted operator config (admin config-set WAL records)
    for key, value, domain in getattr(stores, "recovered_config", []):
        box.config.set(key, value, domain=domain)
    if report is not None and report.open_workflows:
        box.refresh_all_tasks()
    return box, report


def _emit(obj: Any) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True, default=str))


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cadence-tpu", description="cadence_tpu_torch operator CLI")
    parser.add_argument("--wal", default="",
                        help="cluster WAL path (durable state; required "
                             "for every group except `load`, which "
                             "launches its own wire cluster)")
    parser.add_argument("--device", default=None,
                        help="the device the cluster and its replays run "
                             "on (default: the CUDA card; `cpu` runs the "
                             "plain PyTorch versions)")
    sub = parser.add_subparsers(dest="group", required=True)

    # domain
    dom = sub.add_parser("domain").add_subparsers(dest="cmd", required=True)
    reg = dom.add_parser("register")
    reg.add_argument("--name", required=True)
    reg.add_argument("--retention", type=int, default=0)
    upd = dom.add_parser("update")
    upd.add_argument("--name", required=True)
    upd.add_argument("--retention", type=int, default=None)
    upd.add_argument("--description", default=None)
    upd.add_argument("--archival-uri", default=None)
    upd.add_argument("--active-cluster", default=None)
    upd.add_argument("--clusters", default=None,
                     help="comma-separated; can only grow")
    dep = dom.add_parser("deprecate")
    dep.add_argument("--name", required=True)
    dom.add_parser("list")

    # workflow
    wf = sub.add_parser("workflow").add_subparsers(dest="cmd", required=True)
    start = wf.add_parser("start")
    start.add_argument("--domain", required=True)
    start.add_argument("--workflow-id", required=True)
    start.add_argument("--type", required=True)
    start.add_argument("--task-list", required=True)
    start.add_argument("--cron", default="")
    for name in ("show", "describe"):
        p = wf.add_parser(name)
        p.add_argument("--domain", required=True)
        p.add_argument("--workflow-id", required=True)
        p.add_argument("--run-id", default=None)
    sig = wf.add_parser("signal")
    sig.add_argument("--domain", required=True)
    sig.add_argument("--workflow-id", required=True)
    sig.add_argument("--name", required=True)
    term = wf.add_parser("terminate")
    term.add_argument("--domain", required=True)
    term.add_argument("--workflow-id", required=True)
    term.add_argument("--reason", default="cli")
    lst = wf.add_parser("list")
    lst.add_argument("--domain", required=True)
    lst.add_argument("--closed", action="store_true")
    lst.add_argument("--query", default=None,
                     help="visibility query, e.g. \"WorkflowType = 'x' AND "
                          "CloseStatus = 'Completed'\"")
    cnt = wf.add_parser("count")
    cnt.add_argument("--domain", required=True)
    cnt.add_argument("--query", default="")
    bat = wf.add_parser("batch")
    bat.add_argument("--domain", required=True)
    bat.add_argument("--query", required=True)
    bat.add_argument("--op", required=True,
                     choices=("terminate", "cancel", "signal"))
    bat.add_argument("--name", default="", help="signal name (op=signal)")
    bat.add_argument("--reason", default="cli batch")
    bat.add_argument("--rps", type=float, default=50.0)
    sws = wf.add_parser("signalwithstart")
    sws.add_argument("--domain", required=True)
    sws.add_argument("--workflow-id", required=True)
    sws.add_argument("--type", required=True)
    sws.add_argument("--task-list", required=True)
    sws.add_argument("--name", required=True, help="signal name")

    # admin
    adm = sub.add_parser("admin").add_subparsers(dest="cmd", required=True)
    adm.add_parser("describe-cluster")
    dq = adm.add_parser("describe-queue")
    dq.add_argument("--shard-id", type=int, required=True)
    adm.add_parser("verify")
    scan = adm.add_parser("scan")
    scan.add_argument("--fix", action="store_true")
    adm.add_parser("scavenge")
    wd = adm.add_parser("watchdog")
    wd.add_argument("--fix", action="store_true")
    cg = adm.add_parser("config-get")
    cg.add_argument("--key", required=True)
    cs = adm.add_parser("config-set")
    cs.add_argument("--key", required=True)
    cs.add_argument("--value", required=True)
    adm.add_parser("schema-version")
    adm.add_parser("schema-migrate")
    # replication DLQ (tools/cli dlq read/purge/merge verbs)
    adm.add_parser("dlq-read")
    adm.add_parser("dlq-purge")
    adm.add_parser("dlq-merge")
    # DLQ observability rollup + redrive through the resender
    # (`admin dlq` / `admin dlq redrive`); --http runs the wire arm
    # against a live service host (admin_dlq op)
    dlqp = adm.add_parser("dlq")
    dlqp.add_argument("action", nargs="?", default="summary",
                      choices=("summary", "redrive"))
    dlqp.add_argument("--http", default="",
                      help="HOST:PORT of a live service host (wire arm)")
    fo = adm.add_parser("failover")
    fo.add_argument("--domain", required=True)
    fo.add_argument("--to", required=True, help="target active cluster")
    pr = adm.add_parser("profile")
    pr.add_argument("--out", default="/tmp/cadence_tpu_profile",
                    help="trace output directory (open with TensorBoard "
                         "or Perfetto)")
    pr.add_argument("--workflows", type=int, default=256)
    pr.add_argument("--events", type=int, default=100)
    res = adm.add_parser("resident")
    res.add_argument("--passes", type=int, default=2,
                     help="verify passes to run first (pass 1 seeds the "
                          "cache, pass 2 measures the warm hit rate; "
                          "0 = dump current stats only)")
    adm.add_parser("serving")
    adm.add_parser("visibility")
    clu = adm.add_parser("cluster")
    clu.add_argument("--host", action="append", default=[],
                     metavar="HOST:PORT",
                     help="live service host to query over the wire "
                          "(repeatable; per-host shard ownership, "
                          "migration counters, resident occupancy — "
                          "skips the WAL when given)")
    clu.add_argument("--detail", action="store_true",
                     help="include each resident row's payload CRC32 "
                          "(the migration byte-parity probe)")
    clu.add_argument("--drain", action="store_true",
                     help="run the planned-rebalance drain on every "
                          "--host first: persist a snapshot record for "
                          "each resident row, so a following kill or "
                          "rebalance is a warm failover")
    top = adm.add_parser("top")
    top.add_argument("--http", action="append", default=[],
                     metavar="[NAME=]HOST:PORT",
                     help="live host /timeseries endpoint to scrape "
                          "(repeatable; fleet utilization, binding "
                          "resource, burn rates — skips the WAL when "
                          "given)")
    hp = adm.add_parser("hostprof")
    hp.add_argument("--host", default="", metavar="HOST:PORT",
                    help="live service host to profile over the wire "
                         "(admin_hostprof op; skips the WAL)")
    hp.add_argument("--duration", type=float, default=0.5,
                    help="burst-sample window in seconds when the "
                         "target's profiler thread is not running")
    fr = adm.add_parser("flightrec")
    fr.add_argument("--host", default="", metavar="HOST:PORT",
                    help="live service host to query over the wire "
                         "(admin_flightrec op; skips the WAL)")
    fr.add_argument("--last", type=int, default=100,
                    help="trailing events to include")
    fr.add_argument("--dump", default="",
                    help="also dump the full ring to this JSONL path "
                         "(on the TARGET host in wire mode)")
    snp = adm.add_parser("snapshot")
    snp.add_argument("--sweep", action="store_true",
                     help="run one verify pass (seeding the resident "
                          "pool) then force-write snapshots for every "
                          "resident workflow before the rollup — the "
                          "warm-the-next-restart verb")

    # WAL tools (adminDBScan/adminDBClean analogs over the one backend)
    wal_grp = sub.add_parser("wal").add_subparsers(dest="cmd", required=True)
    wal_grp.add_parser("scan")
    wal_grp.add_parser("clean")
    # recovery fsck: typed findings over the raw stream + the rebuild
    wal_grp.add_parser("fsck")
    # kill-anywhere cut-point sweep (engine/crashsim.py)
    cs = wal_grp.add_parser("crashsim")
    cs.add_argument("--stride", type=int, default=1,
                    help="recover at every Nth record boundary (1 = all)")
    cs.add_argument("--no-torn", action="store_true",
                    help="skip torn mid-record tails (JSONL only)")
    cs.add_argument("--seed-workload", type=int, default=0, metavar="N",
                    help="record an N-workflow seeded workload into the "
                         "WAL first (refuses to overwrite an existing one)")

    # continuous canary (canary/cron.go)
    can = sub.add_parser("canary").add_subparsers(dest="cmd", required=True)
    crun = can.add_parser("run")
    crun.add_argument("--domain", default="canary")
    crun.add_argument("--cycles", type=int, default=10)
    crun.add_argument("--interval", type=float, default=0.0)

    # generative fuzzer (gen/fuzz.py, gen/shrink.py, gen/interleave.py):
    # seeded corpora over the full 13-decision surface, parity-gated on
    # oracle<->device checksums; shrink failures to minimal batch
    # sequences; promote interesting shapes into named bench specs
    fz = sub.add_parser("fuzz").add_subparsers(dest="cmd", required=True)
    fr = fz.add_parser("run")
    fr.add_argument("--seeds", type=int, default=50)
    fr.add_argument("--workflows", type=int, default=4,
                    help="workflows per seed (profiles rotate per slot)")
    fr.add_argument("--events", type=int, default=100)
    fr.add_argument("--profile", default="",
                    help="restrict to one profile (default: rotate all)")
    fr.add_argument("--interleave", action="store_true",
                    help="also run one seeded interleaving scenario "
                         "(serving tier + wire/store chaos + crashpoint "
                         "kills) and gate zero divergence")
    fr.add_argument("--interleave-seed", type=int, default=20260804)
    fr.add_argument("--replication", action="store_true",
                    help="also fuzz the replication seam (standby apply "
                         "pump + device twin vs live traffic, split-brain "
                         "NDC promotion, poison-task quarantine)")
    fr.add_argument("--replication-seed", type=int, default=20260806)
    fr.add_argument("--record", action="store_true",
                    help="write the next FUZZ_r0N.json in CWD")
    fr.add_argument("--out", default="",
                    help="explicit trajectory path (implies --record)")
    fs = fz.add_parser("shrink")
    fs.add_argument("--seed", type=int, required=True)
    fs.add_argument("--index", type=int, default=0)
    fs.add_argument("--events", type=int, default=100)
    fs.add_argument("--profile", default="mixed")
    fs.add_argument("--poison", default="",
                    help="inject a deterministic device-side defect on "
                         "this signal name (harness validation mode); "
                         "default: shrink a REAL parity divergence")
    # fleet chaos campaign (gen/cluster_chaos.py): seeded fault schedule
    # against a REAL multi-host wire cluster — SIGKILLs, store kill +
    # WAL-fsck + relaunch, asymmetric partitions, membership flaps —
    # gated on fault-free byte-identity, clean fsck, zero parity
    # divergence, closing verify_all (both regions with --regions 2)
    fc = fz.add_parser("cluster")
    fc.add_argument("--seed", type=int, default=20260806)
    fc.add_argument("--hosts", type=int, default=3)
    fc.add_argument("--shards", type=int, default=8)
    fc.add_argument("--workflows", type=int, default=6)
    fc.add_argument("--signals", type=int, default=2)
    fc.add_argument("--kills", type=int, default=1,
                    help="service hosts SIGKILLed mid-traffic")
    fc.add_argument("--store-kills", type=int, default=0,
                    help="store-server SIGKILL + fsck + relaunch cycles")
    fc.add_argument("--partitions", type=int, default=1,
                    help="asymmetric partition cut+heal pairs")
    fc.add_argument("--flaps", type=int, default=0,
                    help="membership flap (SIGSTOP past TTL, SIGCONT) arms")
    fc.add_argument("--profile", default="steady",
                    choices=["steady", "storm"])
    fc.add_argument("--regions", type=int, default=1, choices=[1, 2])
    fc.add_argument("--shrink", action="store_true",
                    help="harness-validation mode: shrink the injected "
                         "kill-then-signal regression to its 1-minimal "
                         "campaign (no cluster launched)")
    fc.add_argument("--shrink-on-failure", action="store_true",
                    help="on a REAL gate failure, ddmin the campaign to "
                         "a 1-minimal reproducer (expensive: each "
                         "predicate call is a baseline+chaos pair)")
    fc.add_argument("--record", action="store_true",
                    help="write the next CHAOS_r0N.json in CWD")
    fc.add_argument("--out", default="",
                    help="explicit trajectory path (implies --record)")
    fp = fz.add_parser("promote")
    fp.add_argument("--name", required=True)
    fp.add_argument("--seed", type=int, required=True)
    fp.add_argument("--workflows", type=int, default=64)
    fp.add_argument("--events", type=int, default=100)
    fp.add_argument("--profile", default="mixed")
    fp.add_argument("--note", default="")
    fp.add_argument("--root", default=".",
                    help="repo root holding fuzz_specs/")

    # open-loop load harness (bench/ + canary/ load tooling,
    # cadence_tpu_torch/loadgen/): launches a REAL wire cluster, drives seeded
    # open-loop traffic, evaluates latency SLOs, optionally records a
    # LOADGEN_r0N.json trajectory next to BENCH_r*.json
    load_grp = sub.add_parser("load").add_subparsers(dest="cmd",
                                                     required=True)
    # the serving-tier comparison (in-process, tier on vs off; records
    # decision-transaction p50/p99, launches/sec, coalescing factor)
    sv = load_grp.add_parser("serving")
    sv.add_argument("--duration", type=float, default=4.0)
    sv.add_argument("--rps", type=float, default=160.0,
                    help="scheduled decision-transaction arrival rate")
    sv.add_argument("--workers", type=int, default=16)
    sv.add_argument("--pool-size", type=int, default=12)
    sv.add_argument("--seed", type=int, default=20260803)
    sv.add_argument("--record", action="store_true",
                    help="write the next LOADGEN_r0N.json in CWD")
    sv.add_argument("--out", default="",
                    help="explicit trajectory path (implies --record)")
    # the device-visibility tier comparison (in-process, tier on vs
    # off on the query-heavy mix; records List/Count p50/p99, the
    # device/fallback path mix, staleness and parity counters)
    vis = load_grp.add_parser("visibility")
    vis.add_argument("--duration", type=float, default=4.0)
    vis.add_argument("--rps", type=float, default=60.0,
                     help="scheduled query-heavy arrival rate")
    vis.add_argument("--workers", type=int, default=16)
    vis.add_argument("--pool-size", type=int, default=8)
    vis.add_argument("--seed", type=int, default=20260804)
    vis.add_argument("--staleness-bound", type=int, default=64,
                     help="max appender backlog a query may observe")
    vis.add_argument("--record", action="store_true",
                     help="write the next LOADGEN_r0N.json in CWD")
    vis.add_argument("--out", default="",
                     help="explicit trajectory path (implies --record)")
    # the multi-host kill-mid-traffic migration scenario (wire cluster,
    # serving tier ON in every host; gates victim p99, zero divergence,
    # snapshot-hydrated steals >= the floor; records events/s/cluster)
    cl = load_grp.add_parser("cluster")
    cl.add_argument("--duration", type=float, default=12.0)
    cl.add_argument("--hosts", type=int, default=3)
    cl.add_argument("--rps", type=float, default=16.0,
                    help="scheduled victim-domain arrival rate")
    cl.add_argument("--pool-size", type=int, default=12)
    cl.add_argument("--kill-at", type=float, default=0.5,
                    help="kill the victim host at this fraction of the "
                         "run window")
    cl.add_argument("--workers", type=int, default=24)
    cl.add_argument("--seed", type=int, default=20260804)
    cl.add_argument("--p99-slo-ms", type=float, default=8000.0)
    cl.add_argument("--hydration-floor", type=float, default=0.8)
    cl.add_argument("--record", action="store_true",
                    help="write the next LOADGEN_r0N.json in CWD")
    cl.add_argument("--out", default="",
                    help="explicit trajectory path (implies --record)")
    # the two-region kill-the-active-region scenario (wire regions with
    # continuous replication + snapshot shipping; gates promoted-region
    # p99, bounded pre-kill lag, warm steals >= the floor, zero
    # divergence, both-region verify; records events/s/fleet)
    rg = load_grp.add_parser("region")
    rg.add_argument("--duration", type=float, default=10.0,
                    help="per traffic phase (active + promoted)")
    rg.add_argument("--hosts", type=int, default=2,
                    help="service hosts per region")
    rg.add_argument("--rps", type=float, default=10.0)
    rg.add_argument("--pool-size", type=int, default=12)
    rg.add_argument("--kill-at", type=float, default=0.6,
                    help="kill the active region at this fraction of "
                         "the phase-1 window")
    rg.add_argument("--workers", type=int, default=16)
    rg.add_argument("--seed", type=int, default=20260806)
    rg.add_argument("--p99-slo-ms", type=float, default=8000.0)
    rg.add_argument("--hydration-floor", type=float, default=0.8)
    rg.add_argument("--max-repl-lag", type=int, default=64,
                    help="max unconsumed replication tasks at the kill")
    rg.add_argument("--no-verify", action="store_true")
    rg.add_argument("--record", action="store_true",
                    help="write the next LOADGEN_r0N.json in CWD")
    rg.add_argument("--out", default="",
                    help="explicit trajectory path (implies --record)")
    for cmd_name in ("run", "overload"):
        lp = load_grp.add_parser(cmd_name)
        lp.add_argument("--duration", type=float, default=10.0)
        lp.add_argument("--hosts", type=int, default=2)
        lp.add_argument("--seed", type=int, default=20260803)
        lp.add_argument("--workers", type=int, default=24)
        lp.add_argument("--chaos", default="",
                        help="wire chaos spec for every process "
                             "(rpc/chaos.py), e.g. "
                             "'drop=0.04,sever=0.02,delay=0.1,seed=17'")
        lp.add_argument("--no-verify", action="store_true",
                        help="skip the post-run oracle<->device checksum "
                             "verification")
        lp.add_argument("--record", action="store_true",
                        help="write the next LOADGEN_r0N.json in CWD")
        lp.add_argument("--out", default="",
                        help="explicit trajectory path (implies --record)")
        if cmd_name == "run":
            lp.add_argument("--domains", default="lg-a,lg-b",
                            help="comma-separated domain names")
            lp.add_argument("--rps", type=float, default=3.0,
                            help="scheduled arrival rate per domain")
            lp.add_argument("--p99-slo-ms", type=float, default=2500.0)
            lp.add_argument("--mix", default="standard",
                            choices=("standard", "query-heavy"),
                            help="traffic blend (loadgen/mixes.MIXES); "
                                 "query-heavy drives List/Scan/Count — "
                                 "set CADENCE_TPU_VISIBILITY=1 and the "
                                 "store server serves them from the "
                                 "columnar device tier")
        else:
            lp.add_argument("--victim-rps", type=float, default=4.0)
            lp.add_argument("--aggressor-quota-rps", type=float,
                            default=4.0)
            lp.add_argument("--overdrive", type=float, default=2.0,
                            help="aggressor drive rate as a multiple of "
                                 "its quota")
            lp.add_argument("--victim-p99-slo-ms", type=float,
                            default=2500.0)
            lp.add_argument("--store-faults", default="",
                            help="store-fault spec injected into the "
                                 "STORE server process only "
                                 "(engine/faults.py), e.g. "
                                 "'rate=0.04,seed=13'")

    args = parser.parse_args(argv)
    if args.device is None:
        args.device = device
    if args.group == "fuzz":
        return _fuzz_tool(args)
    if args.group == "load":
        return _load_tool(args)
    if args.group == "admin" and args.cmd == "cluster" and args.host:
        # wire mode: roll up live hosts without opening any WAL
        return _cluster_tool(args)
    if args.group == "admin" and args.cmd == "top" and args.http:
        # fleet telemetry rollup over /timeseries scrapes: no WAL either
        return _top_tool(args)
    if args.group == "admin" and args.cmd in ("hostprof", "flightrec") \
            and args.host:
        return _telemetry_tool(args)
    if not args.wal:
        parser.error(f"--wal is required for the {args.group} group")
    if args.group == "wal":
        return _wal_tool(args)
    # schema tools run BEFORE cluster recovery (the cassandra/sql-tool
    # split: schema commands must work on logs recovery would refuse)
    if args.group == "admin" and args.cmd in ("schema-version",
                                              "schema-migrate"):
        from .engine.durability import (
            WAL_VERSION,
            migrate_wal_file,
            read_log,
            wal_version,
        )
        if args.cmd == "schema-version":
            current = (wal_version(read_log(args.wal))
                       if os.path.exists(args.wal) else None)
            _emit({"wal": args.wal, "version": current,
                   "binary_version": WAL_VERSION})
        else:
            if not os.path.exists(args.wal):
                _emit({"error": f"no WAL at {args.wal}"})
                return 1
            before, after = migrate_wal_file(args.wal)
            _emit({"migrated": args.wal, "from": before, "to": after})
        return 0
    box, _report = _build_cluster(args.wal, _resolve_device(args.device))
    from .engine.admin import AdminHandler
    admin = AdminHandler(box)

    if args.group == "domain":
        if args.cmd == "register":
            domain_id = box.frontend.register_domain(
                args.name, retention_days=args.retention)
            _emit({"registered": args.name, "domain_id": domain_id})
        elif args.cmd == "update":
            info = box.frontend.update_domain(
                args.name, retention_days=args.retention,
                description=args.description,
                history_archival_uri=args.archival_uri,
                active_cluster=args.active_cluster,
                clusters=(args.clusters.split(",") if args.clusters
                          else None))
            _emit({"updated": info.name,
                   "retention_days": info.retention_days,
                   "active_cluster": info.active_cluster,
                   "archival_uri": info.history_archival_uri,
                   "notification_version": info.notification_version})
        elif args.cmd == "deprecate":
            info = box.frontend.deprecate_domain(args.name)
            _emit({"deprecated": info.name})
        elif args.cmd == "list":
            _emit([{"name": d.name, "domain_id": d.domain_id,
                    "retention_days": d.retention_days,
                    "status": d.status}
                   for d in box.frontend.list_domains()])

    elif args.group == "workflow":
        if args.cmd == "start":
            run_id = box.frontend.start_workflow_execution(
                args.domain, args.workflow_id, args.type, args.task_list,
                cron_schedule=args.cron)
            box.pump_once()
            _emit({"started": args.workflow_id, "run_id": run_id})
        elif args.cmd == "show":
            events = box.frontend.get_workflow_execution_history(
                args.domain, args.workflow_id, args.run_id)
            _emit([{"id": e.id, "type": e.event_type.name,
                    "version": e.version, "attrs": e.attrs}
                   for e in events])
        elif args.cmd == "describe":
            _emit(admin.describe_workflow_execution(
                args.domain, args.workflow_id, args.run_id))
        elif args.cmd == "signal":
            box.frontend.signal_workflow_execution(
                args.domain, args.workflow_id, args.name)
            box.pump_once()
            _emit({"signaled": args.workflow_id})
        elif args.cmd == "terminate":
            box.frontend.terminate_workflow_execution(
                args.domain, args.workflow_id, reason=args.reason)
            box.pump_once()
            _emit({"terminated": args.workflow_id})
        elif args.cmd == "list":
            if args.query is not None:
                recs = box.frontend.list_workflow_executions(args.domain,
                                                             args.query)
            else:
                recs = (box.frontend.list_closed_workflow_executions(args.domain)
                        if args.closed else
                        box.frontend.list_open_workflow_executions(args.domain))
            _emit([{"workflow_id": r.workflow_id, "run_id": r.run_id,
                    "type": r.workflow_type, "close_status": r.close_status,
                    "search_attrs": {k: (v.decode("utf-8", "replace")
                                         if isinstance(v, bytes) else v)
                                     for k, v in r.search_attrs.items()}}
                   for r in recs])
        elif args.cmd == "count":
            _emit({"count": box.frontend.count_workflow_executions(
                args.domain, args.query)})
        elif args.cmd == "batch":
            from .engine.batcher import Batcher
            report = Batcher(box.frontend, rps=args.rps).run(
                args.domain, args.query, args.op, reason=args.reason,
                signal_name=args.name)
            box.pump_once()
            _emit({"total": report.total, "succeeded": report.succeeded,
                   "failed": report.failed, "failures": report.failures})
        elif args.cmd == "signalwithstart":
            run_id = box.frontend.signal_with_start_workflow_execution(
                args.domain, args.workflow_id, args.name, args.type,
                args.task_list)
            box.pump_once()
            _emit({"workflow_id": args.workflow_id, "run_id": run_id})

    elif args.group == "admin":
        if args.cmd == "describe-cluster":
            _emit(admin.describe_cluster())
        elif args.cmd == "describe-queue":
            _emit(admin.describe_queue(args.shard_id))
        elif args.cmd == "verify":
            result = admin.verify()
            _emit({"total": result.total,
                   "verified_on_device": result.verified_on_device,
                   "escalated": len(result.escalated),
                   "fallback": len(result.fallback),
                   "divergent": result.divergent, "ok": result.ok})
            return 0 if result.ok else 1
        elif args.cmd == "scan":
            report = box.scanner.run_once(fix=args.fix)
            _emit({"executions": report.executions,
                   "orphan_pointers": report.orphan_pointers,
                   "missing_history": report.missing_history,
                   "state_divergent": report.state_divergent,
                   "fixed": report.fixed, "ok": report.ok})
            return 0 if report.ok else 1
        elif args.cmd == "scavenge":
            _emit({"deleted": box.scavenger.run_once()})
        elif args.cmd == "watchdog":
            from .engine.workers import Watchdog
            report = Watchdog(box).run_once(fix=args.fix)
            _emit(report)
            return 0 if report["ok"] else 1
        elif args.cmd == "config-get":
            _emit({args.key: admin.get_dynamic_config(args.key)})
        elif args.cmd == "config-set":
            value: Any = args.value
            try:
                value = json.loads(args.value)
            except json.JSONDecodeError:
                pass
            admin.update_dynamic_config(args.key, value)
            # persist: later CLI invocations replay this record
            from .engine.durability import config_record
            box.stores.wal.append(config_record(args.key, value))
            _emit({args.key: value})
        elif args.cmd == "dlq-read":
            from .engine.replication import REPLICATION_DLQ
            entries = box.stores.queue.read(REPLICATION_DLQ, 0, 10_000)
            _emit([{"index": i, "workflow_id": e.task.workflow_id,
                    "run_id": e.task.run_id,
                    "first_event_id": e.task.first_event_id,
                    "next_event_id": e.task.next_event_id,
                    "error": e.error}
                   for i, e in entries])
        elif args.cmd == "dlq-purge":
            from .engine.replication import REPLICATION_DLQ
            _emit({"purged": box.stores.queue.purge(REPLICATION_DLQ)})
        elif args.cmd == "dlq-merge":
            # re-apply quarantined tasks; only still-failing ones remain
            # (dlq_handler.go merge semantics)
            from .engine.replication import (
                REPLICATION_DLQ,
                HistoryReplicator,
                ReplayError,
                RetryReplicationError,
            )
            replicator = HistoryReplicator(box.stores,
                                           rebuilder=box.rebuilder,
                                           notifier=box.notifier)
            entries = [e for _, e in box.stores.queue.read(
                REPLICATION_DLQ, 0, 10_000)]
            applied, still_failed = 0, []
            for entry in entries:
                try:
                    replicator.apply(entry.task)
                    applied += 1
                except (RetryReplicationError, ReplayError) as exc:
                    still_failed.append((entry, str(exc)))
            box.stores.queue.purge(REPLICATION_DLQ)
            for entry, _err in still_failed:
                box.stores.queue.enqueue(REPLICATION_DLQ, entry)
            _emit({"applied": applied, "still_failed": len(still_failed)})
        elif args.cmd == "dlq":
            if args.http:
                from .rpc.wire import call as wire_call
                h, p = args.http.rsplit(":", 1)
                _emit(wire_call((h, int(p)), ("admin_dlq", args.action),
                                timeout=60))
                return 0
            from .engine.replication import (
                HistoryReplicator,
                ReplicationPublisher,
                ReplicationTaskProcessor,
            )
            proc = ReplicationTaskProcessor(
                HistoryReplicator(box.stores, rebuilder=box.rebuilder,
                                  notifier=box.notifier),
                ReplicationPublisher(box.stores), box.stores, tpu=box.tpu)
            proc.metrics = box.metrics
            _emit(proc.redrive_dlq() if args.action == "redrive"
                  else proc.dlq_summary())
        elif args.cmd == "profile":
            # pprof → torch.profiler (SURVEY §5): capture a trace of a
            # representative replay on the box's device (the CPU, and
            # the card's kernels when it runs there); the trace
            # (*.pt.trace.json) opens in TensorBoard's profile plugin or
            # Perfetto
            import time as _time

            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)

            from .gen.corpus import generate_corpus
            from .ops.encode import LANE_EVENT_ID, encode_corpus
            from .native.wirec import pack_wirec_auto
            from .ops.replay import replay_wirec_to_crc

            histories = generate_corpus("basic",
                                        num_workflows=args.workflows,
                                        seed=1, target_events=args.events)
            events = encode_corpus(histories)
            corpus = pack_wirec_auto(events)
            dev = box.device
            arrs = (torch.from_numpy(corpus.slab).to(dev),
                    torch.from_numpy(corpus.bases).to(dev),
                    torch.from_numpy(corpus.n_events).to(dev))
            # warm (build and load the kernels outside the trace: the
            # trace should show the steady-state kernel, not the compiler)
            replay_wirec_to_crc(*arrs, corpus.profile,
                                box.config.payload_layout(),
                                device=dev)[0].cpu()
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=activities,
                         on_trace_ready=tensorboard_trace_handler(args.out)):
                t0 = _time.perf_counter()
                crc, _err = replay_wirec_to_crc(*arrs, corpus.profile,
                                                box.config.payload_layout(),
                                                device=dev)
                crc.cpu()
                wall = _time.perf_counter() - t0
            real = int((events[:, :, LANE_EVENT_ID] > 0).sum())
            # leg breakdown (pack/h2d/kernel/readback): run the same
            # corpus through the instrumented host path so the XLA trace
            # ships with the histogram decomposition of its launch; the
            # first pass pays the compile, then the registry is cleared so
            # `legs` reports only the warm steady-state launch
            from .ops.replay import replay_corpus
            from .utils.metrics import DEFAULT_REGISTRY
            from .utils.profiler import ReplayProfiler
            replay_corpus(histories, box.config.payload_layout(),
                          device=dev)  # warm
            DEFAULT_REGISTRY.reset()
            replay_corpus(histories, box.config.payload_layout(), device=dev)
            _emit({"trace_dir": args.out, "workflows": args.workflows,
                   "events": real, "wall_s": round(wall, 4),
                   "events_per_sec": round(real / wall),
                   # as JAX names the platform
                   "platform": "gpu" if dev.type == "cuda" else dev.type,
                   "legs": ReplayProfiler().summary()})
        elif args.cmd == "resident":
            # mirror of `admin profile` for the resident-state cache:
            # optional verify passes drive the cache (cold seed, then
            # warm hits), then the occupancy/hit-rate/budget rollup
            passes = []
            for _ in range(args.passes):
                r = admin.verify()
                passes.append({"total": r.total,
                               "verified_on_device": r.verified_on_device,
                               "resident_served": len(r.resident),
                               "ok": r.ok})
            _emit({"passes": passes, **admin.resident()})
        elif args.cmd == "serving":
            # the device-serving tier rollup (engine/serving.py):
            # coalescing factor, queue, path mix, parity counters
            _emit(admin.serving())
        elif args.cmd == "cluster":
            # in-process arm (no --host): the box's per-host shard
            # ownership + resident/migration rollup; --drain runs the
            # same planned-rebalance snapshot sweep the wire arm's
            # admin_drain op does (one verify pass seeds the pool
            # first, like `admin snapshot --sweep`)
            out = {}
            if args.drain:
                admin.verify()
                sweep = box.tpu.snapshot_sweep(force=True)
                out["drain"] = {"considered": sweep.considered,
                                "snapshotted": sweep.written,
                                "skipped": sweep.considered
                                - sweep.written}
            _emit({**out, **admin.cluster(detail=args.detail)})
        elif args.cmd == "visibility":
            # the device-visibility tier rollup
            # (engine/visibility_device.py): columns, backlog, path
            # mix, parity + compile-cache counters
            _emit(admin.visibility())
        elif args.cmd == "snapshot":
            # snapshot-tier rollup (engine/snapshot.py); --sweep first
            # seeds the resident pool via one verify pass and persists a
            # record per resident workflow (checksum-gated), then the
            # WAL carries a warm start for the next recovery
            out = {}
            if args.sweep:
                r = admin.verify()
                sweep = box.tpu.snapshot_sweep(force=True)
                out["sweep"] = {"verified_on_device":
                                r.verified_on_device,
                                "considered": sweep.considered,
                                "written": sweep.written,
                                "skipped_checksum":
                                sweep.skipped_checksum}
            _emit({**out, **admin.snapshot()})
        elif args.cmd == "top":
            # in-process arm: the box's sampler folds one more window
            # (build → now) and the summary renders from it
            _emit(admin.top())
        elif args.cmd == "hostprof":
            # in-process arm: burst-sample THIS process for --duration
            # and report the subsystem attribution + GIL estimate
            _emit(admin.hostprof(duration_s=args.duration))
        elif args.cmd == "flightrec":
            # in-process arm: whatever the box's workload emitted into
            # the process-global ring (CLI batch ops, fsck, breakers)
            _emit(admin.flightrec(last_n=args.last,
                                  dump=args.dump or None))
        elif args.cmd == "failover":
            # flip the domain active to --to on THIS cluster's metadata
            # and regenerate the promoted side's tasks (the CLI arm of
            # adminFailoverCommands; the managed coordinator is
            # engine/failovermanager.py over a cluster group)
            info = box.frontend.update_domain(args.domain,
                                              active_cluster=args.to)
            from .engine.task_refresher import sweep_refresh
            refreshed = sweep_refresh(box.stores, box.route, info.domain_id)
            _emit({"domain": args.domain, "active_cluster": args.to,
                   "failover_version": info.failover_version,
                   "tasks_refreshed": refreshed})

    elif args.group == "canary":
        from .engine.canary import Canary
        try:
            box.frontend.register_domain(args.domain)
        except Exception:
            pass  # already registered
        canary = Canary(box.frontend, args.domain, pump=box.pump_once)
        report = canary.run(args.cycles, interval_s=args.interval)
        _emit(report.summary())
        return 0 if report.ok else 1
    return 0


def _cluster_tool(args) -> int:
    """`admin cluster --host H:P [--host ...]` — the wire arm: each live
    ServiceHost answers the admin_cluster op with its shard ownership,
    serving/resident occupancy, and migration counters; --drain first
    runs the planned-rebalance snapshot sweep on every host."""
    from .rpc.wire import call as wire_call

    doc = {}
    rc = 0
    for spec in args.host:
        h, p = spec.rsplit(":", 1)
        address = (h, int(p))
        try:
            if args.drain:
                wire_call(address, ("admin_drain",), timeout=60)
            per_host = wire_call(address,
                                 ("admin_cluster", args.detail),
                                 timeout=30)
            if "resident_rows" in per_host:
                per_host["resident_rows"] = {
                    "|".join(k): v
                    for k, v in per_host["resident_rows"].items()}
            doc[spec] = per_host
        except Exception as exc:
            doc[spec] = {"error": f"{type(exc).__name__}: {exc}"}
            rc = 1
    _emit(doc)
    return rc


def _top_tool(args) -> int:
    """`admin top --http [NAME=]H:P [--http ...]` — the fleet arm: scrape
    every named host's /timeseries, summarize (utilization, binding
    resource, burn rates), aggregate cluster-wide. Exit 1 iff any host
    failed to scrape."""
    from .engine.admin import fleet_top

    endpoints = {}
    for spec in args.http:
        name, _, endpoint = spec.rpartition("=")
        endpoints[name or endpoint] = endpoint
    doc = fleet_top(endpoints)
    _emit(doc)
    return 1 if any("error" in s for s in doc["hosts"].values()) else 0


def _telemetry_tool(args) -> int:
    """`admin hostprof --host H:P` / `admin flightrec --host H:P` — the
    wire arms over the admin_hostprof / admin_flightrec ops."""
    from .rpc.wire import call as wire_call

    h, p = args.host.rsplit(":", 1)
    address = (h, int(p))
    try:
        if args.cmd == "hostprof":
            doc = wire_call(address, ("admin_hostprof", args.duration),
                            timeout=30)
        else:
            doc = wire_call(address,
                            ("admin_flightrec", args.last,
                             args.dump or None),
                            timeout=30)
    except Exception as exc:
        _emit({"host": args.host,
               "error": f"{type(exc).__name__}: {exc}"})
        return 1
    _emit(doc)
    return 0


def _fuzz_tool(args) -> int:
    """`fuzz run` / `fuzz shrink` / `fuzz promote` (gen/fuzz.py,
    gen/shrink.py, gen/interleave.py): exit 0 iff the run's gates held
    (zero oracle<->device divergence, all 13 decision types covered,
    clean interleaving when requested). `fuzz promote` only writes a
    spec and needs no device."""
    from .gen import fuzz as fuzz_mod

    device = (None if args.cmd == "promote"
              else _resolve_device(args.device))

    if args.cmd == "run":
        profiles = ((args.profile,) if args.profile
                    else fuzz_mod.PROFILES)
        doc = fuzz_mod.parity_run(
            seeds=args.seeds, workflows_per_seed=args.workflows,
            target_events=args.events, profiles=profiles, device=device)
        if args.interleave:
            from .gen.interleave import interleave_scenario
            ilv = interleave_scenario(seed=args.interleave_seed,
                                      device=device)
            doc["interleave"] = ilv
            doc["ok"] = bool(doc["ok"] and ilv["ok"])
        if args.replication:
            from .gen.interleave import replication_interleave_scenario
            rilv = replication_interleave_scenario(
                seed=args.replication_seed, device=device)
            doc["replication_interleave"] = rilv
            doc["ok"] = bool(doc["ok"] and rilv["ok"])
        if args.record or args.out:
            doc["trajectory"] = fuzz_mod.write_fuzz_trajectory(
                doc, path=args.out or None)
        _emit(doc)
        return 0 if doc["ok"] else 1

    if args.cmd == "cluster":
        from .gen import cluster_chaos as cc

        if args.shrink:
            # harness-validation arm: prove the campaign shrinker on
            # the injected kill-then-signal regression, no cluster
            campaign = cc.build_campaign(
                args.seed, num_workflows=args.workflows,
                signals_per_wf=args.signals, num_hosts=args.hosts,
                kills=max(1, args.kills), store_kills=args.store_kills,
                partitions=args.partitions, flaps=args.flaps,
                profile=args.profile)
            poison = cc.pick_poison_wf(campaign)
            if poison is None:
                _emit({"ok": False,
                       "note": "campaign has no signal after a kill — "
                               "pick another seed"})
                return 1
            report = cc.shrink_campaign(
                args.seed, cc.injected_regression_predicate(poison),
                num_workflows=args.workflows,
                signals_per_wf=args.signals, num_hosts=args.hosts,
                kills=max(1, args.kills), store_kills=args.store_kills,
                partitions=args.partitions, flaps=args.flaps,
                profile=args.profile)
            minimal = report.reproduce()
            _emit({"ok": report.shrunk_ops == 2, "poison_wf": poison,
                   "minimal_ops": [op.as_dict() for op in minimal],
                   **report.summary()})
            return 0 if report.shrunk_ops == 2 else 1

        doc = cc.cluster_campaign_scenario(
            seed=args.seed, num_hosts=args.hosts, num_shards=args.shards,
            num_workflows=args.workflows, signals_per_wf=args.signals,
            kills=args.kills, store_kills=args.store_kills,
            partitions=args.partitions, flaps=args.flaps,
            profile=args.profile, regions=args.regions,
            shrink_on_failure=args.shrink_on_failure, device=device)
        if args.record or args.out:
            doc["trajectory"] = cc.write_chaos_trajectory(
                doc, path=args.out or None)
        _emit(doc)
        return 0 if doc["ok"] else 1

    if args.cmd == "shrink":
        from .gen import shrink as shrink_mod
        predicate = (shrink_mod.poisoned_parity_predicate(args.poison,
                                                          device=device)
                     if args.poison
                     else shrink_mod.parity_predicate(device=device))
        full = fuzz_mod.generate_fuzz_history(args.seed, args.index,
                                              args.events, args.profile)
        if not predicate(full):
            _emit({"seed": args.seed, "workflow_index": args.index,
                   "profile": args.profile, "failing": False,
                   "note": "history does not fail the predicate — "
                           "nothing to shrink"})
            return 0
        report = shrink_mod.shrink_history(
            args.seed, args.index, predicate,
            target_events=args.events, profile=args.profile)
        _emit({"failing": True, **report.summary()})
        return 0

    # promote
    spec = fuzz_mod.make_spec(args.name, args.seed, args.workflows,
                              args.events, profile=args.profile,
                              note=args.note)
    path = fuzz_mod.save_spec(spec, root=args.root)
    _emit({"promoted": spec.name, "path": path, "seed": spec.seed,
           "workflows": spec.workflows, "target_events": spec.target_events,
           "profile": spec.profile, "digest": spec.digest})
    return 0


def _load_tool(args) -> int:
    """`load run` / `load overload` (cadence_tpu_torch/loadgen/scenarios.py):
    exit 0 iff the scenario's gate held (SLOs, shed ratio, zero
    checksum divergence)."""
    device = _resolve_device(args.device)
    from .loadgen import report as lg_report
    from .loadgen import scenarios

    if args.cmd == "serving":
        doc = scenarios.serving_scenario(
            duration_s=args.duration, rps=args.rps, workers=args.workers,
            pool_size=args.pool_size, seed=args.seed, device=device)
    elif args.cmd == "visibility":
        doc = scenarios.visibility_scenario(
            duration_s=args.duration, rps=args.rps, workers=args.workers,
            pool_size=args.pool_size, seed=args.seed,
            staleness_bound=args.staleness_bound, device=device)
    elif args.cmd == "cluster":
        doc = scenarios.cluster_serving_scenario(
            duration_s=args.duration, num_hosts=args.hosts, rps=args.rps,
            pool_size=args.pool_size, kill_at_frac=args.kill_at,
            seed=args.seed, p99_slo_ms=args.p99_slo_ms,
            workers=args.workers, hydration_floor=args.hydration_floor,
            device=device)
    elif args.cmd == "region":
        doc = scenarios.region_failover_scenario(
            duration_s=args.duration, num_hosts=args.hosts, rps=args.rps,
            pool_size=args.pool_size, kill_at_frac=args.kill_at,
            seed=args.seed, p99_slo_ms=args.p99_slo_ms,
            workers=args.workers, hydration_floor=args.hydration_floor,
            max_repl_lag=args.max_repl_lag, verify=not args.no_verify,
            device=device)
    elif args.cmd == "overload":
        doc = scenarios.overload_scenario(
            duration_s=args.duration, num_hosts=args.hosts,
            victim_rps=args.victim_rps,
            aggressor_quota_rps=args.aggressor_quota_rps,
            overdrive=args.overdrive, chaos_spec=args.chaos,
            store_fault_spec=args.store_faults,
            seed=args.seed, victim_p99_slo_ms=args.victim_p99_slo_ms,
            workers=args.workers, verify=not args.no_verify, device=device)
    else:
        doc = scenarios.mixed_scenario(
            duration_s=args.duration, num_hosts=args.hosts,
            domains=[d for d in args.domains.split(",") if d],
            rps_per_domain=args.rps, chaos_spec=args.chaos,
            seed=args.seed, p99_slo_ms=args.p99_slo_ms,
            workers=args.workers, verify=not args.no_verify,
            mix_name=args.mix, device=device)
    if args.record or args.out:
        path = lg_report.write_trajectory(doc, path=args.out or None)
        doc["trajectory"] = path
    _emit(doc)
    return 0 if doc["ok"] else 1


def _wal_tool(args) -> int:
    """WAL scan/clean (adminDBScanCommand/adminDBCleanCommand over the
    one WAL backend): scan reports record-type counts, schema version,
    unparseable lines, and tombstoned runs; clean rewrites the log
    dropping corrupt lines and records superseded by delete tombstones
    (atomic replace, like the schema migrator)."""
    import json as _json

    from .engine.durability import (
        WAL_VERSION,
        SchemaVersionError,
        SqliteLog,
        is_sqlite_path,
        migrate_records,
        version_record,
    )

    if args.cmd == "crashsim":
        from .engine.crashsim import CrashSim, seed_workload
        device = _resolve_device(args.device)
        if args.seed_workload:
            if os.path.exists(args.wal):
                _emit({"error": f"refusing to seed over existing WAL "
                                f"{args.wal}"})
                return 1
            seed_workload(args.wal, num_workflows=args.seed_workload,
                          device=device)
        if not os.path.exists(args.wal):
            _emit({"error": f"no WAL at {args.wal}"})
            return 1
        report = CrashSim(args.wal, device=device).run(
            torn=not args.no_torn, stride=args.stride)
        _emit(report.summary())
        return 0 if report.ok else 1

    if not os.path.exists(args.wal):
        _emit({"error": f"no WAL at {args.wal}"})
        return 1

    if args.cmd == "fsck":
        from .engine.walcheck import fsck
        report = fsck(args.wal)
        out = report.as_dict()
        if report.recovery is not None:
            out["executions_rebuilt"] = report.recovery.executions_rebuilt
            out["open_workflows"] = report.recovery.open_workflows
        _emit(out)
        return 0 if report.ok else 1
    records, bad = [], 0
    if is_sqlite_path(args.wal):
        raw_lines = SqliteLog.read_raw(args.wal)
    else:
        with open(args.wal, "r", encoding="utf-8") as fh:
            raw_lines = [l.strip() for l in fh if l.strip()]
    for line in raw_lines:
        try:
            records.append(_json.loads(line))
        except Exception:
            bad += 1
    by_type: dict = {}
    version = 1
    tombstoned = set()
    for rec in records:
        by_type[rec.get("t", "?")] = by_type.get(rec.get("t", "?"), 0) + 1
        if rec.get("t") == "ver":
            version = rec["v"]
        elif rec.get("t") == "delw":
            tombstoned.add((rec["d"], rec["w"], rec["r"]))

    if args.cmd == "scan":
        _emit({"wal": args.wal, "records": len(records),
               "bad_lines": bad, "schema_version": version,
               "binary_version": WAL_VERSION,
               "by_type": by_type, "tombstoned_runs": len(tombstoned),
               "bytes": os.path.getsize(args.wal)})
        return 0 if bad == 0 else 1

    # clean: drop corrupt lines + every record of a tombstoned run (and
    # the tombstone itself — replay without both is equivalent). Kept
    # records are MIGRATED to WAL_VERSION before the header is written:
    # positional labeling means anything under the header claims the
    # header's version, so rewriting a v1 prefix unmigrated would
    # re-label it current-version — exactly the corruption `wal fsck`
    # flags as stale-migration-label.
    def run_key(rec):
        if rec.get("t") in ("h", "f", "cb", "cur", "delw"):
            return (rec.get("d"), rec.get("w"), rec.get("r"))
        return None

    try:
        migrated, _original = migrate_records(records)
    except SchemaVersionError as exc:
        _emit({"error": str(exc)})
        return 1
    kept = [rec for rec in migrated if run_key(rec) not in tombstoned]
    if is_sqlite_path(args.wal):
        SqliteLog.rewrite(args.wal, [version_record()] + kept)
    else:
        tmp = args.wal + ".clean"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(_json.dumps(version_record(),
                                 separators=(",", ":")) + "\n")
            for rec in kept:
                fh.write(_json.dumps(rec, separators=(",", ":")) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, args.wal)
    _emit({"cleaned": args.wal, "dropped_bad_lines": bad,
           "dropped_records": len(records) - len(kept),
           "schema_version": WAL_VERSION, "kept": len(kept) + 1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
