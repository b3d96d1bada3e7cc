"""Durable persistence: write-ahead log + crash recovery by replay.

Reference seams:
- the persistence backends (common/persistence/nosql/, sql/) make every
  Cadence write durable; here ONE append-only JSONL log captures the
  event-sourced truth (history batches, branch forks, domain/shard
  metadata, current-run pointers, replication queue items);
- recovery = stateRebuilder.Rebuild (execution/state_rebuilder.go:102)
  over every run: mutable states are NOT persisted — they are rebuilt by
  replaying history through the oracle StateBuilder and bulk-VERIFIED on
  the TPU (tpu_engine.verify_all), the most TPU-native recovery path
  available.

The device half of recovery (the batched rebuild and the bulk verify) runs
on one device: `recover_stores(device=None)` means the card, and without
one it raises rather than recovering through the oracle; the CPU is used
only when the caller names it. `rebuild_on_device=False` with
`verify_on_device=False` is the pure-host oracle path and names no device.

Deliberate deviations (documented, test-asserted):
- transient activity attempt counters (retry without events) are not in
  history; after a crash a mid-retry activity restarts from attempt 0 —
  at-least-once execution is preserved, the attempt count is not;
- matching backlog and shard task queues are not logged: recovery
  regenerates every outstanding task from rebuilt state via the task
  refresher (engine/task_refresher.py), the same path standby promotion
  uses.

Log record types ("t"): "d" domain, "s" shard info, "h" history batch,
"f" branch fork, "cb" current-branch pointer, "cur" current-run pointer,
"q" queue item, "delw" retention tombstone (run deleted), "cfg" dynamic
config write.
"""
from __future__ import annotations

import base64
import json
import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..core.codec import deserialize_history, serialize_history
from ..core.events import HistoryBatch
from ..device import resolve_device
from ..oracle.mutable_state import (
    MutableState,
    VersionHistory,
    VersionHistoryItem,
)
from ..oracle.state_builder import StateBuilder
from . import crashpoints
from .persistence import (
    CurrentExecution,
    DomainInfo,
    ShardInfo,
    Stores,
)


class DurableLog:
    """Append-only JSONL write-ahead log (one per cluster store bundle)."""

    def __init__(self, path: str, fsync: bool = False) -> None:
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._heal_torn_tail(path)
        self._fh = open(path, "a", encoding="utf-8")

    @staticmethod
    def _heal_torn_tail(path: str) -> None:
        """Truncate a torn FINAL record before appending: a kill
        mid-append can leave a partial last line (with or without its
        newline), and appending straight after it would weld the next
        record onto garbage — converting a recoverable torn tail into
        permanent MID-file corruption on the following recovery."""
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            return
        with open(path, "rb") as fh:
            data = fh.read()
        keep = len(data)
        if not data.endswith(b"\n"):
            keep = data.rfind(b"\n") + 1  # drop the unterminated tail
        else:
            last_start = data.rfind(b"\n", 0, len(data) - 1) + 1
            try:
                json.loads(data[last_start:].decode("utf-8"))
            except Exception:
                keep = last_start  # newline-terminated but torn JSON
        if keep != len(data):
            with open(path, "r+b") as fh:
                fh.truncate(keep)
                fh.flush()
                os.fsync(fh.fileno())

    def append(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"))
        with self._lock:
            point = crashpoints.active()
            if point is not None:
                if point.should_fire(crashpoints.SITE_BEFORE_WRITE, record):
                    point.crash("no byte written")
                if point.should_fire(crashpoints.SITE_MID_RECORD, record):
                    # torn write: flush+fsync a PREFIX of the record so the
                    # partial line genuinely reaches recovery's read path
                    keep = max(1, int(len(line) * point.torn_fraction))
                    self._fh.write(line[:keep])
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    point.crash(f"torn after {keep}/{len(line)} bytes")
            self._fh.write(line + "\n")
            self._fh.flush()
            if point is not None and point.should_fire(
                    crashpoints.SITE_AFTER_WRITE, record):
                point.crash("flushed, not fsynced")
            if self.fsync:
                os.fsync(self._fh.fileno())
            if point is not None and point.should_fire(
                    crashpoints.SITE_AFTER_FSYNC, record):
                point.crash("durable")

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    @staticmethod
    def read_all(path: str) -> List[dict]:
        """Parse the log. A torn FINAL line (kill mid-append, partial OS
        write) is dropped — standard WAL recovery; corruption anywhere
        else is a real error and raises."""
        with open(path, "r", encoding="utf-8") as fh:
            lines = [l.strip() for l in fh]
        lines = [l for l in lines if l]
        records = []
        for i, line in enumerate(lines):
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn trailing record: recover up to it
                raise CorruptLogError(
                    f"{path}: corrupt record at line {i + 1} "
                    f"(not the final line — refusing to recover past it)")
        return records


class CorruptLogError(Exception):
    """Mid-file WAL corruption (not a torn tail)."""


class SqliteLog:
    """SQLite-backed write-ahead log: the second storage backend (the
    reference's sql persistence plugin next to nosql,
    common/persistence/sql/). Same append/read_all/close contract as the
    JSONL DurableLog — selected by path extension (.db/.sqlite/.sqlite3)
    in open_log — with single-file transactional durability: appends
    commit atomically, so there is no torn-tail case at all, and a
    corrupt row anywhere is a real error."""

    def __init__(self, path: str, fsync: bool = False) -> None:
        import sqlite3
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            f"PRAGMA synchronous={'FULL' if fsync else 'NORMAL'}")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS records ("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, body TEXT NOT NULL)")
        self._conn.commit()

    def append(self, record: dict) -> None:
        body = json.dumps(record, separators=(",", ":"))
        with self._lock:
            point = crashpoints.active()
            if point is not None and point.should_fire(
                    crashpoints.SITE_BEFORE_WRITE, record):
                point.crash("no row inserted")
            self._conn.execute("INSERT INTO records(body) VALUES (?)",
                               (body,))
            # transactional backend: "mid-record" dies between INSERT and
            # COMMIT — the row vanishes, SQLite's whole torn-write story
            if point is not None and point.should_fire(
                    crashpoints.SITE_MID_RECORD, record):
                self._conn.rollback()  # the dying process's txn is lost
                point.crash("inserted, not committed")
            self._conn.commit()
            for site in (crashpoints.SITE_AFTER_WRITE,
                         crashpoints.SITE_AFTER_FSYNC):
                if point is not None and point.should_fire(site, record):
                    point.crash("committed")

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    @staticmethod
    def read_raw(path: str) -> List[str]:
        """Committed record bodies in order (the tolerant read the CLI's
        wal scan shares — one copy of the SELECT, not two)."""
        import sqlite3
        conn = sqlite3.connect(path)
        try:
            return [body for (body,) in conn.execute(
                "SELECT body FROM records ORDER BY id").fetchall()]
        finally:
            conn.close()

    @staticmethod
    def read_all(path: str) -> List[dict]:
        records = []
        for i, body in enumerate(SqliteLog.read_raw(path)):
            try:
                records.append(json.loads(body))
            except json.JSONDecodeError:
                # committed rows are never torn — any corruption is real
                raise CorruptLogError(f"{path}: corrupt record at row {i}")
        return records

    @staticmethod
    def rewrite(path: str, records: List[dict]) -> None:
        """Atomic whole-log rewrite (migration/compaction): build a fresh
        database beside the old one, then rename over it."""
        import sqlite3
        tmp = path + ".rewrite"
        if os.path.exists(tmp):
            os.remove(tmp)
        conn = sqlite3.connect(tmp)
        try:
            conn.execute(
                "CREATE TABLE records (id INTEGER PRIMARY KEY "
                "AUTOINCREMENT, body TEXT NOT NULL)")
            conn.executemany(
                "INSERT INTO records(body) VALUES (?)",
                [(json.dumps(r, separators=(",", ":")),) for r in records])
            conn.commit()
        finally:
            conn.close()
        os.replace(tmp, path)
        dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                         os.O_RDONLY)
        try:
            os.fsync(dir_fd)  # commit the rename itself (same contract
            # as the JSONL migrate path)
        finally:
            os.close(dir_fd)


def is_sqlite_path(path: str) -> bool:
    return path.endswith((".db", ".sqlite", ".sqlite3"))


def open_log(path: str, fsync: bool = False):
    """The storage-plugin seam (persistence factory by config): backend
    chosen by path extension — .db/.sqlite* → SqliteLog, else JSONL."""
    return (SqliteLog(path, fsync=fsync) if is_sqlite_path(path)
            else DurableLog(path, fsync=fsync))


def read_log(path: str) -> List[dict]:
    return (SqliteLog.read_all(path) if is_sqlite_path(path)
            else DurableLog.read_all(path))


# ---------------------------------------------------------------------------
# Schema versioning + migration (the cadence-cassandra-tool/sql-tool analog:
# versioned schema dirs + manifest.json, tools/cassandra/handler.go:47)
# ---------------------------------------------------------------------------

#: current WAL record-schema version. History: v1 = the first record set;
#: v2 = domain records carry status/description/archival-uri fields;
#: v3 = the persisted mutable-state snapshot tier's "snap" records
#: (engine/snapshot.py) join the record set.
WAL_VERSION = 3


def version_record() -> dict:
    return {"t": "ver", "v": WAL_VERSION}


class SchemaVersionError(Exception):
    """WAL written by a NEWER schema than this binary understands —
    refusing beats silently dropping fields (setup-schema version gate)."""


def _migrate_1_to_2(rec: dict) -> dict:
    """v1→v2: domain records gain status/description/archival-uri."""
    if rec.get("t") == "d":
        rec.setdefault("st", 0)
        rec.setdefault("desc", "")
        rec.setdefault("arc", "")
    return rec


def _migrate_2_to_3(rec: dict) -> dict:
    """v2→v3: purely additive — v3 introduces the snapshot tier's "snap"
    record type, which no v2 log can contain; existing record bodies are
    already current-format."""
    return rec


#: from-version → record transform producing from-version+1 records
_MIGRATIONS = {1: _migrate_1_to_2, 2: _migrate_2_to_3}


def wal_version(records: List[dict]) -> int:
    """The log's schema version: the header record, or 1 for pre-header
    logs (version records may also appear mid-file after upgrades — the
    LAST one wins, matching append-only semantics)."""
    version = 1
    for rec in records:
        if rec.get("t") == "ver":
            version = rec["v"]
    return version


def migrate_records(records: List[dict]) -> Tuple[List[dict], int]:
    """Lift records to WAL_VERSION in memory (update-schema's versioned
    upgrade chain); returns (records, original_version).

    Migration is POSITIONAL: each record lifts from the version in effect
    at its place in the file (the last header seen so far; pre-header
    records are v1). A mixed log — an old prefix plus current-format
    records appended after recovery stamps a mid-file header — migrates
    only the prefix, so migrations need not be idempotent."""
    version = wal_version(records)
    if version > WAL_VERSION:
        raise SchemaVersionError(
            f"WAL schema v{version} is newer than this binary's "
            f"v{WAL_VERSION}; upgrade the binary, not the data")
    original = version
    body: List[dict] = []
    effective = 1
    for rec in records:
        if rec.get("t") == "ver":
            effective = rec["v"]
            continue
        v = effective
        if v < WAL_VERSION:
            rec = dict(rec)
            while v < WAL_VERSION:
                rec = _MIGRATIONS[v](rec)
                v += 1
        body.append(rec)
    return body, original


def migrate_wal_file(path: str) -> Tuple[int, int]:
    """Rewrite the log at WAL_VERSION (the schema tool's update-schema):
    atomic replace, with the version header first. Returns
    (from_version, to_version)."""
    records = read_log(path)
    body, original = migrate_records(records)
    if is_sqlite_path(path):
        SqliteLog.rewrite(path, [version_record()] + body)
        return original, WAL_VERSION
    tmp = path + ".migrate"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(version_record(), separators=(",", ":")) + "\n")
        for rec in body:
            fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        fh.flush()
        os.fsync(fh.fileno())  # the rewrite touches EVERY record: a
        # power loss must never replace an intact log with a torn one
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    try:
        os.fsync(dir_fd)  # commit the rename itself
    finally:
        os.close(dir_fd)
    return original, WAL_VERSION


# -- record constructors (shared by stores and recovery) --------------------


def history_record(domain_id: str, workflow_id: str, run_id: str,
                   branch: int, events) -> dict:
    blob = serialize_history([HistoryBatch(
        domain_id=domain_id, workflow_id=workflow_id, run_id=run_id,
        events=list(events))])
    return history_record_from_blob(domain_id, workflow_id, run_id, branch,
                                    blob)


def history_record_from_blob(domain_id: str, workflow_id: str, run_id: str,
                             branch: int, blob: bytes) -> dict:
    """The commit path serializes its batch exactly once (for history-size
    accounting) and hands the bytes down here — never a second
    serialize_history pass per transaction."""
    return {"t": "h", "d": domain_id, "w": workflow_id, "r": run_id,
            "b": branch, "blob": base64.b64encode(blob).decode("ascii")}


def fork_record(domain_id: str, workflow_id: str, run_id: str,
                source: int, fork_event_id: int) -> dict:
    return {"t": "f", "d": domain_id, "w": workflow_id, "r": run_id,
            "src": source, "at": fork_event_id}


def current_branch_record(domain_id: str, workflow_id: str, run_id: str,
                          branch: int) -> dict:
    return {"t": "cb", "d": domain_id, "w": workflow_id, "r": run_id,
            "b": branch}


def delete_run_record(domain_id: str, workflow_id: str, run_id: str) -> dict:
    return {"t": "delw", "d": domain_id, "w": workflow_id, "r": run_id}


def snapshot_record(rec) -> dict:
    """Persisted mutable-state snapshot (engine/snapshot.SnapshotRecord
    → WAL "snap" record, a v3 type): the device ReplayState row blob,
    canonical payload, content address, interner snapshot, and layout
    signature — everything a cold path needs to hydrate + replay only
    the since-snapshot suffix."""
    import numpy as _np
    return {
        "t": "snap", "d": rec.key[0], "w": rec.key[1], "r": rec.key[2],
        "n": int(rec.batch_count), "crc": int(rec.last_batch_crc),
        "ev": int(rec.events), "hs": int(rec.history_size),
        "b": int(rec.branch),
        "pay": base64.b64encode(
            _np.asarray(rec.payload, dtype=_np.int64).tobytes()
        ).decode("ascii"),
        "blob": base64.b64encode(rec.state_blob).decode("ascii"),
        "bc": int(rec.blob_crc), "im": dict(rec.interner),
        "lay": list(rec.layout), "sv": int(rec.version),
    }


def snapshot_from_record(rec: dict):
    """Inverse of snapshot_record; raises on malformed bodies (recovery
    catches and IGNORES — a doctored snapshot must never wedge a
    restart, it just costs that run its warm start)."""
    import numpy as _np

    from .snapshot import SnapshotRecord
    return SnapshotRecord(
        key=(rec["d"], rec["w"], rec["r"]),
        batch_count=int(rec["n"]), last_batch_crc=int(rec["crc"]),
        events=int(rec["ev"]), history_size=int(rec["hs"]),
        branch=int(rec["b"]),
        payload=_np.frombuffer(base64.b64decode(rec["pay"]),
                               dtype=_np.int64).copy(),
        state_blob=base64.b64decode(rec["blob"]),
        blob_crc=int(rec["bc"]),
        interner={str(k): int(v) for k, v in rec["im"].items()},
        layout=tuple(int(v) for v in rec["lay"]),
        version=int(rec["sv"]))


def config_record(key: str, value, domain=None) -> dict:
    """Dynamic-config write (the configstore analog): the CLI persists
    operator config changes so every later invocation sees them."""
    return {"t": "cfg", "k": key, "v": value, "dom": domain}


def domain_record(info: DomainInfo) -> dict:
    return {"t": "d", "id": info.domain_id, "name": info.name,
            "ret": info.retention_days, "act": info.is_active,
            "ac": info.active_cluster, "cl": list(info.clusters),
            "fv": info.failover_version, "nv": info.notification_version,
            "st": info.status, "desc": info.description,
            "arc": info.history_archival_uri}


def shard_record(info: ShardInfo) -> dict:
    rec = {"t": "s", "id": info.shard_id, "o": info.owner,
           "rg": info.range_id, "ta": info.transfer_ack_level,
           "tm": info.timer_ack_level, "ra": info.replication_ack_level}
    if info.transfer_queue_states:
        rec["qs"] = [list(q) for q in info.transfer_queue_states]
    return rec


def current_run_record(domain_id: str, workflow_id: str,
                       cur: CurrentExecution) -> dict:
    return {"t": "cur", "d": domain_id, "w": workflow_id, "r": cur.run_id,
            "st": cur.state, "cs": cur.close_status}


def queue_record(queue: str, payload) -> dict:
    from dataclasses import asdict

    from .crosscluster import CrossClusterTask
    from .domainrepl import DomainReplicationTask
    from .replication import DLQEntry, ReplicationTask, ShippedSnapshotTask
    if isinstance(payload, ReplicationTask):
        body = _repl_task_dict(payload)
        kind = "task"
    elif isinstance(payload, ShippedSnapshotTask):
        # snapshot-shipping replication: the shipped record reuses the
        # "snap" body format, wrapped with its source-cluster tag
        body = {"src": payload.source_cluster,
                "rec": snapshot_record(payload.record)}
        kind = "snapship"
    elif isinstance(payload, DLQEntry):
        body = {"task": _repl_task_dict(payload.task), "err": payload.error}
        kind = "dlq"
    elif isinstance(payload, DomainReplicationTask):
        body = dict(asdict(payload), clusters=list(payload.clusters))
        kind = "domain"
    elif isinstance(payload, CrossClusterTask):
        body = asdict(payload)
        kind = "xc"
    else:
        raise TypeError(
            f"queue payload {type(payload).__name__} is not durable — "
            "add a serializer before enqueueing it on a durable cluster")
    return {"t": "q", "q": queue, "k": kind, "p": body}


def queue_ack_record(queue: str, consumer: str, index: int) -> dict:
    """Consumer ack level (persistence/queue.go UpdateAckLevel analog)."""
    return {"t": "qa", "q": queue, "c": consumer, "i": index}


def queue_purge_record(queue: str) -> dict:
    """DLQ purge tombstone: recovery replays the purge in order."""
    return {"t": "qp", "q": queue}


def _repl_task_dict(task) -> dict:
    return {"d": task.domain_id, "w": task.workflow_id, "r": task.run_id,
            "f": task.first_event_id, "n": task.next_event_id,
            "v": task.version,
            "blob": base64.b64encode(task.events_blob).decode("ascii"),
            "vh": list(map(list, task.version_history_items))}


def _repl_task_from(body: dict):
    from .replication import ReplicationTask
    return ReplicationTask(
        domain_id=body["d"], workflow_id=body["w"], run_id=body["r"],
        first_event_id=body["f"], next_event_id=body["n"], version=body["v"],
        events_blob=base64.b64decode(body["blob"]),
        version_history_items=tuple(map(tuple, body["vh"])))


# -- recovery ---------------------------------------------------------------


@dataclass
class RecoveryReport:
    executions_rebuilt: int = 0
    open_workflows: int = 0
    #: how many states were rebuilt by DEVICE replay + hydration vs the
    #: oracle fallback (engine/rebuild.py) — the TPU engine is the primary
    #: recovery rebuilder, not just the verifier
    device_rebuilt: int = 0
    rebuild_fallback: int = 0
    #: runs whose rebuild hydrated a persisted snapshot and replayed
    #: only the since-snapshot suffix (the warm-restart counter)
    snapshot_hydrated: int = 0
    device_verified: int = 0
    oracle_fallback: int = 0
    divergent: List[Tuple[str, str, str]] = field(default_factory=list)
    #: open runs whose history was never referenced by any current-run
    #: record — orphan tails of starts that crashed before the
    #: create_workflow commit point, or NDC zombies. Their state is kept
    #: (rebuildable, harmless) but they are not counted open, get no
    #: visibility records, and the task refresher never dispatches them.
    quarantined: List[Tuple[str, str, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.divergent


def open_durable_stores(path: str) -> Stores:
    """Fresh cluster bundle logging to `path` (creates/extends the log);
    new logs start with the schema-version header."""
    import os as _os
    fresh = not _os.path.exists(path) or not read_log(path)
    stores = Stores()
    wal = open_log(path)
    if fresh:
        wal.append(version_record())
    stores.attach_wal(wal)
    return stores


def recover_stores(path: str, verify_on_device: bool = True,
                   layout=None, rebuild_on_device: bool = True, device=None
                   ) -> Tuple[Stores, RecoveryReport]:
    """Rebuild a cluster's stores from its write-ahead log.

    1. replay the log: domains, shard infos, history branches (appends +
       forks in original order), pointers, queue items;
    2. rebuild every run's mutable state by replaying its CURRENT branch
       through the oracle StateBuilder (state_rebuilder.go:102), grafting
       the full branch set back onto the version histories;
    3. bulk-verify the rebuilt states on the TPU (zero-divergence check).

    The caller re-acquires shards (bumping range IDs past the dead
    owner's) and runs the task refresher for open workflows.

    Steps 2-3 run on `device` (None: the card, raising without one) unless
    both `rebuild_on_device` and `verify_on_device` are off.
    """
    if rebuild_on_device or verify_on_device:
        device = resolve_device(device)
    stores = Stores()
    stores.recovered_config = []
    #: every run a current-run record EVER referenced (not just the final
    #: pointer): a run with history but no reference is an orphan tail of
    #: a start that died before its create_workflow commit point
    referenced_runs = set()
    # schema gate + in-memory migration (the setup/update-schema contract):
    # older logs lift transparently; NEWER logs refuse
    records, _original = migrate_records(read_log(path))
    for rec in records:
        t = rec["t"]
        if t == "d":
            info = DomainInfo(
                domain_id=rec["id"], name=rec["name"],
                retention_days=rec["ret"], is_active=rec["act"],
                active_cluster=rec["ac"], clusters=tuple(rec["cl"]),
                failover_version=rec["fv"],
                notification_version=rec["nv"],
                status=rec.get("st", 0), description=rec.get("desc", ""),
                history_archival_uri=rec.get("arc", ""))
            try:
                stores.domain.register(info)
            except Exception:
                stores.domain.update(info)
        elif t == "s":
            stores.shard.restore(ShardInfo(
                shard_id=rec["id"], owner=rec["o"], range_id=rec["rg"],
                transfer_ack_level=rec["ta"], timer_ack_level=rec["tm"],
                replication_ack_level=rec["ra"],
                transfer_queue_states=[list(q)
                                       for q in rec.get("qs", [])]))
        elif t == "h":
            batches = deserialize_history(
                base64.b64decode(rec["blob"]), rec["d"], rec["w"], rec["r"])
            for batch in batches:
                stores.history.append_batch(rec["d"], rec["w"], rec["r"],
                                            batch.events, branch=rec["b"])
        elif t == "f":
            stores.history.fork_branch(rec["d"], rec["w"], rec["r"],
                                       source_branch=rec["src"],
                                       fork_event_id=rec["at"])
        elif t == "cb":
            stores.history.set_current_branch(rec["d"], rec["w"], rec["r"],
                                              rec["b"])
        elif t == "delw":
            # retention tombstone: the run's history and snapshot stay
            # dead (delete_run's snapshot-store hook drops any persisted
            # device-state snapshot too — derived invalidation)
            stores.history.delete_run(rec["d"], rec["w"], rec["r"])
            stores.execution.delete_workflow(rec["d"], rec["w"], rec["r"])
        elif t == "snap":
            # persisted device-state snapshot: install the LATEST record
            # per run. Replay order makes invalidation derived state — a
            # later tail overwrite / branch switch / delete record drops
            # it through the same history-store hooks the live engine
            # uses. A malformed body is ignored (that run simply cold
            # starts); hydration re-validates blob CRC + layout anyway.
            try:
                stores.snapshot.restore(snapshot_from_record(rec))
            except Exception:
                pass
        elif t == "cfg":
            stores.recovered_config.append(
                (rec["k"], rec["v"], rec.get("dom")))
        elif t == "cur":
            referenced_runs.add((rec["d"], rec["w"], rec["r"]))
            stores.execution.restore_current(
                rec["d"], rec["w"],
                CurrentExecution(run_id=rec["r"], state=rec["st"],
                                 close_status=rec["cs"]))
        elif t == "qa":
            stores.queue.set_ack(rec["q"], rec["c"], rec["i"])
        elif t == "qp":
            stores.queue.purge(rec["q"])
        elif t == "q":
            if rec["k"] == "task":
                stores.queue.enqueue(rec["q"], _repl_task_from(rec["p"]))
            elif rec["k"] == "domain":
                from .domainrepl import DomainReplicationTask
                body = dict(rec["p"])
                body["clusters"] = tuple(body["clusters"])
                stores.queue.enqueue(rec["q"], DomainReplicationTask(**body))
            elif rec["k"] == "xc":
                from .crosscluster import CrossClusterTask
                stores.queue.enqueue(rec["q"], CrossClusterTask(**rec["p"]))
            elif rec["k"] == "snapship":
                from .replication import ShippedSnapshotTask
                try:
                    stores.queue.enqueue(rec["q"], ShippedSnapshotTask(
                        record=snapshot_from_record(rec["p"]["rec"]),
                        source_cluster=rec["p"].get("src", "")))
                except Exception:
                    pass  # malformed shipped record: the consumer's own
                    # torn/foreign gates would have ignored it anyway
            else:
                from .replication import DLQEntry
                stores.queue.enqueue(rec["q"], DLQEntry(
                    task=_repl_task_from(rec["p"]["task"]),
                    error=rec["p"]["err"]))

    report = _rebuild_executions(stores, verify_on_device, layout,
                                 referenced_runs, rebuild_on_device, device)
    _reconcile_current_pointers(stores)
    # new writes continue the same log (records are idempotent to replay:
    # recovery takes the last pointer values and appends are per-branch
    # contiguous, so a recovered process re-logging is consistent)
    wal = open_log(path)
    if _original < WAL_VERSION:
        # records appended from here on are CURRENT-format; stamp a
        # mid-file version header ("last ver record wins") so the next
        # recovery doesn't re-run migrations over already-lifted records —
        # safe today only because _migrate_1_to_2 is idempotent, required
        # the moment any migration isn't
        wal.append(version_record())
    stores.attach_wal(wal)
    return stores, report


def _reconcile_current_pointers(stores: Stores) -> None:
    """Heal torn-write pointer/history skew: the WAL logs the current-run
    pointer and the history batch as separate records, so a crash between
    them can leave (a) a pointer at a run with no history — drop it, or
    the workflow id is wedged WorkflowAlreadyStarted forever — or (b) a
    pointer whose state/close lag the rebuilt state by one transaction —
    overwrite from the rebuilt mutable state (history is the truth)."""
    for (domain_id, workflow_id), cur in stores.execution.list_current_pointers():
        try:
            ms = stores.execution.get_workflow(domain_id, workflow_id,
                                               cur.run_id)
        except Exception:
            stores.execution.drop_current(domain_id, workflow_id)
            continue
        info = ms.execution_info
        if cur.state != info.state or cur.close_status != info.close_status:
            stores.execution.restore_current(domain_id, workflow_id,
                                             CurrentExecution(
                                                 run_id=cur.run_id,
                                                 state=info.state,
                                                 close_status=info.close_status))


def _rebuild_executions(stores: Stores, verify_on_device: bool,
                        layout=None, referenced_runs=frozenset(),
                        rebuild_on_device: bool = True, device=None) -> RecoveryReport:
    from ..core.enums import WorkflowState
    from ..oracle.mutable_state import DomainEntry
    from .rebuild import DeviceRebuilder

    report = RecoveryReport()
    keys = stores.history.list_runs()
    jobs = []
    for key in keys:
        domain_id = key[0]
        try:
            d = stores.domain.by_id(domain_id)
            entry = DomainEntry(domain_id=d.domain_id, name=d.name,
                                is_active=d.is_active,
                                retention_days=d.retention_days,
                                failover_version=d.failover_version)
        except Exception:
            entry = None
        current_branch = stores.history.get_current_branch(*key)
        jobs.append((stores.history.as_history_batches(
            *key, branch=current_branch), entry))

    # one batched device replay rebuilds EVERY run's state in lockstep
    # (the bulk state_rebuilder); flagged rows fall back to the oracle,
    # counted in the report
    from ..core.checksum import DEFAULT_LAYOUT
    layout = layout if layout is not None else DEFAULT_LAYOUT
    rebuilder = DeviceRebuilder(layout, device=device)
    # warm restart: the device rebuild consults the recovered snapshot
    # store — a run with a valid snapshot hydrates the persisted
    # ReplayState row and replays ONLY the since-snapshot suffix
    # (engine/snapshot.py), instead of re-encoding + re-scanning its
    # whole history. Oracle-mode recovery (rebuild_on_device=False)
    # ignores snapshots entirely: no device state to hydrate into.
    rebuilder.snapshots = stores.snapshot
    states = rebuilder.rebuild(jobs, on_device=rebuild_on_device) if jobs else []
    report.device_rebuilt = rebuilder.stats.device
    report.rebuild_fallback = rebuilder.stats.oracle_fallback
    report.snapshot_hydrated = rebuilder.stats.snapshot_seeded

    for key, ms in zip(keys, states):
        current_branch = stores.history.get_current_branch(*key)
        # graft the OTHER branches' version histories (items derived from
        # their stored events) so NDC state survives recovery
        n_branches = stores.history.branch_count(*key)
        if n_branches > 1:
            histories = []
            for b in range(n_branches):
                if b == current_branch:
                    histories.append(ms.version_histories.current())
                else:
                    histories.append(_items_from_events(
                        stores.history.read_events(*key, branch=b)))
            ms.version_histories.histories = histories
            ms.version_histories.current_index = current_branch
        stores.execution.upsert_workflow(ms, set_current=False)
        report.executions_rebuilt += 1
        info = ms.execution_info
        try:
            is_current = (stores.execution.get_current_run_id(
                key[0], key[1]) == key[2])
        except Exception:
            is_current = False
        closed = info.state == WorkflowState.Completed
        if not closed:
            # an open run never referenced by ANY current-run record is an
            # orphan tail of a start that died before its create_workflow
            # commit point (or an NDC zombie): keep the snapshot but never
            # surface it as open — the reference treats such history as
            # garbage nodes, not a live execution
            if not is_current and key not in referenced_runs:
                report.quarantined.append(key)
            else:
                report.open_workflows += 1
        # visibility is DERIVED data (the reference reindexes ES from
        # history); rebuild the records here instead of logging them.
        # Only runs holding the current pointer (or closed runs) get
        # records: zombies and orphan history from failed starts must not
        # surface as phantom open workflows. Close time approximates to
        # the completion event's timestamp.
        from .persistence import VisibilityRecord
        if is_current or closed:
            stores.visibility.record_started(VisibilityRecord(
                domain_id=key[0], workflow_id=key[1], run_id=key[2],
                workflow_type=info.workflow_type_name,
                start_time=info.start_timestamp))
        if closed:
            events = stores.history.read_events(*key)
            stores.visibility.record_closed(
                *key, close_time=events[-1].timestamp if events else 0,
                close_status=info.close_status)

    if verify_on_device and report.executions_rebuilt:
        from .tpu_engine import TPUReplayEngine
        result = TPUReplayEngine(stores, layout, device=device).verify_all()
        report.device_verified = result.verified_on_device
        report.oracle_fallback = len(result.fallback)
        report.divergent = result.divergent
    return report


def _items_from_events(events) -> VersionHistory:
    items: List[VersionHistoryItem] = []
    for e in events:
        if items and items[-1].version == e.version:
            items[-1].event_id = e.id
        else:
            items.append(VersionHistoryItem(e.id, e.version))
    return VersionHistory(items=items)
