"""Recovery fsck: a typed post-recovery audit of the WAL and its rebuild.

Reference discipline: the admin DB scanner's invariant checks
(service/worker/scanner + tools/cli adminDBScan) applied to this
framework's one durable artifact. Two passes share one report:

- ``audit_records`` reads the RAW record stream (positionally versioned,
  exactly as ``migrate_records`` labels it) and flags corruption classes
  recovery would either silently heal or silently trust:

  * ``stale-migration-label`` — a record whose governing version header
    claims the current schema but whose body is old-format (the classic
    ``wal clean`` bug: a v1 prefix rewritten under a v{current} header);
  * ``future-schema``          — header newer than this binary;
  * ``dangling-current-pointer`` — a current-run record referencing a run
    the log holds no history for (and never tombstoned): with the
    engine's history-first commit ordering no crash can produce this, so
    its presence means doctoring or lost records;
  * ``unparseable-record``     — raw line/row that does not parse.

- ``audit_stores`` checks the REBUILT stores' cross-invariants:

  * ``orphaned-ack``           — a consumer ack level at/past the queue's
    contents (items re-enqueued later would be silently skipped — the
    purge-ack-leak class);
  * ``history-size-mismatch``  — a rebuilt state whose history_size does
    not equal the serialized size of its stored current-branch batches;
  * ``dangling-current-pointer`` — a pointer whose run has no snapshot
    after rebuild (belt and braces: recovery reconciles these away);
  * ``stale-snapshot``         — a persisted device-state snapshot whose
    batch count exceeds the stored history (the engine's derived
    invalidation makes this unreachable; its presence means doctoring);
  * ``orphaned-snapshot``      — a snapshot for a deleted/unknown run.

Findings are TYPED (code + subject + detail) and surfaced on /metrics as
``walcheck/finding-<code>`` counters so a scrape sees what the last fsck
saw. ``fsck(path)`` = recover + both audits; the CLI's ``wal fsck`` verb
and the crash-sim harness both ride it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..utils import flightrecorder
from .durability import (
    WAL_VERSION,
    RecoveryReport,
    SqliteLog,
    is_sqlite_path,
    recover_stores,
)
from .persistence import Stores

#: queue names that are cross-cluster ACK CURSORS, not local queues:
#: the consuming cluster persists its resume position into a peer's
#: stream under these names (rpc/server leader pumps) — a recovered
#: store legitimately holds the ack with no local queue behind it
XDC_ACK_PREFIXES = ("repl-from:", "domainrepl-from:", "xc-from:")

#: record fields that only exist from a given schema version on: their
#: absence under a label at/past that version is the stale-migration
#: signature, per record type — {type: (since_version, fields)}
_REQUIRED_SINCE = {
    "d": (2, ("st", "desc", "arc")),
    # v3 snapshot records: a body missing its address/blob fields under
    # a v3 label is doctoring, not a format the engine ever wrote
    "snap": (3, ("n", "crc", "ev", "hs", "b", "pay", "blob", "bc", "im",
                 "lay", "sv")),
}


@dataclass
class Finding:
    code: str      # typed class, e.g. "orphaned-ack"
    subject: str   # what it is about (run key, queue, record index)
    detail: str    # human explanation

    def as_dict(self) -> dict:
        return {"code": self.code, "subject": self.subject,
                "detail": self.detail}


@dataclass
class FsckReport:
    path: str
    findings: List[Finding] = field(default_factory=list)
    recovery: Optional[RecoveryReport] = None
    stores: Optional[Stores] = None

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {"wal": self.path, "ok": self.ok,
                "findings": [f.as_dict() for f in self.findings]}


def read_raw_lines(path: str) -> List[str]:
    """The tolerant raw read both the CLI's wal tool and fsck share."""
    if is_sqlite_path(path):
        return SqliteLog.read_raw(path)
    with open(path, "r", encoding="utf-8") as fh:
        return [l.strip() for l in fh if l.strip()]


def audit_records(raw_lines: List[str]) -> List[Finding]:
    """Raw record-stream audit (positional version labeling)."""
    import json
    findings: List[Finding] = []
    records = []
    for i, line in enumerate(raw_lines):
        try:
            records.append((i, json.loads(line)))
        except Exception:
            if i == len(raw_lines) - 1 and not is_probable_record(line):
                continue  # torn tail: recovery's normal diet, not a finding
            findings.append(Finding(
                "unparseable-record", f"line {i + 1}",
                "record does not parse as JSON (mid-file corruption)"))

    effective = 1
    runs_with_history = set()
    tombstoned = set()
    cur_refs = []  # (index, key) in order; judged after the full pass —
    # history may legitimately land before OR after within one log
    for i, rec in records:
        t = rec.get("t")
        if t == "ver":
            version = rec.get("v", 1)
            if version > WAL_VERSION:
                findings.append(Finding(
                    "future-schema", f"line {i + 1}",
                    f"header v{version} is newer than binary v{WAL_VERSION}"))
            effective = version
            continue
        if t in _REQUIRED_SINCE:
            since, required = _REQUIRED_SINCE[t]
            if effective >= since:
                missing = [k for k in required if k not in rec]
                if missing:
                    findings.append(Finding(
                        "stale-migration-label", f"line {i + 1}",
                        f"record type {t!r} labeled v{effective} but "
                        f"missing v{since}+ fields {missing} — an "
                        "unmigrated prefix under a current-version "
                        "header"))
        if t == "h":
            runs_with_history.add((rec.get("d"), rec.get("w"), rec.get("r")))
        elif t == "delw":
            tombstoned.add((rec.get("d"), rec.get("w"), rec.get("r")))
        elif t == "cur":
            cur_refs.append((i, (rec.get("d"), rec.get("w"), rec.get("r"))))
    for i, key in cur_refs:
        if key not in runs_with_history and key not in tombstoned:
            findings.append(Finding(
                "dangling-current-pointer", "/".join(map(str, key)),
                f"current-run record at line {i + 1} references a run the "
                "log holds no history for"))
    return findings


def is_probable_record(line: str) -> bool:
    """A heuristic only for the torn-tail exemption: a complete-looking
    line ('{...}') that still fails to parse is corruption, not a tear."""
    return line.startswith("{") and line.endswith("}")


def audit_stores(stores: Stores) -> List[Finding]:
    """Cross-invariants of the rebuilt stores."""
    from ..core.codec import serialize_history
    findings: List[Finding] = []

    # orphaned acks: a resume cursor pointing past the queue's contents.
    # Cross-cluster cursors are exempt: the consuming cluster stores its
    # ack under the PEER-scoped name (rpc/server leader pumps) while the
    # queue tail lives in the peer's store — locally the queue never
    # exists, by design, and the cursor must survive recovery verbatim.
    sizes, acks = stores.queue.snapshot()
    for (queue, consumer), index in acks.items():
        if queue.startswith(XDC_ACK_PREFIXES):
            continue
        if index >= sizes.get(queue, 0):
            findings.append(Finding(
                "orphaned-ack", f"{queue}/{consumer}",
                f"ack level {index} at/past queue size "
                f"{sizes.get(queue, 0)} — re-enqueued items would be "
                "silently skipped"))

    # history-size accounting vs the stored bytes
    for key in stores.history.list_runs():
        try:
            ms = stores.execution.get_workflow(*key)
        except Exception:
            continue  # quarantined-but-deleted or tombstoned
        branch = stores.history.get_current_branch(*key)
        expected = sum(len(serialize_history([b]))
                       for b in stores.history.as_history_batches(
                           *key, branch=branch))
        if ms.history_size != expected:
            findings.append(Finding(
                "history-size-mismatch", "/".join(key),
                f"rebuilt history_size {ms.history_size} != stored "
                f"current-branch bytes {expected}"))

    # pointers whose run has no snapshot (recovery reconciles; trust but
    # verify)
    for (domain_id, workflow_id), cur in \
            stores.execution.list_current_pointers():
        try:
            stores.execution.get_workflow(domain_id, workflow_id,
                                          cur.run_id)
        except Exception:
            findings.append(Finding(
                "dangling-current-pointer",
                f"{domain_id}/{workflow_id}/{cur.run_id}",
                "current pointer survived recovery with no rebuilt state"))

    # persisted device-state snapshots vs the rebuilt history: the
    # engine's derived invalidation (tail overwrite, branch switch,
    # deletion replayed in order) makes both classes unreachable from
    # normal operation — their presence means doctored or lost records
    snaps = getattr(stores, "snapshot", None)
    if snaps is not None:
        known_runs = set(stores.history.list_runs())
        for key, rec in snaps.items():
            if key not in known_runs:
                findings.append(Finding(
                    "orphaned-snapshot", "/".join(key),
                    "snapshot for a deleted/unknown run — no stored "
                    "history to anchor its content address"))
                continue
            stored = stores.history.batch_count(*key)
            if rec.batch_count > stored:
                findings.append(Finding(
                    "stale-snapshot", "/".join(key),
                    f"snapshot covers {rec.batch_count} batches but the "
                    f"store holds only {stored} — the snapshot leads "
                    "its own history"))
    return findings


def fsck(path: str, metrics=None, verify_on_device: bool = False,
         rebuild_on_device: bool = False, device=None) -> FsckReport:
    """Recover `path` and audit both the raw stream and the rebuild.
    Findings are counted on `metrics` (DEFAULT_REGISTRY when None) so the
    /metrics scrape surfaces ``walcheck/finding-<code>``."""
    report = FsckReport(path=path)
    report.findings.extend(audit_records(read_raw_lines(path)))
    stores, recovery = recover_stores(path, verify_on_device=verify_on_device,
                                      rebuild_on_device=rebuild_on_device,
                                      device=device)
    report.stores, report.recovery = stores, recovery
    report.findings.extend(audit_stores(stores))
    if metrics is None:
        from ..utils.metrics import DEFAULT_REGISTRY
        metrics = DEFAULT_REGISTRY
    for finding in report.findings[:32]:
        # the black box keeps a bounded sample of findings (a corrupt
        # WAL can produce thousands; 32 is plenty to orient a
        # post-mortem — the full set is in the report/metrics)
        flightrecorder.emit("fsck-finding", code=finding.code,
                            subject=finding.subject,
                            detail=finding.detail, path=path)
    for finding in report.findings:
        metrics.inc("walcheck", f"finding-{finding.code}")
    metrics.inc("walcheck", "runs")
    return report
