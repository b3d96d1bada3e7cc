"""History archival: archive-then-delete retention, read-through reads.

Reference: common/archiver/interface.go:72 (HistoryArchiver
Archive/Get), the filestore provider (common/archiver/filestore/), URI
scheme routing (common/archiver/provider/), and the archiver worker
pumping archival requests before retention deletes history
(service/worker/archiver/). For an event-sourced engine whose snapshots
are DERIVED from history, delete-without-archive is capability loss —
so the retention scavenger archives first and reads fall through to the
archive after deletion.

The blob format is the framework's own wire format (core/codec.py), so an
archived history round-trips byte-identically through the same
serializer the replication and native-packer paths use.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from ..core.codec import deserialize_history, serialize_history
from ..core.events import HistoryBatch
from .persistence import EntityNotExistsError


class ArchivalError(Exception):
    pass


def _json_safe(value):
    """Visibility payloads carry raw bytes (search-attribute values); the
    archived .vis is JSON, so bytes decode best-effort to text."""
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, dict):
        return {k: _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    return value


class FilestoreHistoryArchiver:
    """file:// scheme archiver (common/archiver/filestore/historyArchiver.go).

    Layout: <root>/<domain_id>/<workflow_id>/<run_id>.hist (wire blob)
    plus a sibling .vis JSON with the closed-visibility record, so an
    archived run remains both replayable and listable."""

    scheme = "file"

    def __init__(self, root: str) -> None:
        self.root = root

    @staticmethod
    def _component(s: str) -> str:
        """Bijective, traversal-proof path component: percent-encode
        everything outside [A-Za-z0-9_-] (so 'a/b' and 'a_b' cannot
        collide) and dot-only names ('.', '..') cannot escape."""
        from urllib.parse import quote
        enc = quote(s, safe="")
        if set(enc) <= {"."}:
            enc = enc.replace(".", "%2E")
        return enc

    def _paths(self, domain_id: str, workflow_id: str, run_id: str):
        safe = [self._component(s) for s in (domain_id, workflow_id, run_id)]
        base = os.path.join(self.root, *safe[:2])
        return (os.path.join(base, safe[2] + ".hist"),
                os.path.join(base, safe[2] + ".vis"))

    def archive(self, domain_id: str, workflow_id: str, run_id: str,
                batches: List[HistoryBatch],
                visibility: Optional[dict] = None) -> None:
        hist_path, vis_path = self._paths(domain_id, workflow_id, run_id)
        os.makedirs(os.path.dirname(hist_path), exist_ok=True)
        blob = serialize_history(batches)
        # .vis first, .hist last: exists() checks the history blob, so it
        # is the COMMIT point — a crash in between leaves no half-archive
        # that read paths would treat as complete
        if visibility is not None:
            tmp = vis_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(_json_safe(visibility), f)
            os.replace(tmp, vis_path)
        tmp = hist_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, hist_path)  # atomic: a torn archive never reads back

    def exists(self, domain_id: str, workflow_id: str, run_id: str) -> bool:
        return os.path.exists(self._paths(domain_id, workflow_id, run_id)[0])

    def read(self, domain_id: str, workflow_id: str,
             run_id: str) -> List[HistoryBatch]:
        hist_path, _ = self._paths(domain_id, workflow_id, run_id)
        if not os.path.exists(hist_path):
            raise EntityNotExistsError(
                f"no archived history for {workflow_id}/{run_id}")
        with open(hist_path, "rb") as f:
            blob = f.read()
        return deserialize_history(blob, domain_id, workflow_id, run_id)

    def runs(self, domain_id: str, workflow_id: str) -> List[str]:
        """Archived run ids for a workflow, most recently CLOSED first
        (by the .vis close_time, falling back to file mtime) — serves the
        run_id-less read-through after retention deleted the live current
        pointer."""
        from urllib.parse import unquote
        base = os.path.join(self.root, self._component(domain_id),
                            self._component(workflow_id))
        if not os.path.isdir(base):
            return []
        out = []
        for name in os.listdir(base):
            if not name.endswith(".hist"):
                continue
            run_id = unquote(name[:-len(".hist")])
            vis = self.read_visibility(domain_id, workflow_id, run_id)
            close_time = (vis or {}).get("close_time") or int(
                os.path.getmtime(os.path.join(base, name)) * 1e9)
            out.append((close_time, run_id))
        return [r for _, r in sorted(out, reverse=True)]

    def read_visibility(self, domain_id: str, workflow_id: str,
                        run_id: str) -> Optional[dict]:
        _, vis_path = self._paths(domain_id, workflow_id, run_id)
        if not os.path.exists(vis_path):
            return None
        with open(vis_path, "r", encoding="utf-8") as f:
            return json.load(f)


def archiver_for(uri: str) -> Optional[FilestoreHistoryArchiver]:
    """URI-scheme routing (common/archiver/provider/, URI.go). Empty URI =
    archival disabled for the domain; unknown schemes refuse loudly
    (s3/gcloud providers are out of scope — stubbed at the seam, never
    silently dropped)."""
    if not uri:
        return None
    if uri.startswith("file://"):
        return FilestoreHistoryArchiver(uri[len("file://"):])
    raise ArchivalError(
        f"unsupported archival URI scheme {uri!r} (only file:// here)")
