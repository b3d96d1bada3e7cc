"""Crashpoints: named kill-anywhere injection sites on the durability tier.

Reference discipline: the same install/env/dynamicconfig arming contract as
the transport chaos layer (rpc/chaos.py) and the store fault injector
(engine/faults.py), one layer further down — at the WRITE-AHEAD LOG itself.
A crashpoint simulates the process dying at an exact byte position in the
commit protocol:

- ``wal.append.before-write``  — nothing of the record reached the file;
- ``wal.append.mid-record``    — a torn write: a PREFIX of the record's
  bytes is flushed (and fsynced, so recovery really sees it), then the
  process dies mid-record (JSONL only; SQLite appends are transactional,
  so its mid-record site fires after the INSERT but before COMMIT — the
  row is invisible to recovery, the strongest torn-write analog it has);
- ``wal.append.after-write``   — the full record is buffered+flushed but
  not yet fsynced (the page-cache window a power loss can eat);
- ``wal.append.after-fsync``   — the record is durable; the crash hits
  after the commit point.

Store-level sites (``store.execution.create_workflow`` & co, fired at the
top of the compound commit methods in engine/persistence.py) kill BETWEEN
wal records of one logical transaction — e.g. after the history batch is
logged but before the current-run pointer is.

Two modes:

- ``raise``: raise ``SimulatedCrash`` (a BaseException, so no store-level
  ``except Exception`` can accidentally swallow the "process death" and
  keep committing). The harness then discards the in-memory bundle and
  recovers from the WAL file — the in-process crash/recovery loop
  CrashSim drives at every cut point;
- ``kill``: ``SIGKILL`` the current process — the subprocess mode the
  multiprocess tests drive through the rpc/cluster launch seam.

Configuration (cross-process, so subprocess store servers inherit it):

    CADENCE_TPU_CRASHPOINT="site=wal.append.after-write,hit=3,mode=kill"

optional ``type=h`` filters to one WAL record type, ``torn=0.3`` sets the
fraction of the record written at the mid-record site. The same spec
string rides dynamicconfig (KEY_CRASHPOINT) or installs programmatically
via ``install(CrashPoint(...))``.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Optional

from ..utils import flightrecorder

SITE_BEFORE_WRITE = "wal.append.before-write"
SITE_MID_RECORD = "wal.append.mid-record"
SITE_AFTER_WRITE = "wal.append.after-write"
SITE_AFTER_FSYNC = "wal.append.after-fsync"

WAL_SITES = (SITE_BEFORE_WRITE, SITE_MID_RECORD, SITE_AFTER_WRITE,
             SITE_AFTER_FSYNC)


class SimulatedCrash(BaseException):
    """The process "died" at a crashpoint. Deliberately a BaseException:
    the whole point is that no layer between the WAL and the harness may
    catch it and carry on as if the write had finished."""


class CrashPoint:
    """One armed crash site: fires on the `hit`-th matching pass, once."""

    def __init__(self, site: str, hit: int = 1, mode: str = "raise",
                 record_type: str = "", torn_fraction: float = 0.5) -> None:
        if mode not in ("raise", "kill"):
            raise ValueError(f"unknown crashpoint mode {mode!r}")
        self.site = site
        self.hit = max(1, hit)
        self.mode = mode
        self.record_type = record_type
        self.torn_fraction = min(max(torn_fraction, 0.0), 1.0)
        self.fired = False
        self._count = 0
        self._lock = threading.Lock()

    def should_fire(self, site: str, record: Optional[dict] = None) -> bool:
        """Count a pass through `site`; True exactly once, on pass `hit`."""
        if site != self.site:
            return False
        if self.record_type and (record is None
                                 or record.get("t") != self.record_type):
            return False
        with self._lock:
            if self.fired:
                return False
            self._count += 1
            if self._count == self.hit:
                self.fired = True
                return True
            return False

    def crash(self, detail: str = "") -> None:
        """Die, per mode. Never returns."""
        flightrecorder.emit("crashpoint-fire", site=self.site,
                            mode=self.mode, hit=self.hit, detail=detail)
        if self.mode == "kill":
            # SIGKILL runs no handler: the black box must write out NOW
            # or the post-mortem loses this process's entire timeline
            flightrecorder.dump_on_crash()
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedCrash(
            f"crashpoint {self.site}"
            f"{f' ({detail})' if detail else ''} hit {self.hit}")


# -- process-wide installation (mirrors rpc/chaos.py) -----------------------

_ACTIVE: Optional[CrashPoint] = None
_ENV = "CADENCE_TPU_CRASHPOINT"
_LOADED_ENV = False
_LOAD_LOCK = threading.Lock()


def parse_kv_spec(spec: str, casts: dict) -> dict:
    """"k=v,k=v" spec parser (the JAX package's rpc/chaos.parse_kv_spec):
    unknown keys raise, so a typo'd spec never silently does nothing."""
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


def parse_spec(spec: str) -> CrashPoint:
    """"site=wal.append.after-write,hit=3,mode=kill,type=h,torn=0.5"."""
    kv = parse_kv_spec(spec, {"site": str, "hit": int, "mode": str,
                              "type": str, "torn": float})
    if "site" not in kv:
        raise ValueError(f"crashpoint spec {spec!r} needs site=")
    return CrashPoint(site=kv["site"], hit=kv.get("hit", 1),
                      mode=kv.get("mode", "raise"),
                      record_type=kv.get("type", ""),
                      torn_fraction=kv.get("torn", 0.5))


def install(point: Optional[CrashPoint]) -> None:
    """Programmatic installation (tests/CrashSim); None uninstalls."""
    global _ACTIVE, _LOADED_ENV
    if point is not None:
        flightrecorder.emit("crashpoint-arm", site=point.site,
                            mode=point.mode, hit=point.hit,
                            record_type=point.record_type)
    _ACTIVE = point
    _LOADED_ENV = True  # explicit choice overrides the env default


def uninstall() -> None:
    install(None)


def active() -> Optional[CrashPoint]:
    """The process's armed crashpoint, lazily loaded from the env on first
    use so subprocess store servers pick it up with zero plumbing."""
    global _ACTIVE, _LOADED_ENV
    if not _LOADED_ENV:
        with _LOAD_LOCK:
            if not _LOADED_ENV:
                spec = os.environ.get(_ENV, "")
                if spec:
                    _ACTIVE = parse_spec(spec)
                _LOADED_ENV = True
    return _ACTIVE


def fire(site: str, record: Optional[dict] = None) -> None:
    """Pass through a named site: crash here iff the armed point matches.
    The no-crashpoint fast path is one global read."""
    point = active()
    if point is not None and point.should_fire(site, record):
        point.crash()
