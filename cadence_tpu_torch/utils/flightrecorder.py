"""Flight recorder: a lock-cheap in-memory ring of wide structured events.

Reference discipline: the "black box" every production service grows once
post-mortems start depending on whatever happened to be scraped last —
the Go server's equivalent surface is the structured log stream tally
cannot replay. Here one process-global ring records WIDE events (one
dict per interesting decision, not one line per log call) from the
subsystems whose interactions chaos/crashsim post-mortems reconstruct:

  txn-commit          history_engine._Txn.commit — one committed batch
  serving-drain       engine/serving._flush — one micro-batch drain cycle
  migration-out/in    engine/migration — shard movement either direction
  breaker-transition  utils/circuitbreaker — a target changed state
  quota-shed          engine/frontend._admit — admission door rejected
  crashpoint-arm/fire engine/crashpoints — durability kill sites
  fsck-finding        engine/walcheck.fsck — a typed WAL audit finding
  host-boot/host-stop rpc/server.ServiceHost lifecycle

Emit cost is one bounded-payload dict build + a deque append under a
short lock — cheap enough for the commit path. The ring dumps to JSONL
on SIGTERM / atexit / unhandled exception (install_dump_handlers, wired
by ServiceHost) and on demand (`admin flightrec`, GET /flightrec), so a
SIGTERM'd host leaves its own black box behind and a SIGKILL'd host's
last interactions survive in its PEERS' rings (their migration/breaker
events name the dead host).

Knobs: CADENCE_TPU_FLIGHTREC=0 disables emits, CADENCE_TPU_FLIGHTREC_CAP
sizes the ring (default 4096 events), CADENCE_TPU_FLIGHTREC_DUMP names
the JSONL the process-exit handlers write (default
/tmp/cadence_flightrec-<pid>.jsonl).
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

ENV_ENABLED = "CADENCE_TPU_FLIGHTREC"
ENV_CAP = "CADENCE_TPU_FLIGHTREC_CAP"
ENV_DUMP = "CADENCE_TPU_FLIGHTREC_DUMP"

#: JSONL header schema tag (bump on incompatible event-shape changes)
SCHEMA = "cadence.flightrec/1"

#: per-string payload clamp: wide events carry identifiers and counts,
#: never histories — a runaway payload must not grow the ring's footprint
MAX_STR = 256
#: per-event field cap, same rationale
MAX_FIELDS = 24


def enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1") not in ("0", "false", "no")


def _cap() -> int:
    try:
        return max(16, int(os.environ.get(ENV_CAP, "4096")))
    except ValueError:
        return 4096


def default_dump_path() -> str:
    return os.environ.get(
        ENV_DUMP, f"/tmp/cadence_flightrec-{os.getpid()}.jsonl")


def _clamp(value):
    """Bound one payload value into something small and JSON-able."""
    if value is None or isinstance(value, (bool, int, float)):
        return value
    if isinstance(value, str):
        return value if len(value) <= MAX_STR else value[:MAX_STR] + "…"
    if isinstance(value, (list, tuple)):
        return [_clamp(v) for v in list(value)[:32]]
    if isinstance(value, dict):
        return {str(k)[:64]: _clamp(v)
                for k, v in itertools.islice(value.items(), 16)}
    return _clamp(repr(value))


class FlightRecorder:
    """One bounded ring of wide events. `metrics` (optional, a
    MetricsRegistry) receives flightrec/* counters when attached —
    ServiceHost points it at the host registry; the default recorder in
    a bare test process counts internally only."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity if capacity is not None else _cap()
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.metrics = None
        self.events_total = 0
        self.dropped_total = 0
        self.dumps_total = 0
        #: process-exit dump guard: SIGTERM → atexit must not write twice
        self._exit_dumped = False

    # -- emit ---------------------------------------------------------------

    def emit(self, kind: str, **fields) -> None:
        if not enabled():
            return
        if len(fields) > MAX_FIELDS:
            fields = dict(itertools.islice(fields.items(), MAX_FIELDS))
        event = {"kind": kind, "t": time.time(),
                 **{k: _clamp(v) for k, v in fields.items()}}
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self.dropped_total += 1
            self._ring.append(event)
            self.events_total += 1
        registry = self.metrics
        if registry is not None:
            try:
                registry.inc("flightrec", "events")
            except Exception:
                pass  # telemetry must never fail the emitting path

    # -- reads --------------------------------------------------------------

    def snapshot(self, last_n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            events = list(self._ring)
        if last_n is not None and last_n >= 0:
            events = events[-last_n:]
        return events

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self.capacity, "ring": len(self._ring),
                    "events": self.events_total,
                    "dropped": self.dropped_total,
                    "dumps": self.dumps_total}

    # -- dump ---------------------------------------------------------------

    def dump(self, path: Optional[str] = None, reason: str = "demand") -> str:
        """Write header + every ring event as JSONL; returns the path."""
        path = path or default_dump_path()
        events = self.snapshot()
        with self._lock:
            self.dumps_total += 1
            header = {"schema": SCHEMA, "pid": os.getpid(),
                      "reason": reason, "dumped_at": time.time(),
                      "events": len(events),
                      "dropped": self.dropped_total,
                      "events_total": self.events_total}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(json.dumps(header) + "\n")
            for event in events:
                fh.write(json.dumps(event, default=str) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)  # a crashed dump never leaves a torn file
        registry = self.metrics
        if registry is not None:
            try:
                registry.inc("flightrec", "dumps")
            except Exception:
                pass
        return path

    def _dump_on_exit(self, reason: str) -> None:
        """Once-only dump for the process-exit paths (a SIGTERM handler
        that then re-raises also runs atexit)."""
        with self._lock:
            if self._exit_dumped or self.events_total == 0:
                return
            self._exit_dumped = True
        try:
            self.dump(reason=reason)
        except Exception:
            pass  # dying anyway; never mask the real exit

    def reset(self) -> None:
        """Per-test isolation: clear the ring and counters in place
        (emit points reach this recorder through the module global)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self.events_total = 0
            self.dropped_total = 0
            self.dumps_total = 0
            self._exit_dumped = False
        self.metrics = None


#: the process-global recorder every emit point writes through (one ring
#: per process is the point: the post-mortem wants ONE interleaved
#: timeline, not per-component shards)
DEFAULT_RECORDER = FlightRecorder()

_HANDLERS_INSTALLED = False
_INSTALL_LOCK = threading.Lock()


def emit(kind: str, **fields) -> None:
    """Module-level emit through the default recorder (the form the
    engine's emit points use)."""
    DEFAULT_RECORDER.emit(kind, **fields)


def install_dump_handlers() -> bool:
    """Arm the process-exit dumps: SIGTERM (chaining any prior handler),
    atexit, and unhandled-exception hook. Idempotent; returns whether
    the signal handler landed (only the main thread may install one —
    callers off the main thread still get atexit + excepthook)."""
    global _HANDLERS_INSTALLED
    with _INSTALL_LOCK:
        if _HANDLERS_INSTALLED:
            return True
        _HANDLERS_INSTALLED = True

    atexit.register(lambda: DEFAULT_RECORDER._dump_on_exit("atexit"))

    prev_hook = sys.excepthook

    def _excepthook(exc_type, exc, tb):
        DEFAULT_RECORDER.emit("unhandled-exception",
                              type=exc_type.__name__, error=str(exc))
        DEFAULT_RECORDER._dump_on_exit("unhandled-exception")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _excepthook

    try:
        prev_term = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            DEFAULT_RECORDER.emit("sigterm")
            DEFAULT_RECORDER._dump_on_exit("sigterm")
            if callable(prev_term) and prev_term not in (
                    signal.SIG_IGN, signal.SIG_DFL):
                prev_term(signum, frame)
            else:
                # restore + re-raise so the default disposition (die)
                # still applies after the dump
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
        return True
    except ValueError:
        return False  # not the main thread; exit hooks still armed


def dump_on_crash() -> None:
    """Best-effort dump for simulated hard deaths (crashpoints firing in
    kill mode SIGKILL the process — no handler will ever run, so the
    black box writes out right before the trigger pulls)."""
    DEFAULT_RECORDER._dump_on_exit("crash")


def reset_all() -> None:
    """conftest seam: clear the default recorder in place (the emit
    points hold it by reference, matching DEFAULT_REGISTRY's contract)."""
    DEFAULT_RECORDER.reset()
