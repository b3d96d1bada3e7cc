"""Host-runtime attribution: a sampling profiler over the interpreter.

ROADMAP item 1 claims the feeder/serving/cluster tiers are "starved by
one interpreter" — this module is the evidence base. A daemon thread
periodically walks sys._current_frames() and, per live thread,

  - attributes the WALL sample to a named subsystem (feeder pack pool,
    serving drain, visibility appender, migration hydrator, RPC
    dispatch, ... — the prefix table below; every framework thread is
    named for exactly this reason),
  - reads the thread's CPU time (per-thread CPU clock:
    /proc/self/task/<tid>/stat on Linux, pthread_getcpuclockid +
    time.clock_gettime(CLOCK_THREAD_CPUTIME_ID-equivalent) via ctypes
    elsewhere; wall-vs-process-cpu delta as the last resort) so wall
    share and CPU share can disagree — the disagreement IS the GIL story,
  - classifies the top of stack as WAITING (blocking call: lock/socket/
    sleep/queue) or RUNNABLE, and counts runnable-but-not-on-cpu samples:
    their share of runnable samples is the GIL-contention estimate,
  - keeps a top-of-stack table per subsystem (function file:line counts)
    — the `admin hostprof` rollup's "where does the time actually go".

Results land as host.prof/* gauges on the registry (scraped flat) and as
the structured rollup() doc (GET /hostprof, `admin hostprof`).

Knobs: CADENCE_TPU_HOSTPROF=0 disables the ServiceHost profiler thread,
CADENCE_TPU_HOSTPROF_PERIOD_MS sets the sampling period (default 20ms).
"""
from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from collections import Counter
from typing import Dict, List, Optional

from . import metrics as m

ENV_ENABLED = "CADENCE_TPU_HOSTPROF"
ENV_PERIOD_MS = "CADENCE_TPU_HOSTPROF_PERIOD_MS"


def enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1") not in ("0", "false", "no")


def default_period_s() -> float:
    try:
        return max(0.001,
                   float(os.environ.get(ENV_PERIOD_MS, "20")) / 1000.0)
    except ValueError:
        return 0.02


#: thread-name prefix → subsystem bucket. Order matters (first match
#: wins); anything unmatched lands in "other" and counts AGAINST the
#: attributed share — naming a new framework thread is how it earns a row
SUBSYSTEM_PREFIXES = (
    ("cadence-pack", "feeder-pack"),
    ("wirec-pack", "feeder-pack"),
    ("cadence-serving-drain", "serving-drain"),
    ("cadence-serving-warm", "serving-warm"),
    ("visibility-appender", "visibility-appender"),
    ("cadence-migration", "migration-hydrator"),
    ("cadence-rpc", "rpc-dispatch"),
    ("cadence-store", "rpc-dispatch"),
    ("cadence-scrape", "scrape"),
    ("cadence-membership", "membership"),
    ("cadence-queue-pump", "queue-pump"),
    ("cadence-task-worker", "task-workers"),
    ("cadence-timeseries", "telemetry"),
    ("cadence-hostprof", "telemetry"),
    ("MainThread", "main"),
)


def subsystem_for(thread_name: str) -> str:
    for prefix, subsystem in SUBSYSTEM_PREFIXES:
        if thread_name.startswith(prefix):
            return subsystem
    return "other"


#: top-of-stack function names that mean "parked, not runnable" — a
#: blocked thread is not evidence of GIL contention
_WAIT_FUNCTIONS = frozenset((
    "wait", "wait_for", "_wait_for_tstate_lock", "acquire", "sleep",
    "select", "poll", "epoll", "accept", "recv", "recv_into", "recvfrom",
    "read", "readinto", "readline", "get", "join", "getaddrinfo",
    "settimeout", "flush", "fsync",
))


def _thread_cpu_s(thread: threading.Thread) -> Optional[float]:
    """Per-thread CPU seconds. Linux: /proc/self/task/<tid>/stat (utime +
    stime ticks — the same clock CLOCK_THREAD_CPUTIME_ID reads, without
    the pthread_getcpuclockid dead-thread hazard). Elsewhere: the ctypes
    pthread path. None when neither works (caller falls back to the
    wall-vs-process-cpu estimate)."""
    tid = getattr(thread, "native_id", None)
    if tid is not None:
        try:
            with open(f"/proc/self/task/{tid}/stat", "rb") as fh:
                stat = fh.read().decode("ascii", "replace")
            # field 2 (comm) may contain spaces; parse past the last ')'
            fields = stat[stat.rfind(")") + 2:].split()
            utime, stime = int(fields[11]), int(fields[12])
            return (utime + stime) / _clock_ticks()
        except (OSError, ValueError, IndexError):
            pass
    return _pthread_cpu_s(thread)


_TICKS: Optional[float] = None


def _clock_ticks() -> float:
    global _TICKS
    if _TICKS is None:
        try:
            _TICKS = float(os.sysconf("SC_CLK_TCK"))
        except (ValueError, OSError, AttributeError):
            _TICKS = 100.0
    return _TICKS


_PTHREAD_BROKEN = not hasattr(time, "clock_gettime")


def _pthread_cpu_s(thread: threading.Thread) -> Optional[float]:
    """pthread_getcpuclockid(ident) → clock_gettime(clockid): the POSIX
    per-thread CPU clock. Guarded: only consulted for threads still
    alive, and any libc/ctypes failure disables the path for good."""
    global _PTHREAD_BROKEN
    if _PTHREAD_BROKEN or thread.ident is None or not thread.is_alive():
        return None
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        clockid = ctypes.c_int()
        rc = libc.pthread_getcpuclockid(
            ctypes.c_ulong(thread.ident), ctypes.byref(clockid))
        if rc != 0:
            return None
        return time.clock_gettime(clockid.value)
    except Exception:
        _PTHREAD_BROKEN = True
        return None


class HostProfiler:
    """Sampling profiler over THIS process's threads. Thread-run in
    production (start()/stop()); tests drive sample_once() directly."""

    #: top-of-stack table rows kept per rollup
    TOP_ROWS = 25

    def __init__(self, registry: Optional[m.MetricsRegistry] = None,
                 period_s: Optional[float] = None) -> None:
        self.registry = (registry if registry is not None
                         else m.DEFAULT_REGISTRY)
        self.period_s = (period_s if period_s is not None
                         else default_period_s())
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0
        self.started_at = 0.0
        #: subsystem → wall samples
        self._wall: Counter = Counter()
        #: subsystem → CPU seconds (summed per-thread deltas)
        self._cpu: Counter = Counter()
        #: (subsystem, "func (file:line)") → samples
        self._stacks: Counter = Counter()
        self._runnable = 0
        self._gil_starved = 0
        #: thread ident → (last cpu_s, last wall t) for delta math
        self._cpu_prev: Dict[int, tuple] = {}
        self._proc_cpu_prev: Optional[tuple] = None
        _LIVE.add(self)

    # -- one sample ---------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        frames = sys._current_frames()
        threads = {t.ident: t for t in threading.enumerate()}
        me = threading.get_ident()
        proc_cpu = time.process_time()
        fallback_share = self._wall_cpu_fallback(now, proc_cpu,
                                                 len(frames) or 1)
        with self._lock:
            self.samples += 1
            for ident, frame in frames.items():
                if ident == me:
                    continue  # the profiler observing itself is noise
                thread = threads.get(ident)
                name = thread.name if thread is not None else f"tid-{ident}"
                subsystem = subsystem_for(name)
                self._wall[subsystem] += 1

                code = frame.f_code
                self._stacks[(subsystem,
                              f"{code.co_name} "
                              f"({os.path.basename(code.co_filename)}:"
                              f"{frame.f_lineno})")] += 1

                waiting = self._is_waiting(frame)
                cpu_delta = self._cpu_delta(ident, thread, now,
                                            fallback_share)
                if cpu_delta is not None:
                    self._cpu[subsystem] += cpu_delta
                if not waiting:
                    self._runnable += 1
                    # runnable but accumulating (almost) no CPU since the
                    # last sample: it wanted the interpreter and did not
                    # get it — the GIL-contention signal
                    if cpu_delta is not None and \
                            cpu_delta < 0.1 * self.period_s:
                        self._gil_starved += 1
            # forget threads that died (their ident may be reused)
            dead = [i for i in self._cpu_prev if i not in frames]
            for ident in dead:
                del self._cpu_prev[ident]
        self._publish()

    @staticmethod
    def _is_waiting(frame) -> bool:
        """Top two frames: a thread inside Condition.wait's inner
        acquire still reports `wait` one frame up."""
        for _ in range(2):
            if frame is None:
                return False
            if frame.f_code.co_name in _WAIT_FUNCTIONS:
                return True
            frame = frame.f_back
        return False

    def _cpu_delta(self, ident: int, thread, now: float,
                   fallback_share: Optional[float]) -> Optional[float]:
        """CPU seconds this thread burned since its last sample."""
        cpu = _thread_cpu_s(thread) if thread is not None else None
        if cpu is None:
            return fallback_share
        prev = self._cpu_prev.get(ident)
        self._cpu_prev[ident] = (cpu, now)
        if prev is None:
            return 0.0
        return max(0.0, cpu - prev[0])

    def _wall_cpu_fallback(self, now: float, proc_cpu: float,
                           nthreads: int) -> Optional[float]:
        """When no per-thread clock exists: split the PROCESS CPU delta
        evenly across threads (coarse, but keeps cpu-share ordering
        meaningful on exotic platforms)."""
        prev = self._proc_cpu_prev
        self._proc_cpu_prev = (proc_cpu, now)
        if prev is None:
            return None
        return max(0.0, proc_cpu - prev[0]) / nthreads

    # -- rollup -------------------------------------------------------------

    def gil_contention(self) -> float:
        with self._lock:
            return (self._gil_starved / self._runnable
                    if self._runnable else 0.0)

    def attributed_share(self) -> float:
        """Fraction of sampled wall time landing on NAMED subsystem
        threads (everything but "other") — the ≥90% acceptance gate."""
        with self._lock:
            total = sum(self._wall.values())
            if not total:
                return 1.0
            return 1.0 - self._wall.get("other", 0) / total

    def rollup(self) -> Dict[str, object]:
        with self._lock:
            total = sum(self._wall.values()) or 1
            subsystems = {
                name: {
                    "samples": samples,
                    "wall_share": round(samples / total, 4),
                    "cpu_s": round(self._cpu.get(name, 0.0), 4),
                }
                for name, samples in self._wall.most_common()
            }
            top = [
                {"subsystem": subsystem, "frame": frame,
                 "samples": count, "share": round(count / total, 4)}
                for (subsystem, frame), count in
                self._stacks.most_common(self.TOP_ROWS)
            ]
            samples = self.samples
            runnable = self._runnable
            starved = self._gil_starved
        return {
            "samples": samples,
            "period_s": self.period_s,
            "threads": len(threading.enumerate()),
            "gil_contention": round(starved / runnable, 4) if runnable
            else 0.0,
            "runnable_samples": runnable,
            "attributed_share": round(self.attributed_share(), 4),
            "subsystems": subsystems,
            "top": top,
        }

    def _publish(self) -> None:
        """host.prof/* gauges on the registry (flat-scrape mirror)."""
        try:
            reg = self.registry
            reg.gauge(m.SCOPE_HOSTPROF, "samples", float(self.samples))
            reg.gauge(m.SCOPE_HOSTPROF, "gil-contention", self.gil_contention())
            reg.gauge(m.SCOPE_HOSTPROF, "attributed-share",
                      self.attributed_share())
            reg.gauge(m.SCOPE_HOSTPROF, "threads",
                      float(len(threading.enumerate())))
            with self._lock:
                total = sum(self._wall.values()) or 1
                shares = {name: samples / total
                          for name, samples in self._wall.items()}
                cpus = dict(self._cpu)
            for name, share in shares.items():
                reg.gauge(m.SCOPE_HOSTPROF, f"wall-share-{name}", round(share, 4))
            for name, cpu_s in cpus.items():
                reg.gauge(m.SCOPE_HOSTPROF, f"cpu-seconds-{name}",
                          round(cpu_s, 4))
        except Exception:
            pass  # telemetry must never take the host down

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "HostProfiler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self.started_at = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cadence-hostprof")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.sample_once()
            except Exception:
                continue

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None

    def reset(self) -> None:
        self.stop()
        with self._lock:
            self.samples = 0
            self._wall.clear()
            self._cpu.clear()
            self._stacks.clear()
            self._runnable = 0
            self._gil_starved = 0
            self._cpu_prev.clear()
            self._proc_cpu_prev = None


_LIVE: "weakref.WeakSet[HostProfiler]" = weakref.WeakSet()


def reset_all() -> None:
    for profiler in list(_LIVE):
        try:
            profiler.reset()
        except Exception:
            pass
