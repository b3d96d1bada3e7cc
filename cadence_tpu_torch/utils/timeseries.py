"""Time-series ring buffers over a MetricsRegistry.

/metrics exposes instantaneous cumulative counters: good for a scraper
with its own TSDB, useless for the questions this framework's operators
actually ask ("what was the commit rate the last minute", "which
pipeline leg is binding RIGHT NOW", "is the serving queue saturating").
This sampler closes that gap in-process: every period it snapshots the
registry (counters, gauges, histogram count/total — one consistent
raw_series() read) and folds the deltas into a fixed-width window ring
(default 1s × 600), deriving

  rates            counter + histogram-count deltas / window seconds,
                   tolerant of in-place registry resets (a cumulative
                   value moving BACKWARD reads as a fresh epoch: the new
                   cumulative IS the delta, never a negative rate)
  legs             per-window busy seconds of the replay-profiler legs
                   (pack / pack-queue-wait / h2d / kernel / readback /
                   fallback / serving, summed over the replay + rebuild
                   scopes) — `binding_resource` is the leg with the most
                   busy time, "idle" when none ran
  saturation       serving queue depth vs capacity, executor busy gauge,
                   and the pack-queue-wait share of the window's leg time
  utilization      total leg-busy seconds / window seconds, clipped [0,1]

Windows serve as JSON at GET /timeseries (utils/scrape.py) — the signal
`admin top` aggregates fleet-wide and the autoscaler (ROADMAP item 5)
will consume. Histogram BUCKET deltas are retained only for series
registered via track_histogram() (the SLO burn-rate inputs, loadgen/
slo.py) so the ring's footprint stays bounded.

Knobs: CADENCE_TPU_TIMESERIES=0 disables the ServiceHost sampler thread,
CADENCE_TPU_TS_PERIOD_S / CADENCE_TPU_TS_RETENTION size the ring.
"""
from __future__ import annotations

import bisect
import os
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as m

ENV_ENABLED = "CADENCE_TPU_TIMESERIES"
ENV_PERIOD = "CADENCE_TPU_TS_PERIOD_S"
ENV_RETENTION = "CADENCE_TPU_TS_RETENTION"

#: the profiler-leg scopes whose histogram-total deltas decompose a
#: window into busy seconds per pipeline leg (utils/profiler.LEGS order)
LEG_SCOPES = (m.SCOPE_TPU_REPLAY, m.SCOPE_REBUILD)
LEGS = (m.M_PROFILE_PACK, m.M_PROFILE_PACK_WAIT, m.M_PROFILE_H2D,
        m.M_PROFILE_KERNEL, m.M_PROFILE_READBACK, m.M_PROFILE_FALLBACK,
        m.M_PROFILE_SERVING)


def enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1") not in ("0", "false", "no")


def default_period_s() -> float:
    try:
        return max(0.05, float(os.environ.get(ENV_PERIOD, "1.0")))
    except ValueError:
        return 1.0


def default_retention() -> int:
    try:
        return max(2, int(os.environ.get(ENV_RETENTION, "600")))
    except ValueError:
        return 600


class Window:
    """One fixed-width sample window (all derived values, no cumulative
    state): `t` is the window END timestamp."""

    __slots__ = ("t", "dur_s", "deltas", "rates", "gauges", "hist_deltas",
                 "bucket_deltas", "legs", "binding_resource", "saturation",
                 "utilization")

    def __init__(self, t: float, dur_s: float) -> None:
        self.t = t
        self.dur_s = dur_s
        #: (scope, name) → counter delta (nonzero only)
        self.deltas: Dict[Tuple[str, str], float] = {}
        #: (scope, name) → delta / dur_s
        self.rates: Dict[Tuple[str, str], float] = {}
        #: (scope, name) → instantaneous gauge value at window end
        self.gauges: Dict[Tuple[str, str], float] = {}
        #: (scope, name) → (count delta, total delta) for histograms
        self.hist_deltas: Dict[Tuple[str, str], Tuple[int, float]] = {}
        #: (scope, name) → (bounds, per-bucket count deltas) — tracked
        #: series only (the burn-rate inputs)
        self.bucket_deltas: Dict[Tuple[str, str],
                                 Tuple[Tuple[float, ...], Tuple[int, ...]]] = {}
        self.legs: Dict[str, float] = {}
        self.binding_resource = "idle"
        self.saturation: Dict[str, float] = {}
        self.utilization = 0.0

    def to_doc(self) -> Dict[str, object]:
        return {
            "t": round(self.t, 6),
            "dur_s": round(self.dur_s, 6),
            "rates": {f"{s}/{n}": round(r, 6)
                      for (s, n), r in sorted(self.rates.items())},
            "gauges": {f"{s}/{n}": v
                       for (s, n), v in sorted(self.gauges.items())},
            "legs": {leg: round(sec, 6)
                     for leg, sec in sorted(self.legs.items())},
            "binding_resource": self.binding_resource,
            "saturation": {k: round(v, 6)
                           for k, v in sorted(self.saturation.items())},
            "utilization": round(self.utilization, 6),
        }


class TimeSeriesSampler:
    """Ring-buffer sampler over one registry. Thread-run in production
    (start()/stop()); tests drive sample_once(now=...) with explicit
    timestamps for deterministic window math."""

    def __init__(self, registry: Optional[m.MetricsRegistry] = None,
                 period_s: Optional[float] = None,
                 retention: Optional[int] = None) -> None:
        self.registry = (registry if registry is not None
                         else m.DEFAULT_REGISTRY)
        self.period_s = (period_s if period_s is not None
                         else default_period_s())
        self.retention = (retention if retention is not None
                          else default_retention())
        self._lock = threading.Lock()
        self._windows: deque = deque(maxlen=self.retention)
        #: previous tick's cumulative state: (t, counters, hist
        #: {key: (count, total)}, tracked buckets {key: (bounds, counts)})
        self._prev: Optional[tuple] = None
        self._tracked: set = set()
        #: (scope, name) of a queue-depth gauge → capacity (int or
        #: callable); drives the queue-fill saturation derivation
        self._capacities: Dict[Tuple[str, str], object] = {}
        #: post-sample hook (window) — the burn-rate evaluator's seat
        self.on_sample: Optional[Callable[[Window], None]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_total = 0
        _LIVE.add(self)

    # -- configuration -----------------------------------------------------

    def track_histogram(self, scope: str, name: str) -> None:
        """Retain per-window BUCKET deltas for (scope, name) — the SLO
        burn-rate inputs. Unregistered histograms keep only count/total
        deltas (the ring must stay bounded)."""
        with self._lock:
            self._tracked.add((scope, name))

    def set_capacity(self, scope: str, name: str, capacity) -> None:
        """Declare a gauge as a queue depth with `capacity` (int or
        zero-arg callable) so windows derive its fill fraction."""
        with self._lock:
            self._capacities[(scope, name)] = capacity

    # -- sampling ----------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> Optional[Window]:
        """Take one sample. The FIRST call only anchors the cumulative
        baseline (no window yet — a window is a delta between two
        ticks); every later call appends one window and returns it."""
        now = time.time() if now is None else now
        counters, gauges, hists = self.registry.raw_series()
        with self._lock:
            tracked = set(self._tracked)
            prev = self._prev
        hist_state = {k: (h[0], h[1]) for k, h in hists.items()}
        buckets = {k: (hists[k][2], hists[k][3])
                   for k in tracked if k in hists}
        if prev is None:
            with self._lock:
                self._prev = (now, counters, hist_state, buckets)
                self.samples_total += 1
            self._publish()
            return None
        prev_t, prev_counters, prev_hists, prev_buckets = prev
        dur = max(now - prev_t, 1e-9)
        window = Window(t=now, dur_s=dur)

        for key, cum in counters.items():
            before = prev_counters.get(key, 0)
            # in-place reset tolerance: the registry's reset() clears
            # cumulative state under components that keep counting — a
            # backward move means a fresh epoch, so the new cumulative
            # IS this window's delta (never negative)
            delta = cum - before if cum >= before else cum
            if delta:
                window.deltas[key] = delta
                window.rates[key] = delta / dur
        for key, (count, total) in hist_state.items():
            pc, pt = prev_hists.get(key, (0, 0.0))
            dcount = count - pc if count >= pc else count
            dtotal = total - pt if count >= pc else total
            if dcount:
                window.hist_deltas[key] = (dcount, dtotal)
                window.rates[key] = dcount / dur
        for key, (bounds, bucket_counts) in buckets.items():
            prev_b = prev_buckets.get(key)
            if prev_b is None or prev_b[0] != bounds or any(
                    c < p for c, p in zip(bucket_counts, prev_b[1])):
                deltas = bucket_counts  # fresh epoch / bucket change
            else:
                deltas = tuple(c - p for c, p in
                               zip(bucket_counts, prev_b[1]))
            if any(deltas):
                window.bucket_deltas[key] = (bounds, deltas)
        window.gauges = dict(gauges)

        self._derive(window)
        with self._lock:
            self._prev = (now, counters, hist_state, buckets)
            self._windows.append(window)
            self.samples_total += 1
            capacities = dict(self._capacities)
        self._saturation(window, capacities)
        self._publish(window)
        hook = self.on_sample
        if hook is not None:
            try:
                hook(window)
            except Exception:
                pass  # a broken evaluator must not stop the sampler
        return window

    def _derive(self, window: Window) -> None:
        """Leg decomposition + binding resource + utilization."""
        for leg in LEGS:
            busy = 0.0
            for scope in LEG_SCOPES:
                busy += window.hist_deltas.get((scope, leg), (0, 0.0))[1]
            if busy > 0.0:
                window.legs[leg] = busy
        total_busy = sum(window.legs.values())
        if total_busy > 1e-9:
            window.binding_resource = max(window.legs.items(),
                                          key=lambda kv: kv[1])[0]
        window.utilization = min(1.0, total_busy / window.dur_s)

    def _saturation(self, window: Window, capacities: Dict) -> None:
        depth = window.gauges.get(
            (m.SCOPE_TPU_SERVING, m.M_SERVING_QUEUE_DEPTH), 0.0)
        window.saturation["queue_depth"] = depth
        cap = capacities.get((m.SCOPE_TPU_SERVING, m.M_SERVING_QUEUE_DEPTH))
        if cap is not None:
            cap_v = float(cap() if callable(cap) else cap)
            if cap_v > 0:
                window.saturation["queue_capacity"] = cap_v
                window.saturation["queue_fill"] = min(1.0, depth / cap_v)
        window.saturation["device_busy"] = window.gauges.get(
            (m.SCOPE_TPU_EXECUTOR, m.M_EXEC_DEVICE_BUSY), 0.0)
        total_busy = sum(window.legs.values())
        if total_busy > 1e-9:
            window.saturation["queue_wait_share"] = (
                window.legs.get(m.M_PROFILE_PACK_WAIT, 0.0) / total_busy)

    def _publish(self, window: Optional[Window] = None) -> None:
        """Mirror the sampler's own health onto the registry (scraped as
        timeseries/* so a flat /metrics scrape sees the ring is live)."""
        try:
            self.registry.gauge(m.SCOPE_TIMESERIES, "windows",
                                float(len(self._windows)))
            self.registry.gauge(m.SCOPE_TIMESERIES, "samples",
                                float(self.samples_total))
            if window is not None:
                self.registry.gauge(m.SCOPE_TIMESERIES, "utilization",
                                    window.utilization)
        except Exception:
            pass

    # -- reads -------------------------------------------------------------

    def windows(self, horizon_s: Optional[float] = None,
                now: Optional[float] = None) -> List[Window]:
        with self._lock:
            out = list(self._windows)
        if horizon_s is not None:
            now = (now if now is not None
                   else (out[-1].t if out else time.time()))
            out = [w for w in out if w.t > now - horizon_s + 1e-9]
        return out

    def fraction_over(self, scope: str, name: str, threshold: float,
                      horizon_s: float,
                      now: Optional[float] = None) -> Tuple[int, int]:
        """(observations over `threshold`, total observations) for one
        TRACKED histogram over the trailing horizon — the burn-rate
        numerator/denominator. Bucket-granular: an observation counts as
        over iff its bucket's upper bound exceeds the threshold."""
        over = total = 0
        for window in self.windows(horizon_s, now=now):
            entry = window.bucket_deltas.get((scope, name))
            if entry is None:
                continue
            bounds, deltas = entry
            total += sum(deltas)
            # buckets at index >= cut have upper bound > threshold
            # (bucket i counts values <= bounds[i]; last slot is +Inf)
            cut = bisect.bisect_left(bounds, threshold)
            if cut < len(bounds) and bounds[cut] == threshold:
                cut += 1  # a bucket bounded exactly AT the ceiling is ok
            over += sum(deltas[cut:])
        return over, total

    def doc(self, last_n: Optional[int] = 120) -> Dict[str, object]:
        """The GET /timeseries body: config + the trailing windows."""
        windows = self.windows()
        if last_n is not None:
            windows = windows[-last_n:]
        return {
            "period_s": self.period_s,
            "retention": self.retention,
            "samples": self.samples_total,
            "windows": [w.to_doc() for w in windows],
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TimeSeriesSampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self.sample_once()  # anchor the baseline before the first period
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cadence-timeseries")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.sample_once()
            except Exception:
                continue  # registry contention etc.; next period retries

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None

    def reset(self) -> None:
        self.stop()
        with self._lock:
            self._windows.clear()
            self._prev = None
            self.samples_total = 0


#: every live sampler (mirrors serving.reset_all's WeakSet contract) so
#: conftest can stop leaked sampler threads between tests
_LIVE: "weakref.WeakSet[TimeSeriesSampler]" = weakref.WeakSet()


def reset_all() -> None:
    for sampler in list(_LIVE):
        try:
            sampler.reset()
        except Exception:
            pass
