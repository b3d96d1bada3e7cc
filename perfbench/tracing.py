"""The traced windows' profiles, reduced to what the per-layer readers read.

A traced run has two short windows under `torch.profiler`. The first
records the card's activity alone (kernels, copies, fills, and the CUDA
runtime calls on the host), so that the profiler adds little to the
host's dispatch: the device metrics, `busy_s` and `window_s` come from
it. The second also records every host operation, which slows the host's
dispatch by a good deal; it serves only to name the device's idle gaps by
the innermost host operation running at each gap's middle (the
breakdown's `idle_gaps`). A window is the annotation `perfbench.window`
where the trace has it, else the span of all its events. Each Chrome
trace is read back and reduced to the device's operations inside the
window, the host's operations beside them, and the union of the device's
busy intervals.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_ANNOTATION = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
#: host operations up to this long (us) are searched near a gap; longer ones in full
_SHORT_US = 10_000.0


@dataclass
class Trace:
    window_us: Tuple[float, float]
    #: (name, category, start us, duration us) of each device operation
    device: List[Tuple[str, str, float, float]] = field(default_factory=list)
    #: (name, start us, duration us) of each host operation
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        lo, hi = self.window_us
        spans = sorted((max(s, lo), min(s + d, hi)) for _, _, s, d in self.device)
        merged: List[List[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(d for name, cat, _, d in self.device
                   if cat == "kernel" and rx.search(name)) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        """[name, seconds] of the device operations that took most time."""
        total: Dict[str, float] = collections.Counter()
        for name, _, _, d in self.device:
            total[name] += d * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[host operation, seconds]: the device's idle time in the window,
        gap by gap, summed by the innermost host operation running at each
        gap's middle; the largest first."""
        lo, hi = self.window_us
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        short = sorted((h for h in self.host if h[2] <= _SHORT_US), key=lambda h: h[1])
        long_ops = [h for h in self.host if h[2] > _SHORT_US]
        starts = [h[1] for h in short]
        total: Dict[str, float] = collections.Counter()
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            label, best = "host idle", None
            i = bisect.bisect_right(starts, mid)
            while i > 0 and starts[i - 1] >= mid - _SHORT_US:
                i -= 1
                name, hs, hd = short[i]
                if hs + hd >= mid and (best is None or hd < best):
                    label, best = name, hd
            if best is None:
                for name, hs, hd in long_ops:
                    if hs <= mid <= hs + hd and (best is None or hd < best):
                        label, best = name, hd
            total[label] += (e - s) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]


def reduce_chrome_trace(doc: dict) -> Trace:
    """A Trace of a Chrome trace's `perfbench.window` annotation, or of the
    span of all its events where it has none."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    if not events:
        raise ValueError("the trace has no events")
    marks = [e for e in events if e.get("name") == WINDOW_ANNOTATION
             and e.get("cat") == "user_annotation"]
    if marks:
        lo = float(marks[0]["ts"])
        hi = lo + float(marks[0]["dur"])
    else:
        lo = min(float(e["ts"]) for e in events)
        hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events)
    trace = Trace((lo, hi))
    for e in events:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < lo or ts > hi:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            trace.device.append((e["name"], cat, ts, dur))
        elif cat in HOST_CATS and e["name"] != WINDOW_ANNOTATION:
            trace.host.append((e["name"], ts, dur))
    return trace


def profile(fn, cuda: bool, host_ops: bool):
    """Run `fn()` under torch.profiler: the card's activity (on the CPU,
    the host's, as there is no card), and with `host_ops` every host
    operation too, inside the window annotation. Returns (fn's result,
    the reduced Trace). The Chrome trace goes through a temporary file
    that is removed."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CUDA] if cuda else []
    if host_ops or not cuda:
        activities.append(ProfilerActivity.CPU)
    with torch_profile(activities=activities) as prof:
        with record_function(WINDOW_ANNOTATION):
            out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return out, reduce_chrome_trace(doc)
