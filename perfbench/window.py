"""The measured window: requests dispatched ahead at a fixed depth.

A request is one call of the port's entry on one chunk of the resident
corpus; the window cycles over the chunks. Request k+1 is issued before
request k's CRCs and error flags are read back; at most `depth` requests
are in flight. On the card each request's outputs are queued to
page-locked host buffers behind its launches, and the host waits on the
event recorded after that copy alone.

Each request's latency runs from its issue (the call into the port) to
its outputs on the host. The harness's own span, the call into the port
to its return, is the request's dispatch time. The window runs from the
first issue to the last request read back: no request is issued once
`seconds` have passed, and the ones in flight are read back. Every
request of the window counts.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class Window:
    requests: int = 0
    events: int = 0
    bytes: int = 0
    seconds: float = 0.0
    dispatch_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    #: (chunk, sampled CRCs, sampled error flags) of every request
    answers: List[Tuple[int, np.ndarray, np.ndarray]] = field(default_factory=list)


class _Slot:
    """A request's read-back buffers: page-locked on the card's host."""

    def __init__(self, rows: int, device: torch.device):
        pin = device.type == "cuda"
        self.crc = torch.empty((rows,), dtype=torch.int64, pin_memory=pin)
        self.err = torch.empty((rows,), dtype=torch.int32, pin_memory=pin)


def run(resident, seconds: float, depth: int, sample: Dict[int, np.ndarray],
        start: int = 0, annotate: bool = False, min_requests: int = 1) -> Tuple[Window, int]:
    """Measure `resident` (an entry's prepared corpus) for `seconds`, and
    for `min_requests` at least: returns (the window, the index of the
    next request). `sample` maps a chunk to the rows of it whose answers
    are kept for the check; `annotate` marks each dispatch and read-back
    wait for the profiler."""
    from torch.profiler import record_function

    device = resident.device
    cuda = device.type == "cuda"
    slots = [_Slot(resident.chunk_rows, device) for _ in range(depth + 1)]
    win = Window()
    inflight = collections.deque()

    def finish(item):
        k, t_issue, slot, done = item
        if cuda:
            if annotate:
                with record_function("perfbench.readback_wait"):
                    done.synchronize()
            else:
                done.synchronize()
        t_done = time.perf_counter()
        win.latencies_s.append(t_done - t_issue)
        chunk = k % resident.n_chunks
        rows = sample.get(chunk)
        if rows is not None and len(rows):
            win.answers.append((chunk, slot.crc.numpy()[rows].copy(),
                                slot.err.numpy()[rows].copy()))
        win.requests += 1
        win.events += resident.events(chunk)
        win.bytes += resident.bytes(chunk)
        return t_done

    k = start
    t0 = time.perf_counter()
    t_last = t0
    deadline = t0 + seconds
    while True:
        t_issue = time.perf_counter()
        if t_issue >= deadline and k - start >= min_requests:
            break
        if annotate:
            with record_function("perfbench.dispatch"):
                crc, err = resident.request(k % resident.n_chunks)
        else:
            crc, err = resident.request(k % resident.n_chunks)
        win.dispatch_s += time.perf_counter() - t_issue
        slot = slots[k % len(slots)]
        slot.crc.copy_(crc, non_blocking=cuda)
        slot.err.copy_(err, non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        del crc, err
        inflight.append((k, t_issue, slot, done))
        k += 1
        while len(inflight) >= depth:
            t_last = finish(inflight.popleft())
    while inflight:
        t_last = finish(inflight.popleft())
    win.seconds = t_last - t0
    return win, k


def p95(values: List[float]) -> float:
    """The 95th percentile by the nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, int(np.ceil(0.95 * len(ordered))) - 1)]
