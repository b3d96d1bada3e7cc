"""Pipelined bulk-replay executor: packs host chunks ahead of the device.

The JAX package's engine/executor.py BulkReplayExecutor on one device. A
bounded pack thread pool produces host chunks ahead of the device
consumer, which launches them strictly in order:

- ring discipline at depth N: the pack task for chunk `ci` first waits
  until chunk `ci - depth` has finished on the device, so a ring slot is
  never overwritten while its host-to-device copy can still be in flight,
  and at most `depth` chunks are in flight. On the card the wait is on a
  torch.cuda.Event recorded on the current stream right after the
  chunk's launch (where JAX blocked on the chunk's outputs); on the CPU
  a launch has finished when it returns, and the wait is a no-op;
- every chunk records a `pack-queue-wait` profiler leg: that leg growing
  means the host packers starve the device, near zero means the device is
  the bottleneck;
- an optional `consume` callback reads chunk results back with lag 1
  behind the launch head, so device outputs never pile up across a run.

One pack worker per ring slot: a pack task blocked on its slot parks its
worker, which is the backpressure wanted.

The JAX package's mesh (per-device chunk slices and per-device metric
series) and its serving functions `replay_corpus_mesh` and
`stream_wirec_mesh` come with the multi-GPU slice of the port.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch

from ..device import resolve_device
from ..utils import metrics as m
from ..utils.profiler import ReplayProfiler

#: pipeline depth (ring slots / max chunks in flight); >2 lets the pack
#: pool run ahead of the device by more than one chunk
DEPTH_ENV = "CADENCE_TPU_PIPELINE_DEPTH"
DEFAULT_DEPTH = 3


def pipeline_depth(depth: Optional[int] = None) -> int:
    """Resolve the pipeline depth: explicit arg > env > default; min 2
    (depth 1 would serialize pack and replay again)."""
    if depth is None:
        depth = int(os.environ.get(DEPTH_ENV, str(DEFAULT_DEPTH)))
    return max(2, depth)


@dataclass
class PipelineReport:
    """Per-run pipeline accounting."""

    chunks: int = 0
    depth: int = 0
    pack_s: float = 0.0             # summed host pack seconds (inside pack_fn)
    pack_queue_wait_s: float = 0.0  # consumer stalled on the pack pipeline
    escalate_s: float = 0.0         # summed escalate_fn seconds
    wall_s: float = 0.0


class BulkReplayExecutor:
    """Depth-N pack→device pipeline over ordered chunks, on `device`
    (None: the card).

    run() drives the caller's hooks:
      pack_fn(ci) -> packed     host-side pack of chunk ci; runs on a pool
                                thread. Chunk ci - depth has finished on the
                                device before pack_fn(ci) starts, so pack_fn
                                may reuse ring buffer `ci % depth` freely.
      launch_fn(ci, packed)     enqueue chunk ci on the device's current
                                stream; returns its device outputs.
      consume_fn(ci, out)       optional; called in launch order with lag 1
                                behind the newest launch: synchronise and
                                read back here.
      escalate_fn(ci, out)      optional (requires consume_fn); called right
                                after consume_fn(ci) with its result; its
                                return value replaces the chunk's output.
    """

    def __init__(self, depth: Optional[int] = None, registry=None,
                 scope: str = m.SCOPE_TPU_REPLAY, device=None) -> None:
        self.depth = pipeline_depth(depth)
        self.registry = registry if registry is not None else m.DEFAULT_REGISTRY
        self.scope = scope
        self.device = resolve_device(device)

    def _launched_marker(self) -> Optional[torch.cuda.Event]:
        """An event recorded on the device's current stream after a
        launch (None on the CPU, where the launch has finished)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def run(self, num_chunks: int,
            pack_fn: Callable[[int], Any],
            launch_fn: Callable[[int, Any], Any],
            consume_fn: Optional[Callable[[int, Any], Any]] = None,
            escalate_fn: Optional[Callable[[int, Any], Any]] = None) -> tuple:
        """Returns (outputs, PipelineReport); outputs[ci] is the last
        hook's return value (escalate_fn over consume_fn over launch_fn's
        device outputs)."""
        prof = ReplayProfiler(self.registry, scope=self.scope)
        report = PipelineReport(depth=self.depth)
        exec_scope = self.registry.scope(m.SCOPE_TPU_EXECUTOR)
        in_flight = [0]

        def busy(delta: int) -> None:
            in_flight[0] += delta
            exec_scope.gauge(m.M_EXEC_DEVICE_BUSY, float(in_flight[0]))

        outs: List[Any] = [None] * num_chunks
        #: ci -> Future resolved with chunk ci's launch marker once it is
        #: launched; pack tasks wait on ci - depth here (ring discipline)
        launched = {ci: Future() for ci in range(num_chunks)}

        def pack_task(ci: int):
            if ci >= self.depth:
                # the ring slot frees only when the chunk that last used it
                # has finished on the device (its input copy consumed);
                # popped so at most O(depth) markers stay live. Not a
                # kernel-leg observation: consume_fn records that leg once
                # per chunk.
                marker = launched[ci - self.depth].result()
                if marker is not None:
                    marker.synchronize()
                launched.pop(ci - self.depth, None)
            t0 = time.perf_counter()
            packed = pack_fn(ci)
            dt = time.perf_counter() - t0
            prof.observe(m.M_PROFILE_PACK, dt)
            return packed, dt

        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=self.depth,
                                thread_name_prefix="cadence-pack") as pool:
            futs = [pool.submit(pack_task, ci) for ci in range(num_chunks)]
            try:
                for ci in range(num_chunks):
                    t0 = time.perf_counter()
                    packed, pack_dt = futs[ci].result()
                    wait = time.perf_counter() - t0
                    report.pack_queue_wait_s += wait
                    prof.observe(m.M_PROFILE_PACK_WAIT, wait)
                    self.registry.observe(m.SCOPE_TPU_EXECUTOR, m.M_PROFILE_PACK_WAIT, wait)
                    report.pack_s += pack_dt
                    outs[ci] = launch_fn(ci, packed)
                    launched[ci].set_result(self._launched_marker())
                    report.chunks += 1
                    exec_scope.inc(m.M_EXEC_CHUNKS)
                    busy(+1)
                    if consume_fn is not None and ci >= 1:
                        # lag-1 readback: chunk ci runs while chunk ci-1 is
                        # pulled, and outputs never pile up
                        outs[ci - 1] = self._consume(ci - 1, outs[ci - 1], consume_fn,
                                                     escalate_fn, report)
                        busy(-1)
                if consume_fn is not None and num_chunks:
                    outs[-1] = self._consume(num_chunks - 1, outs[-1], consume_fn,
                                             escalate_fn, report)
                    busy(-1)
            finally:
                # a pack or launch failure must not wedge the pool's
                # shutdown: unblock every pack task still waiting on a
                # launch that will never happen
                for f in futs:
                    f.cancel()
                for fut in list(launched.values()):
                    if not fut.done():
                        fut.set_result(None)
                if in_flight[0]:
                    busy(-in_flight[0])
        report.wall_s = time.perf_counter() - t_start
        return outs, report

    @staticmethod
    def _consume(ci: int, out: Any, consume_fn: Callable[[int, Any], Any],
                 escalate_fn: Optional[Callable[[int, Any], Any]],
                 report: PipelineReport) -> Any:
        out = consume_fn(ci, out)
        if escalate_fn is not None:
            t0 = time.perf_counter()
            out = escalate_fn(ci, out)
            report.escalate_s += time.perf_counter() - t0
        return out
