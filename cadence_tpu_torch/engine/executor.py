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

Mesh awareness: constructed with a parallel/mesh.py mesh, the executor
serves from every device of it. Each chunk's workflow axis splits into
per-device slices, the ring discipline holds per device (one event per
device slice, and a slot frees only when the chunk that last used it has
finished on every shard), and the `tpu.executor` series gain a -dev{d}
twin per mesh position (chunks-dispatched, rows-dispatched, device-busy).

`replay_corpus_mesh` and `stream_wirec_mesh` are the serving paths over
it, one code path at every device count. The JAX package registers each
compiled (shape, mesh size) variant of them in a kernel-variant cache
with hit/miss counters; here nothing compiles per shape (the kernels take
their shapes at run time), so there is no `variants` argument and no such
counters.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
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
    """Depth-N pack→device pipeline over ordered chunks, on the devices of
    `mesh`, or on `device` (None: the card) when no mesh is given.

    run() drives the caller's hooks:
      pack_fn(ci) -> packed     host-side pack of chunk ci; runs on a pool
                                thread. Chunk ci - depth has finished on the
                                device before pack_fn(ci) starts, so pack_fn
                                may reuse ring buffer `ci % depth` freely.
      launch_fn(ci, packed)     enqueue chunk ci on each device's current
                                stream; returns its device outputs.
      consume_fn(ci, out)       optional; called in launch order with lag 1
                                behind the newest launch: synchronise and
                                read back here.
      escalate_fn(ci, out)      optional (requires consume_fn); called right
                                after consume_fn(ci) with its result; its
                                return value replaces the chunk's output.
    """

    def __init__(self, depth: Optional[int] = None, registry=None,
                 scope: str = m.SCOPE_TPU_REPLAY, device=None, mesh=None) -> None:
        self.depth = pipeline_depth(depth)
        self.registry = registry if registry is not None else m.DEFAULT_REGISTRY
        self.scope = scope
        #: device mesh the chunks fan across (None: one device, and no
        #: per-device metric series)
        self.mesh = mesh
        self.devices = mesh.devices if mesh is not None else (resolve_device(device),)
        self._n_dev = mesh.size if mesh is not None else 0

    def _launched_markers(self) -> List[torch.cuda.Event]:
        """One event per device slice, recorded on that device's current
        stream after a launch (none on the CPU, where the launch has
        finished when it returns)."""
        markers = []
        for dev in self.devices:
            if dev.type == "cuda":
                markers.append(torch.cuda.current_stream(dev).record_event())
        return markers

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
            # every mesh position carries a slice of each in-flight chunk,
            # so the per-device series share the value
            in_flight[0] += delta
            exec_scope.gauge(m.M_EXEC_DEVICE_BUSY, float(in_flight[0]))
            for d in range(self._n_dev):
                exec_scope.gauge(m.device_metric(m.M_EXEC_DEVICE_BUSY, d), float(in_flight[0]))

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
                for marker in launched[ci - self.depth].result() or ():
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
                    launched[ci].set_result(self._launched_markers())
                    report.chunks += 1
                    exec_scope.inc(m.M_EXEC_CHUNKS)
                    for d in range(self._n_dev):
                        exec_scope.inc(m.device_metric(m.M_EXEC_CHUNKS, d))
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


# ---------------------------------------------------------------------------
# The mesh-aware serving paths, one code path at every device count:
# replay_corpus_mesh serves a packed dense corpus from the mesh through
# the executor above; stream_wirec_mesh does the same for a wirec corpus
# reduced to CRCs on the devices.
# ---------------------------------------------------------------------------


def queue_to_host(tensors, device) -> tuple:
    """Queue a copy of each tensor into page-locked host memory behind the
    launches queued so far on `device`'s current stream, and record an
    event after the copies. Returns (host tensors, that event), or the
    tensors as they are and None on the CPU. Waiting on the event waits for
    those launches alone, not for work queued behind them, so a caller can
    queue the next chunk before it reads this one."""
    if device.type != "cuda":
        return tuple(tensors), None
    with torch.cuda.device(device):
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in tensors)
        return host, torch.cuda.current_stream(device).record_event()


def queue_shards(devices, outs) -> list:
    """queue_to_host of each shard's output tensors on its own device, in
    mesh order: the lag-1 pull of one chunk, queued right behind its
    launches and before the next chunk's."""
    return [queue_to_host(o, dev) for dev, o in zip(devices, outs)]


def wait_for(pulls) -> list:
    """Wait for one chunk's queued copies alone (the chunk launched after
    it keeps the card busy meanwhile); returns each shard's host tensors."""
    for _, done in pulls:
        if done is not None:
            done.synchronize()
    return [host for host, _ in pulls]


def read_back(pulls, prof=None) -> tuple:
    """wait_for, then each output concatenated over the shards, as numpy.
    With a profiler, the wait is its kernel leg and the concatenation its
    readback leg."""
    with prof.leg(m.M_PROFILE_KERNEL) if prof else nullcontext():
        hosts = wait_for(pulls)
    with prof.leg(m.M_PROFILE_READBACK) if prof else nullcontext():
        return tuple(np.concatenate([h[k].numpy() for h in hosts]) for k in range(len(hosts[0])))


def replay_corpus_mesh(events, mesh=None, layout=None, chunk_workflows: Optional[int] = None,
                       depth: Optional[int] = None, registry=None):
    """Serve a packed [W, E, L] int64 corpus from the mesh (None: the
    serving mesh, see parallel/mesh.serving_mesh): chunks fan across the
    mesh's devices (per-device slice copies, per-device ring discipline),
    each shard runs kernel A, then B, and keeps its current branch, and
    the host reads rows, errors and branch back per chunk with lag 1,
    each chunk's copies queued behind its launches (queue_to_host).

    Returns (payload rows [W, width], errors [W], current branch [W],
    PipelineReport). Any mesh gives the same rows: sharding the workflow
    axis never changes a row's result."""
    from ..core.checksum import DEFAULT_LAYOUT
    from ..ops.encode import LANE_EVENT_ID, LANE_EVENT_TYPE
    from ..ops.payload import payload_rows
    from ..ops.replay import replay_events
    from ..parallel.mesh import place_corpus, run_shards, serving_mesh

    if layout is None:
        layout = DEFAULT_LAYOUT
    if mesh is None:
        mesh = serving_mesh()
    registry = registry if registry is not None else m.DEFAULT_REGISTRY
    events = np.asarray(events)
    W, E = int(events.shape[0]), int(events.shape[1])
    n = mesh.size
    if W == 0:
        return (np.zeros((0, layout.width), np.int64), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32), PipelineReport())
    if chunk_workflows is None:
        chunk_workflows = int(os.environ.get("CADENCE_TPU_REPLAY_CHUNK", "4096"))
    # every chunk shares one padded [Wc, E, L] shape, Wc a multiple of the
    # mesh so each device owns a whole slice of every chunk
    Wc = -(-max(1, min(chunk_workflows, W)) // n) * n
    spans = [(lo, min(lo + Wc, W)) for lo in range(0, W, Wc)]
    executor = BulkReplayExecutor(depth=depth, registry=registry, mesh=mesh)
    prof = ReplayProfiler(registry, scope=m.SCOPE_TPU_EXECUTOR)
    exec_scope = registry.scope(m.SCOPE_TPU_EXECUTOR)

    def pack(ci):
        lo, hi = spans[ci]
        sub = events[lo:hi]
        if sub.shape[0] < Wc:
            pad = np.zeros((Wc - sub.shape[0], E, events.shape[2]), dtype=events.dtype)
            pad[:, :, LANE_EVENT_TYPE] = -1
            sub = np.concatenate([sub, pad])
        if n > 1:
            # real rows per device slice (shard skew), counted here in the
            # pack pool, off the serial launch path
            slice_w = Wc // n
            for d in range(n):
                rows_d = int((sub[d * slice_w:(d + 1) * slice_w, :, LANE_EVENT_ID] > 0)
                             .any(axis=1).sum())
                exec_scope.inc(m.device_metric(m.M_EXEC_ROWS, d), rows_d)
        return sub

    def shard(dev, ev):
        s = replay_events(ev, layout, dev)
        return payload_rows(s, layout), s.error, s.current_branch

    def launch(ci, sub):
        with prof.leg(m.M_PROFILE_H2D):
            parts = place_corpus(sub, mesh)
            prof.h2d(sub.nbytes)
        return queue_shards(mesh.devices, run_shards(mesh, parts, shard))

    results, report = executor.run(len(spans), pack, launch,
                                   lambda ci, pulls: read_back(pulls, prof))
    rows = np.concatenate([r for r, _, _ in results])[:W]
    errors = np.concatenate([e for _, e, _ in results])[:W]
    branch = np.concatenate([b for _, _, b in results])[:W]
    return rows, errors, branch, report


def stream_wirec_mesh(corpus, mesh=None, layout=None, n_chunks: int = 1,
                      depth: Optional[int] = None, registry=None):
    """Stream a packed wirec corpus through the executor in `n_chunks`
    workflow chunks: each chunk's compressed slab splits into per-device
    slice copies whose transfer overlaps the previous chunk's replay, and
    each shard runs kernel A's wirec reader, B, C and F (4 bytes a
    workflow back). `n_chunks` must divide W and keep every shard whole.

    Returns (crc32 [W] uint32, errors [W], PipelineReport)."""
    from ..core.checksum import DEFAULT_LAYOUT
    from ..ops.wirec import WirecCorpus
    from ..parallel.mesh import _replay_wirec_crc_with_stats, run_shards, serving_mesh, shard_wirec

    if layout is None:
        layout = DEFAULT_LAYOUT
    if mesh is None:
        mesh = serving_mesh()
    registry = registry if registry is not None else m.DEFAULT_REGISTRY
    W = int(corpus.slab.shape[0])
    n = mesh.size
    if n_chunks < 1 or W % n_chunks or (W // n_chunks) % n:
        raise ValueError(f"{W} workflows do not split into {n_chunks} chunks of whole "
                         f"slices over a mesh of {n}")
    step = W // n_chunks
    chunks = [WirecCorpus(corpus.slab[lo:lo + step], corpus.bases[lo:lo + step],
                          corpus.n_events[lo:lo + step], corpus.profile)
              for lo in range(0, W, step)]
    executor = BulkReplayExecutor(depth=depth, registry=registry, mesh=mesh)

    def launch(ci, c):
        outs = run_shards(mesh, shard_wirec(c, mesh), lambda dev, p: _replay_wirec_crc_with_stats(
            *p, c.profile, layout))
        return queue_shards(mesh.devices, [(crc, err) for crc, err, _ in outs])

    results, report = executor.run(len(chunks), chunks.__getitem__, launch,
                                   lambda ci, pulls: read_back(pulls))
    return (np.concatenate([c for c, _ in results]).astype(np.uint32),
            np.concatenate([e for _, e in results]), report)
