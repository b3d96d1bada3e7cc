"""The pipelined feeder: wire bytes -> native packer -> replay on the card.

The host must keep up with the kernel's event rate, so packing and replay
overlap. The pipeline is the bulk executor (engine/executor.py): a pack
thread pool fills a ring of `depth` preallocated host buffers ahead of the
device, a slot is written again only after the chunk that last used it
has finished on the card (the CUDA event recorded after its launch), and
the consumer's `pack-queue-wait` leg says which side of the pipeline
starves. Every chunk shares one [C, E, L] shape; the tail chunk is padded
with empty histories.

Each chunk's packed lanes are copied to the card through page-locked
memory (parallel/mesh.place_corpus: one slice per device of a mesh, or the
one device), kernel A replays them and B (and C) reduce them there, and
the host reads rows or 4-byte CRCs back with lag 1: each chunk's results
are queued to page-locked memory right behind its launches, and the
read-back waits on that copy's event alone, so the next chunk runs on the
card while the host reads this one. The wirec pipeline
packs, measures and emits each chunk natively into a WirecBuffers ring
slot (native/wirec.pack_serialized_wirec) under the profile measured on
the first chunk, refits on a misfit, and stages the slot through
native/wirec.stage_corpus. Whether the native encoder or the numpy one
served is the `CADENCE_TPU_NATIVE_WIREC` knob and the `tpu.native`
counters, and `FeedReport.native_wirec`.

A copy of the JAX package's native/feeder.py on the port's executor, with
`device=` beside `mesh=` (None: the card, or the serving mesh when
`CADENCE_TPU_MESH_DEVICES` asks for more than one card).
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from dataclasses import dataclass
from threading import Lock
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..device import resolve_device
from ..engine.executor import BulkReplayExecutor, queue_shards, read_back
from ..utils import metrics as m
from ..utils.profiler import ReplayProfiler
from . import packing


@dataclass
class FeedReport:
    workflows: int = 0
    events: int = 0
    chunks: int = 0
    wall_s: float = 0.0
    pack_s: float = 0.0
    #: the pipeline's depth, and the time the device consumer waited on the
    #: pack pool (engine/executor.py)
    depth: int = 0
    pack_queue_wait_s: float = 0.0
    #: wirec only: the host compression time and the bytes shipped
    compress_s: float = 0.0
    wire_bytes: int = 0
    profile_refits: int = 0
    #: which encoder packed the chunks (native fused pass or numpy), and
    #: the seconds of staging them to the device
    native_wirec: bool = False
    h2d_s: float = 0.0

    @property
    def events_per_sec(self) -> float:
        return self.events / self.wall_s if self.wall_s else 0.0

    @property
    def pack_events_per_sec(self) -> float:
        return self.events / self.pack_s if self.pack_s else 0.0

    @property
    def bytes_per_event(self) -> float:
        return self.wire_bytes / self.events if self.events else 0.0


#: a serialized empty history (0 batches): pads the tail chunk to the
#: steady shape
_EMPTY_BLOB = b"\x00\x00\x00\x00"


def _resolve_mesh(mesh, device):
    """An explicit mesh wins; otherwise on the card the
    CADENCE_TPU_MESH_DEVICES knob decides (unset or 1: the one device)."""
    if mesh is not None:
        return mesh
    from ..parallel.mesh import mesh_devices_requested, serving_mesh

    if resolve_device(device).type == "cuda" and mesh_devices_requested() != 1:
        return serving_mesh()
    return None


def _mesh_chunk(chunk_workflows: int, mesh) -> int:
    """Round the chunk width up to a whole slice per device."""
    return -(-chunk_workflows // mesh.size) * mesh.size


def _chunk_blobs(blobs: Sequence[bytes], lo: int, chunk_workflows: int) -> List[bytes]:
    chunk = list(blobs[lo:lo + chunk_workflows])
    pad = chunk_workflows - len(chunk)
    if pad:
        chunk.extend([_EMPTY_BLOB] * pad)
    return chunk


def _placement(mesh, device):
    """The devices the chunks are copied to and replayed on: the mesh, or a
    mesh of the one device."""
    from ..parallel.mesh import Mesh

    return mesh if mesh is not None else Mesh([resolve_device(device)])


def _queue_read_back(place, outs) -> list:
    """Queue each shard's (first, errors) to page-locked host memory right
    behind its launches, before the next chunk is launched."""
    return queue_shards(place.devices, [o[:2] for o in outs])


def _feed(blobs: Sequence[bytes], max_events: int, chunk_workflows: int,
          layout: PayloadLayout, num_threads: Optional[int], num_lanes: int, dtype,
          pack_fn, replay_fn, depth: Optional[int] = None, mesh=None,
          device=None) -> Tuple[np.ndarray, np.ndarray, FeedReport]:
    """The pipelined feed loop of the int64 and wire32 formats on the bulk
    executor: a ring of `depth` pack buffers, the pack pool ahead of the
    device, a buffer reused only after the chunk that last used it has
    finished. On a mesh each chunk's workflow axis splits into one slice
    per device."""
    from ..parallel.mesh import place_corpus, run_shards

    mesh = _resolve_mesh(mesh, device)
    place = _placement(mesh, device)
    chunk_workflows = _mesh_chunk(chunk_workflows, place)
    total = len(blobs)
    executor = BulkReplayExecutor(depth=depth, device=place.devices[0], mesh=mesh)
    report = FeedReport(workflows=total, depth=executor.depth)
    prof = ReplayProfiler()
    buffers = [np.empty((chunk_workflows, max_events, num_lanes), dtype=dtype)
               for _ in range(executor.depth)]
    n_chunks = -(-total // chunk_workflows) if total else 0
    chunk_events = [0] * n_chunks

    def pack(ci):
        chunk = _chunk_blobs(blobs, ci * chunk_workflows, chunk_workflows)
        packed = pack_fn(chunk, max_events, num_threads=num_threads,
                         out=buffers[ci % executor.depth])
        chunk_events[ci] = int((packed[:, :, 0] > 0).sum())
        return packed

    def launch(ci, packed):
        # the copies and launches are queued; the card runs while later
        # chunks pack
        with prof.leg(m.M_PROFILE_H2D):
            parts = place_corpus(packed, place)
            prof.h2d(packed.nbytes)
        return _queue_read_back(place, run_shards(place, parts,
                                                  lambda dev, ev: replay_fn(ev, layout, dev)))

    start = time.perf_counter()
    results, prep = executor.run(n_chunks, pack, launch, lambda ci, pulls: read_back(pulls, prof))
    first = np.concatenate([r for r, _ in results])[:total]
    errors = np.concatenate([e for _, e in results])[:total]
    report.chunks = prep.chunks
    report.pack_s = prep.pack_s
    report.pack_queue_wait_s = prep.pack_queue_wait_s
    report.events = sum(chunk_events)
    report.wall_s = time.perf_counter() - start
    return first, errors, report


def feed_serialized(blobs: Sequence[bytes], max_events: int, chunk_workflows: int = 4096,
                    layout: PayloadLayout = DEFAULT_LAYOUT, num_threads: Optional[int] = None,
                    depth: Optional[int] = None, mesh=None,
                    device=None) -> Tuple[np.ndarray, np.ndarray, FeedReport]:
    """Replay W serialized histories chunk by chunk; returns (payload rows
    [W, width], errors [W], FeedReport)."""
    from ..ops.encode import NUM_LANES
    from ..ops.replay import replay_to_payload

    return _feed(blobs, max_events, chunk_workflows, layout, num_threads, NUM_LANES, np.int64,
                 packing.pack_serialized, replay_to_payload, depth=depth, mesh=mesh,
                 device=device)


def feed_serialized32(blobs: Sequence[bytes], max_events: int, chunk_workflows: int = 4096,
                      layout: PayloadLayout = DEFAULT_LAYOUT, num_threads: Optional[int] = None,
                      depth: Optional[int] = None, mesh=None,
                      device=None) -> Tuple[np.ndarray, np.ndarray, FeedReport]:
    """The wire32 ingest pipeline: wire bytes -> native wire32 packer ->
    int32 lanes to the card (44% of the int64 bytes) -> replay, payload and
    CRC there -> 4 bytes a workflow back. Returns (crc32 [W] uint32,
    errors [W], report)."""
    from ..ops.encode import NUM_LANES32
    from ..ops.replay import replay_to_crc32

    crcs, errors, report = _feed(blobs, max_events, chunk_workflows, layout, num_threads,
                                 NUM_LANES32, np.int32, packing.pack_serialized32,
                                 replay_to_crc32, depth=depth, mesh=mesh, device=device)
    return crcs.astype(np.uint32), errors, report


def feed_serialized_wirec(blobs: Sequence[bytes], max_events: int, chunk_workflows: int = 4096,
                          layout: PayloadLayout = DEFAULT_LAYOUT,
                          num_threads: Optional[int] = None, depth: Optional[int] = None,
                          mesh=None, registry=None,
                          device=None) -> Tuple[np.ndarray, np.ndarray, FeedReport]:
    """The compressed ingest pipeline: wire bytes -> wirec columns (ops/
    wirec.py) -> the card -> decode, replay, payload and CRC there -> 4
    bytes a workflow back. Returns (crc32 [W] uint32, errors [W], report).

    The native encoder (when `wirec_native_enabled`) runs blobs -> lanes
    -> wirec in one threaded call a chunk into the chunk's WirecBuffers
    ring slot; the numpy encoder packs the blobs natively and compresses
    with ops/wirec.pack_wirec. Both give the same bytes. The profile is
    measured on the first chunk and pinned; a later chunk that does not fit
    it is refitted (counted in `profile_refits`), and its fresh profile
    becomes the pin for the chunks packed after it."""
    from ..ops.encode import NUM_LANES
    from ..ops.replay import replay_wirec_to_crc
    from ..ops.wirec import ProfileMisfit, pack_wirec
    from ..parallel.mesh import run_shards, shard_wirec
    from ..utils.concurrency import pack_threads
    from . import wirec as nwirec

    mesh = _resolve_mesh(mesh, device)
    place = _placement(mesh, device)
    chunk_workflows = _mesh_chunk(chunk_workflows, place)
    total = len(blobs)
    registry = registry if registry is not None else m.DEFAULT_REGISTRY
    executor = BulkReplayExecutor(depth=depth, registry=registry, device=place.devices[0],
                                  mesh=mesh)
    use_native = nwirec.wirec_native_enabled(registry)
    report = FeedReport(workflows=total, depth=executor.depth, native_wirec=use_native)
    prof = ReplayProfiler()
    n_chunks = -(-total // chunk_workflows) if total else 0
    # the one pack-thread knob, split across the pool's concurrent packers
    wirec_threads = (num_threads if num_threads is not None
                     else max(1, pack_threads() // executor.depth))
    if use_native:
        buffers = [nwirec.WirecBuffers(chunk_workflows, max_events)
                   for _ in range(executor.depth)]
    else:
        buffers = [np.empty((chunk_workflows, max_events, NUM_LANES), dtype=np.int64)
                   for _ in range(executor.depth)]

    # chunk 0 measures the profile; later pack tasks pin the latest one (a
    # refit replaces it under the lock)
    first_profile: Future = Future()
    state_lock = Lock()
    shared = {"profile": None, "refits": 0, "pack_s": 0.0, "compress_s": 0.0,
              "events": 0, "wire_bytes": 0, "h2d_s": 0.0}

    def pinned_profile():
        first_profile.result()
        with state_lock:
            return shared["profile"]

    def refit(corpus):
        with state_lock:
            shared["profile"] = corpus.profile
            shared["refits"] += 1
        return corpus

    def encode_native(ci, chunk, slot):
        """One fused native pass: decode and compress together, so pack_s
        carries the whole host cost and compress_s stays 0."""
        if ci == 0:
            corpus, _ = nwirec.pack_serialized_wirec(chunk, max_events,
                                                     num_threads=wirec_threads, out=slot)
            with state_lock:
                shared["profile"] = corpus.profile
            first_profile.set_result(corpus.profile)
            return corpus, 0.0
        try:
            corpus, _ = nwirec.pack_serialized_wirec(chunk, max_events, profile=pinned_profile(),
                                                     num_threads=wirec_threads, out=slot)
        except ProfileMisfit:
            # the fused call decoded the blobs into the slot's lanes before
            # it found the misfit: measure and emit from those
            corpus = refit(nwirec.pack_wirec_native(slot.lanes, num_threads=wirec_threads,
                                                    out=slot))
        return corpus, 0.0

    def encode_python(ci, chunk, slot):
        packed = packing.pack_serialized(chunk, max_events, num_threads=num_threads, out=slot)
        t1 = time.perf_counter()
        if ci == 0:
            corpus = pack_wirec(packed, num_threads=wirec_threads)
            with state_lock:
                shared["profile"] = corpus.profile
            first_profile.set_result(corpus.profile)
        else:
            try:
                corpus = pack_wirec(packed, profile=pinned_profile(), num_threads=wirec_threads)
            except ProfileMisfit:
                corpus = refit(pack_wirec(packed, num_threads=wirec_threads))
        return corpus, time.perf_counter() - t1

    def pack(ci):
        chunk = _chunk_blobs(blobs, ci * chunk_workflows, chunk_workflows)
        slot = buffers[ci % executor.depth]
        t0 = time.perf_counter()
        try:
            corpus, compress_dt = (encode_native if use_native else encode_python)(ci, chunk, slot)
        except BaseException as exc:
            if ci == 0 and not first_profile.done():
                first_profile.set_exception(exc)
            raise
        pack_dt = time.perf_counter() - t0 - compress_dt
        registry.inc(m.SCOPE_TPU_NATIVE, m.M_NATIVE_PACKS if use_native else m.M_NATIVE_PY_PACKS)
        with state_lock:
            shared["pack_s"] += pack_dt
            shared["compress_s"] += compress_dt
            shared["events"] += int(corpus.n_events.sum())
            shared["wire_bytes"] += corpus.wire_bytes
        return corpus

    def launch(ci, corpus):
        with prof.leg(m.M_PROFILE_H2D):
            t0 = time.perf_counter()
            parts = shard_wirec(corpus, place) if mesh is not None else [
                nwirec.stage_corpus(corpus, place.devices[0])]
            with state_lock:
                shared["h2d_s"] += time.perf_counter() - t0
            prof.h2d(corpus.wire_bytes)
        return _queue_read_back(place, run_shards(place, parts, lambda dev, p: replay_wirec_to_crc(
            *p, corpus.profile, layout, dev)))

    start = time.perf_counter()
    results, prep = executor.run(n_chunks, pack, launch, lambda ci, pulls: read_back(pulls, prof))
    first = np.concatenate([r for r, _ in results])[:total].astype(np.uint32)
    errors = np.concatenate([e for _, e in results])[:total]
    report.chunks = prep.chunks
    report.pack_queue_wait_s = prep.pack_queue_wait_s
    report.pack_s = shared["pack_s"]
    report.compress_s = shared["compress_s"]
    report.events = shared["events"]
    report.wire_bytes = shared["wire_bytes"]
    report.profile_refits = shared["refits"]
    report.h2d_s = shared["h2d_s"]
    report.wall_s = time.perf_counter() - start
    return first, errors, report


def _serialized(histories, max_events: int):
    from ..core.codec import serialize_corpus
    from ..ops.encode import history_length

    if max_events <= 0:
        max_events = max(history_length(h) for h in histories)
    return serialize_corpus(histories), max_events


def feed_corpus(histories, chunk_workflows: int = 4096, layout: PayloadLayout = DEFAULT_LAYOUT,
                max_events: int = 0, depth: Optional[int] = None, mesh=None,
                device=None) -> Tuple[np.ndarray, np.ndarray, FeedReport]:
    """Serialize an in-memory corpus and feed it (feed_serialized)."""
    blobs, max_events = _serialized(histories, max_events)
    return feed_serialized(blobs, max_events, chunk_workflows, layout, depth=depth, mesh=mesh,
                           device=device)


def feed_corpus32(histories, chunk_workflows: int = 4096, layout: PayloadLayout = DEFAULT_LAYOUT,
                  max_events: int = 0, depth: Optional[int] = None, mesh=None,
                  device=None) -> Tuple[np.ndarray, np.ndarray, FeedReport]:
    """Serialize an in-memory corpus and feed it through the wire32
    pipeline (feed_serialized32)."""
    blobs, max_events = _serialized(histories, max_events)
    return feed_serialized32(blobs, max_events, chunk_workflows, layout, depth=depth, mesh=mesh,
                             device=device)


def feed_corpus_wirec(histories, chunk_workflows: int = 4096,
                      layout: PayloadLayout = DEFAULT_LAYOUT, max_events: int = 0,
                      depth: Optional[int] = None, mesh=None,
                      device=None) -> Tuple[np.ndarray, np.ndarray, FeedReport]:
    """Serialize an in-memory corpus and feed it through the wirec
    pipeline (feed_serialized_wirec)."""
    blobs, max_events = _serialized(histories, max_events)
    return feed_serialized_wirec(blobs, max_events, chunk_workflows, layout, depth=depth,
                                 mesh=mesh, device=device)


def feed_appends(items, resident_cache, pack_cache) -> Tuple[list, FeedReport]:
    """The suffix-append ingest path. Each item is (workflow key, its
    CURRENT batches). Exact hits are served from the resident payload
    without the device; suffix hits replay only their new events
    (engine/cache.PackCache.encode_suffix) against the resident states on
    the pool's device (engine/resident.ResidentStateCache.replay_append);
    misses come back ok=False for the caller's cold path.

    Returns (one AppendResult per item, a FeedReport whose events count
    the APPENDED events only)."""
    from ..engine.resident import AppendResult

    t_start = time.perf_counter()
    results: List[Optional[AppendResult]] = [None] * len(items)
    suffix_items, suffix_pos = [], []
    for i, (key, batches) in enumerate(items):
        hit = resident_cache.lookup(key, batches)
        if hit is None:
            results[i] = AppendResult(ok=False)
        elif hit[0] == "exact":
            entry = hit[1]
            results[i] = AppendResult(ok=True, payload=entry.payload, branch=entry.branch,
                                      rung=entry.rung)
        else:
            suffix_pos.append(i)
            suffix_items.append((key, hit[1], batches))
    events = chunks = 0
    if suffix_items:
        outs, append_report = resident_cache.replay_append_report(
            suffix_items, encode_suffix=pack_cache.encode_suffix)
        for i, res in zip(suffix_pos, outs):
            results[i] = res
        events = append_report.events_appended
        chunks = len(append_report.chunk_shapes)
    return results, FeedReport(workflows=len(items), events=events, chunks=chunks,
                               wall_s=time.perf_counter() - t_start)
