"""The bulk replay-and-verify engine: persisted histories replayed on the
devices and compared with the live mutable states.

This is the JAX package's engine/tpu_engine.py TPUReplayEngine, under the
same module and class names, so the host control-plane modules that
import it (onebox, admin, canary, rpc/server) carry over unchanged. It
reads MANY workflows' histories out of `Stores`, packs them, replays them
per workflow on the card and compares the canonical checksum payloads
with the live mutable states (the reference's concrete-execution
invariant check; execution/checksum.go is the oracle on both sides).

The hot path runs on the pipelined bulk executor (engine/executor.py):
keys are chunked (the peak host and device footprint is one chunk's, and
a long-tail history inflates only its own chunk's event axis), host
packing of chunk N+1 overlaps the device replay of chunk N, each
workflow's lanes come from the content-addressed pack cache
(engine/cache.PackCache), and the compare runs on the devices: the
expected rows ship with the corpus, kernel D writes a mismatch bit per
workflow, and the host reads back that bitmap, each shard's [2] error
and closed counts (16 bytes, from kernel B's counts epilogue) and the
error lanes of the shards whose counts say a row has an error, never the
[W, width] rows.

Chunks fan across the serving mesh (parallel/mesh.py): on a mesh of N,
keys bucket by `workflow_shard`, so every workflow lands on its owning
device. Capacity-flagged rows escalate through the widened-K ladder
(engine/ladder.py): each chunk's rung-1 replay is submitted from the
executor's escalate hook right after that chunk's readback, and rungs
>= 2 run once, batched. Only the ladder's residue and non-capacity
errors go to the per-workflow oracle.

Before the cold path, the device-resident pool (engine/resident.py,
sharded over the same mesh) partitions the keys: an unchanged history
verifies against its pinned payload with no device work, an appended one
replays only its new batches against the pinned state, and a key with a
valid persisted snapshot hydrates into the pool first (engine/snapshot.py).
The cold path's verified-clean rows are admitted from the escalate hook
with one kernel-G scatter per chunk and shard. The serving scheduler
(`serving_scheduler`) and the snapshot writer (`snapshotter`,
`snapshot_sweep`) share the engine's pool.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.checksum import DEFAULT_LAYOUT, STICKY_ROW_INDEX, PayloadLayout, payload_row
from ..device import resolve_device
from ..oracle.state_builder import StateBuilder
from ..ops.encode import (LANE_EVENT_ID, LANE_EVENT_TYPE, NUM_LANES, assemble_corpus,
                          encode_segments, gather_subcorpus)
from ..ops.payload import payload_rows, payload_rows_narrow
from ..ops.replay import replay_events, verify_rows
from ..utils import metrics as m
from ..utils.profiler import ReplayProfiler
from .cache import PackCache
from .executor import BulkReplayExecutor, queue_shards, wait_for
from .ladder import EscalationLadder
from .persistence import Stores
from . import resident as resident_mod
from .cache import content_address
from .resident import ResidentStateCache

#: max workflows per device launch on the bulk path; bounds peak host
#: corpus bytes and device memory per chunk
CHUNK_ENV = "CADENCE_TPU_REPLAY_CHUNK"
DEFAULT_CHUNK = 4096


def _bucket_events(n: int) -> int:
    """Round the chunk's event axis up to a power of two (min 16), as the
    JAX package does for its compile cache; padding rows are no-ops."""
    return max(16, 1 << (max(1, int(n)) - 1).bit_length())


@dataclass
class BulkVerifyResult:
    total: int
    verified_on_device: int
    divergent: List[Tuple[str, str, str]] = field(default_factory=list)
    #: keys arbitrated by the per-workflow oracle: the escalation
    #: ladder's residue (top-rung overflow or non-capacity errors)
    fallback: List[Tuple[str, str, str]] = field(default_factory=list)
    device_errors: List[Tuple[Tuple[str, str, str], int]] = field(default_factory=list)
    #: keys resolved on the devices by the widened-K re-replay ladder
    escalated: List[Tuple[str, str, str]] = field(default_factory=list)
    #: keys served from the resident state cache (exact or suffix hits)
    resident: List[Tuple[str, str, str]] = field(default_factory=list)
    #: subset of `resident` hydrated from a persisted snapshot
    snapshot: List[Tuple[str, str, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.divergent


@dataclass
class _ChunkPlan:
    """One chunk of the mesh-aware run: which keys it carries (indices into
    the run's key list), which corpus row each key occupies, and the
    padded workflow axis. On a mesh of 1 the rows are the contiguous
    prefix; on a mesh of N the chunk is N per-shard slices of P rows each,
    and key k sits in slice workflow_shard(k, N)."""

    idx: List[int]
    rows: np.ndarray
    W: int


class TPUReplayEngine:
    """Bulk device replay over persisted histories, served from the device
    mesh (`mesh`; None: a mesh of `device`, or the serving mesh over the
    cards when no device is named either)."""

    def __init__(self, stores: Stores, layout: PayloadLayout = DEFAULT_LAYOUT,
                 chunk_workflows: Optional[int] = None,
                 pipeline_depth: Optional[int] = None, mesh=None, device=None) -> None:
        self.stores = stores
        self.layout = layout
        self.device = device
        self.pack_cache = PackCache()
        #: the escalation ladder, made when the mesh is resolved (on the
        #: mesh's first device, sharded over the mesh when it has more
        #: than one), so constructing an engine never asks for the card
        self.ladder: Optional[EscalationLadder] = None
        #: the device-resident pool verify_all serves unchanged and appended
        #: workflows from, sharded over the mesh when it is wired
        self.resident = ResidentStateCache(layout, pipeline_depth=pipeline_depth)
        #: the serving scheduler and the snapshot writer, made on first use
        self._serving = None
        self._snapshotter = None
        self.metrics = m.DEFAULT_REGISTRY
        self.chunk_workflows = (chunk_workflows if chunk_workflows
                                else int(os.environ.get(CHUNK_ENV, str(DEFAULT_CHUNK))))
        self.pipeline_depth = pipeline_depth
        self._mesh = mesh
        if mesh is not None:
            self._wire_mesh(mesh)
        #: (W, E) of each chunk of the last bulk run: a long-tail history
        #: inflates only its own chunk's E
        self.last_run_chunk_shapes: List[Tuple[int, int]] = []
        #: host seconds of the last verify_all: `resident` (the partition
        #: with snapshot hydration, the exact and suffix hits),
        #: `expected_rows` (the live states' payload rows, summed over the
        #: pack threads), `ladder` (finish) and `arbitrate` (the result
        #: loop, oracle included)
        self.last_run: Dict[str, float] = {}

    @property
    def mesh(self):
        if self._mesh is None:
            from ..parallel.mesh import Mesh, serving_mesh

            self._mesh = (serving_mesh() if self.device is None
                          else Mesh([resolve_device(self.device)]))
            self._wire_mesh(self._mesh)
        return self._mesh

    def _wire_mesh(self, mesh) -> None:
        """One mesh through every layer: the ladder's rungs re-replay under
        the same shard axis when the mesh has more than one device, and the
        resident pool splits into per-device slices."""
        self.ladder = EscalationLadder(self.layout, registry=self.metrics,
                                       device=mesh.devices[0],
                                       mesh=mesh if mesh.size > 1 else None)
        self.resident.ladder = self.ladder
        self.resident.set_mesh(mesh)

    def serving_scheduler(self):
        """The micro-batching transaction scheduler bound to this engine's
        resident pool, pack cache, ladder and mesh (engine/serving.py): one
        per engine, so a transaction's append and a verify's admit share
        the pool."""
        if self._serving is None:
            from .serving import ServingScheduler
            self._serving = ServingScheduler(self)
        return self._serving

    def snapshotter(self):
        """The checksum-gated snapshot writer bound to this engine's stores,
        resident pool and pack cache (engine/snapshot.py)."""
        if self._snapshotter is None:
            from .snapshot import Snapshotter
            self._snapshotter = Snapshotter(self.stores, self.resident, self.pack_cache,
                                            self.layout, registry=self.metrics)
        return self._snapshotter

    def snapshot_sweep(self, keys=None, force: bool = False):
        """Persist snapshots for every resident workflow (or `keys`): run
        after a verify pass seeds the pool, so the next start is warm."""
        return self.snapshotter().sweep(keys=keys, force=force)

    @property
    def mesh_size(self) -> int:
        return self.mesh.size

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, registry) -> None:
        """Clusters wire their own registry after construction; the pack
        cache's and the ladder's counters must land on the same one."""
        self._metrics = registry
        self.pack_cache.metrics = registry
        if self.ladder is not None:
            self.ladder.metrics = registry
        if hasattr(self, "resident"):
            self.resident.metrics = registry
        if getattr(self, "_serving", None) is not None:
            self._serving.metrics = registry
        if getattr(self, "_snapshotter", None) is not None:
            self._snapshotter.metrics = registry

    def tree_segments(self, key: Tuple[str, str, str]) -> list:
        """One run's full branch tree as encode_segments input: the current
        branch's lineage replays state-carrying; every other branch's
        events beyond the shared prefix are emitted VH-only with
        fork-inheritance from the current branch, so the device holds the
        complete VersionHistories (winner state + loser branch items)."""
        from ..core.events import HistoryBatch

        hs = self.stores.history
        current = hs.get_current_branch(*key)
        cur_lineage = hs.as_history_batches(*key, branch=current)
        segments = [(cur_lineage, current, current, False)]
        cur_events = [e for b in cur_lineage for e in b.events]
        for index in range(hs.branch_count(*key)):
            if index == current:
                continue
            events = hs.read_events(*key, branch=index)
            shared = 0
            while (shared < min(len(events), len(cur_events))
                   and events[shared].id == cur_events[shared].id
                   and events[shared].version == cur_events[shared].version):
                shared += 1
            unique = events[shared:]
            if not unique:
                continue
            segments.append((
                [HistoryBatch(domain_id=key[0], workflow_id=key[1], run_id=key[2],
                              events=unique)],
                index, current, True,
            ))
        return segments

    def _encode_key_rows(self, key: Tuple[str, str, str]) -> np.ndarray:
        """One workflow's encoded [n, L] lane rows: single-lineage
        histories through the content-addressed pack cache, multi-branch
        trees encoded fresh."""
        hs = self.stores.history
        if hs.branch_count(*key) <= 1 and hs.get_current_branch(*key) == 0:
            return self.pack_cache.encode(key, hs.as_history_batches(*key))
        segs = self.tree_segments(key)
        total = sum(len(b.events) for seg in segs for b in seg[0])
        return encode_segments(segs, total)

    def _chunk_spans(self, n: int) -> List[Tuple[int, int]]:
        c = max(1, self.chunk_workflows)
        return [(lo, min(lo + c, n)) for lo in range(0, n, c)]

    def _plan_chunks(self, keys: List[Tuple[str, str, str]]) -> List[_ChunkPlan]:
        """Chunk the key list for the mesh. Mesh of 1: contiguous spans
        padded to the run-constant width. Mesh of N: keys bucket by
        workflow_shard, each chunk takes up to P keys of every bucket, so
        row s*P+i belongs to shard s and lands on its owning device."""
        n = self.mesh_size
        if n <= 1:
            pad_to = min(max(1, self.chunk_workflows), len(keys))
            return [_ChunkPlan(idx=list(range(lo, hi)), rows=np.arange(hi - lo), W=pad_to)
                    for lo, hi in self._chunk_spans(len(keys))]
        from ..parallel.mesh import workflow_shard

        buckets: List[List[int]] = [[] for _ in range(n)]
        for i, key in enumerate(keys):
            buckets[workflow_shard(key, n)].append(i)
        per = max(1, -(-self.chunk_workflows // n))
        P = min(per, max((len(b) for b in buckets), default=1))
        plans: List[_ChunkPlan] = []
        off = 0
        while any(len(b) > off for b in buckets):
            idx: List[int] = []
            rows: List[int] = []
            for s, b in enumerate(buckets):
                sl = b[off:off + P]
                idx.extend(sl)
                rows.extend(s * P + j for j in range(len(sl)))
            plans.append(_ChunkPlan(idx=idx, rows=np.asarray(rows, dtype=np.int64), W=n * P))
            off += P
        return plans

    def _pack_chunk(self, chunk_keys: Sequence[Tuple[str, str, str]],
                    rows: np.ndarray, pad_to: int) -> np.ndarray:
        """Encode one chunk of keys into [pad_to, E, L], key j landing on
        corpus row rows[j]; E is the power-of-two bucket of this chunk's
        longest history. Every other row is padding (a no-op)."""
        rows_list = [self._encode_key_rows(k) for k in chunk_keys]
        E = _bucket_events(max((r.shape[0] for r in rows_list), default=1))
        sub = assemble_corpus(rows_list, E)
        corpus = np.zeros((pad_to, E, NUM_LANES), dtype=np.int64)
        corpus[:, :, LANE_EVENT_TYPE] = -1
        corpus[np.asarray(rows)] = sub
        return corpus

    def _run_chunks(self, keys: List[Tuple[str, str, str]], pack_extra, launch_fn,
                    readback_fn, escalate_fn=None, plans=None):
        """Drive the pipelined executor over key chunks, fanned across the
        mesh (per-device slice copies; a mesh of 1 is one card).

        pack_extra(chunk_keys, plan) -> host extras packed beside the
        corpus in the pack pool (sized [plan.W, ...] in row space);
        launch_fn(parts, extras) -> (the tensors to read back, a tuple per
        shard in mesh order; anything else the readback needs), given the
        corpus's per-shard tensors in mesh order; the tensors are queued to
        page-locked host memory behind the chunk's launches;
        readback_fn(hosts, kept) -> numpy results per chunk (row space),
        given each shard's host tensors once that chunk's copies are done;
        escalate_fn(ci, corpus_np, consumed) -> consumed, optional: called
        right after chunk ci's readback with its host corpus (held only
        until then: at most `depth` corpora are retained).
        Returns (per-chunk results, per-chunk plans)."""
        from ..parallel.mesh import place_corpus

        if plans is None:
            plans = self._plan_chunks(keys)
        mesh = self.mesh
        prof = ReplayProfiler(self.metrics)
        scope = self.metrics.scope(m.SCOPE_TPU_REPLAY)
        executor = BulkReplayExecutor(depth=self.pipeline_depth, registry=self.metrics, mesh=mesh)
        shapes: List[Optional[Tuple[int, int]]] = [None] * len(plans)
        events: List[int] = [0] * len(plans)
        corpora: dict = {}
        n_dev = mesh.size

        def pack(ci):
            plan = plans[ci]
            chunk_keys = [keys[i] for i in plan.idx]
            corpus = self._pack_chunk(chunk_keys, plan.rows, plan.W)
            shapes[ci] = (corpus.shape[0], corpus.shape[1])
            events[ci] = int((corpus[:, :, LANE_EVENT_ID] > 0).sum())
            if n_dev > 1:
                # real rows per device slice (shard skew), counted in the
                # pack pool, off the serial launch path
                exec_scope = self.metrics.scope(m.SCOPE_TPU_EXECUTOR)
                slice_w = corpus.shape[0] // n_dev
                for d in range(n_dev):
                    rows_d = int((corpus[d * slice_w:(d + 1) * slice_w, :, LANE_EVENT_ID] > 0)
                                 .any(axis=1).sum())
                    exec_scope.inc(m.device_metric(m.M_EXEC_ROWS, d), rows_d)
            if escalate_fn is not None:
                corpora[ci] = corpus
            extras = pack_extra(chunk_keys, plan) if pack_extra else None
            return corpus, extras

        def launch(ci, packed):
            corpus, extras = packed
            scope.inc(m.M_KERNEL_LAUNCHES)
            scope.inc(m.M_EVENTS_REPLAYED, events[ci])
            with prof.leg(m.M_PROFILE_H2D):
                parts = place_corpus(corpus, mesh)
                prof.h2d(corpus.nbytes)
            pull, kept = launch_fn(parts, extras)
            return queue_shards(mesh.devices, pull), kept

        def consume(ci, launched):
            pulls, kept = launched
            with prof.leg(m.M_PROFILE_KERNEL):
                hosts = wait_for(pulls)
            with prof.leg(m.M_PROFILE_READBACK):
                return readback_fn(hosts, kept)

        def escalate(ci, consumed):
            return escalate_fn(ci, corpora.pop(ci), consumed)

        with scope.timed():
            results, _report = executor.run(len(plans), pack, launch, consume,
                                            escalate if escalate_fn is not None else None)
        self.last_run_chunk_shapes = [s for s in shapes if s is not None]
        t = self.metrics.timer(m.SCOPE_TPU_REPLAY, m.M_LATENCY)
        if t.total_s > 0:
            self.metrics.gauge(
                m.SCOPE_TPU_REPLAY, m.M_REPLAY_THROUGHPUT,
                self.metrics.counter(m.SCOPE_TPU_REPLAY, m.M_EVENTS_REPLAYED) / t.total_s)
        return results, plans

    def replay_tree_payloads(self, keys: Sequence[Tuple[str, str, str]]
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device-replay full branch trees (divergent histories included);
        returns (payload rows, errors, device-chosen current branch),
        chunked through the bulk executor."""
        from ..parallel.mesh import run_shards

        keys = list(keys)
        if not keys:
            return (np.zeros((0, self.layout.width), dtype=np.int64),
                    np.zeros((0,), dtype=np.int32), np.zeros((0,), dtype=np.int32))

        def shard(dev, ev):
            state = replay_events(ev, self.layout, dev)
            return payload_rows(state, self.layout), state.error, state.current_branch

        def readback(hosts, _kept):
            return tuple(np.concatenate([h[k].numpy() for h in hosts]) for k in range(3))

        results, plans = self._run_chunks(
            keys, None, lambda parts, _extras: (run_shards(self.mesh, parts, shard), None),
            readback)
        rows = np.zeros((len(keys), self.layout.width), dtype=np.int64)
        errors = np.zeros((len(keys),), dtype=np.int32)
        branch = np.zeros((len(keys),), dtype=np.int32)
        for plan, (r, e, b) in zip(plans, results):
            rows[plan.idx] = r[plan.rows]
            errors[plan.idx] = e[plan.rows]
            branch[plan.idx] = b[plan.rows]
        return rows, errors, branch

    def _expected_row(self, key: Tuple[str, str, str]) -> Tuple[np.ndarray, int]:
        """The live mutable state's canonical payload row (sticky masked:
        replay always clears stickiness) and current branch index."""
        live_ms = self.stores.execution.get_workflow(*key)
        row = payload_row(live_ms, self.layout)
        row[STICKY_ROW_INDEX] = 0
        return row, live_ms.version_histories.current_index

    def _partition_resident(self, keys: List[Tuple[str, str, str]]):
        """Split keys by what the resident pool can serve: exact hits (no
        device work), suffix hits (replay appended batches only) and cold
        keys for the full-replay path. Keys that are not single-lineage (an
        NDC branch switch) and stale addresses invalidate their entries
        here. A would-be-cold key with a valid persisted snapshot hydrates
        into the pool first and re-partitions as a hit; the hydrations of
        one call reach the device together (one pool batch). Returns
        (exact, suffix, cold, cold addresses, hydrated keys)."""
        from . import snapshot as snapshot_mod

        exact: List[Tuple[Tuple[str, str, str], object]] = []
        suffix: List[Tuple[Tuple[str, str, str], object, list]] = []
        cold: List[Tuple[str, str, str]] = []
        addresses: dict = {}
        hydrated: List[Tuple[str, str, str]] = []
        snapshots = getattr(self.stores, "snapshot", None)
        hs = self.stores.history
        with self.resident.batch():
            for key in keys:
                if hs.branch_count(*key) > 1 or hs.get_current_branch(*key) != 0:
                    self.resident.invalidate(key)  # NDC branch switch
                    cold.append(key)
                    continue
                batches = hs.as_history_batches(*key)
                hit = self.resident.lookup(key, batches)
                if hit is None and snapshot_mod.seed_from_batches(
                        snapshots, self.resident, self.pack_cache, key, batches, self.layout,
                        self.metrics):
                    hit = self.resident.lookup(key, batches)
                    if hit is not None:
                        hydrated.append(key)
                if hit is None:
                    addresses[key] = content_address(batches)
                    cold.append(key)
                elif hit[0] == "exact":
                    exact.append((key, hit[1]))
                else:
                    suffix.append((key, hit[1], batches))
        return exact, suffix, cold, addresses, hydrated

    def verify_all(self, keys: Optional[Sequence[Tuple[str, str, str]]] = None
                   ) -> BulkVerifyResult:
        """Replay persisted histories on the devices and compare with the
        live mutable states (zero-divergence contract).

        Resident keys first: an unchanged history verifies against the
        pinned payload with no device work, an appended one replays only
        its new batches against the pinned state (the resident pool's
        replay_append), and a failed append goes to the oracle. The cold
        keys run the chunked path: the expected rows ship with the corpus,
        the host reads back a mismatch bitmap and, where kernel B's counts
        show a row with an error, the error lanes; each chunk's
        verified-clean rows are admitted to the pool from the escalate
        hook. Capacity-flagged rows escalate through the widened-K ladder:
        their rung-1 replay is submitted from the same hook, and rungs >= 2
        run once, batched across all chunks' survivors. Rows the ladder
        resolves verify against the live state at the base payload width;
        only the ladder's residue and non-capacity errors re-run through
        the per-workflow oracle."""
        from ..parallel.mesh import place_corpus, run_shards

        if keys is None:
            keys = self.stores.execution.list_executions()
        all_keys = list(keys)
        if not all_keys:
            return BulkVerifyResult(total=0, verified_on_device=0)
        # resolve (and wire) the mesh before the resident partition: the
        # pool's shard structure must be bound before any lookup or admit
        mesh = self.mesh
        t_start = time.perf_counter()
        self.last_run = {"resident": 0.0, "expected_rows": 0.0, "ladder": 0.0, "arbitrate": 0.0}
        result = BulkVerifyResult(total=len(all_keys), verified_on_device=0)
        if resident_mod.enabled():
            exact, suffix, keys, addresses, hydrated = self._partition_resident(all_keys)
            result.snapshot = hydrated
        else:
            exact, suffix, keys, addresses = [], [], all_keys, {}

        for key, entry in exact:
            row, br = self._expected_row(key)
            result.verified_on_device += 1
            result.resident.append(key)
            if not (entry.payload == row).all() or entry.branch != br:
                result.divergent.append(key)

        if suffix:
            outcomes = self.resident.replay_append(suffix,
                                                   encode_suffix=self.pack_cache.encode_suffix)
            for (key, _entry, batches), res in zip(suffix, outcomes):
                row, br = self._expected_row(key)
                if not res.ok:
                    # entry already invalidated; the per-workflow oracle
                    # arbitrates, as for the cold path's residue
                    result.device_errors.append((key, int(res.error)))
                    result.fallback.append(key)
                    oracle_ms = StateBuilder().replay_history(batches)
                    if not (payload_row(oracle_ms, self.layout) == row).all():
                        result.divergent.append(key)
                    continue
                result.verified_on_device += 1
                result.resident.append(key)
                if res.escalated:
                    result.escalated.append(key)
                if not (res.payload == row).all() or res.branch != br:
                    result.divergent.append(key)
        self.last_run["resident"] = time.perf_counter() - t_start

        if not keys:
            return result
        #: ci -> (capacity-flagged local key indices, pending rung-1 launch)
        pending: dict = {}
        expected_seconds: List[float] = []

        def pack_extra(chunk_keys, plan):
            # expected rows live in row space ([plan.W, ...]), each at its
            # key's shard slice, so the compare stays on the owning device;
            # padding rows' entries are zeros the result loop never reads
            t0 = time.perf_counter()
            expected = np.zeros((plan.W, self.layout.width), dtype=np.int64)
            exp_branch = np.zeros((plan.W,), dtype=np.int32)
            for j, key in enumerate(chunk_keys):
                expected[plan.rows[j]], exp_branch[plan.rows[j]] = self._expected_row(key)
            expected_seconds.append(time.perf_counter() - t0)
            return expected, exp_branch

        def shard(dev, part):
            ev, exp, exp_br = part
            state = replay_events(ev, self.layout, dev)
            rows_dev, _overflow, counts = payload_rows_narrow(state, self.layout, counts=True)
            mismatch = verify_rows(rows_dev, exp, state.current_branch, exp_br, device=dev)
            return mismatch, state, counts

        def launch(parts, extras):
            expected, exp_branch = extras
            outs = run_shards(mesh, zip(parts, place_corpus(expected, mesh),
                                        place_corpus(exp_branch, mesh)), shard)
            return ([(mm, st.error, counts) for mm, st, counts in outs],
                    (expected, exp_branch, [st for _, st, _ in outs]))

        def readback(hosts, kept):
            expected, exp_branch, states = kept
            mismatch = np.concatenate([h[0].numpy() for h in hosts])
            # the error lanes are read only for shards whose counts show a
            # row with an error
            errors = np.concatenate([
                err.numpy() if int(counts[0]) else np.zeros(err.shape[0], np.int32)
                for _, err, counts in hosts])
            return mismatch, errors, expected, exp_branch, states

        def escalate(ci, corpus, consumed):
            mismatch, errors, expected, exp_branch, states = consumed
            plan = plans[ci]
            # errors come back in row space; flag capacity overflow on real
            # rows only and remember the flagged keys' positions
            cap_local = self.ladder.capacity_flagged(errors[plan.rows])
            if len(cap_local):
                cap_rows = np.asarray(plan.rows)[cap_local]
                pending[ci] = (cap_local, self.ladder.submit(gather_subcorpus(corpus, cap_rows)))
            # admit the chunk's verified-clean rows: the device row equals
            # the shipped expected row wherever the mismatch bit is clear.
            # One pool batch: the bookkeeping in key order, then one
            # kernel-G scatter per shard for the rows still resident.
            per_shard = plan.W // mesh.size
            with self.resident.batch():
                for j, i in enumerate(plan.idx):
                    key = keys[i]
                    r = int(plan.rows[j])
                    if errors[r] == 0 and not mismatch[r] and key in addresses:
                        self.resident.admit_row(key, addresses[key], states[r // per_shard],
                                                r % per_shard, expected[r].copy(),
                                                int(exp_branch[r]))
            return mismatch, errors, expected, exp_branch

        plans = self._plan_chunks(keys)
        results, plans = self._run_chunks(keys, pack_extra, launch, readback, escalate,
                                          plans=plans)
        t0 = time.perf_counter()
        ordered = sorted(pending.items())
        outcomes = self.ladder.finish([p for _, (_, p) in ordered])
        resolved = {}  # (ci, local j) -> (base-width ladder row, branch)
        for (ci, (cap, _)), outcome in zip(ordered, outcomes):
            for k, j in enumerate(cap):
                if outcome.resolved[k]:
                    resolved[(ci, int(j))] = (outcome.rows[k], outcome.branch[k])
        t1 = time.perf_counter()

        for ci, (plan, (mismatch, errors, expected, exp_branch)) in enumerate(zip(plans, results)):
            for j, i in enumerate(plan.idx):
                key = keys[i]
                r = int(plan.rows[j])
                if errors[r] != 0 and (ci, j) in resolved:
                    # the widened-K re-replay cleared the capacity flag: the
                    # row verified on the devices, with the same contract as
                    # verify_rows (payload row and branch)
                    result.verified_on_device += 1
                    result.escalated.append(key)
                    rows_l, branch_l = resolved[(ci, j)]
                    if not (rows_l == expected[r]).all() or branch_l != exp_branch[r]:
                        result.divergent.append(key)
                elif errors[r] != 0:
                    # top-rung overflow or a non-capacity error: the
                    # per-workflow oracle arbitrates
                    result.device_errors.append((key, int(errors[r])))
                    result.fallback.append(key)
                    oracle_ms = StateBuilder().replay_history(
                        self.stores.history.as_history_batches(*key))
                    if not (payload_row(oracle_ms, self.layout) == expected[r]).all():
                        result.divergent.append(key)
                else:
                    result.verified_on_device += 1
                    if mismatch[r]:
                        result.divergent.append(key)
        self.last_run.update(expected_rows=sum(expected_seconds), ladder=t1 - t0,
                             arbitrate=time.perf_counter() - t1)
        return result
