#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cadence_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py            # the full run, on one CUDA card
    python3 chip_smoke.py --small    # the same phases at a few thousand workflows

Phases, one JSON line each:
  1. probe: card, power limit, torch, CUDA, SM version, nvcc and Triton
     (cadence_tpu_torch/device.py report); build the kernels (csrc/*.cu)
     from this checkout.
  2. main path, configuration `suites-16k`: the five corpus suites x 16,384
     distinct workflows (seed 20260730, target_events 120), generated in a
     process pool, then replay_corpus(..., device="cuda"), replay_to_crc32 on
     the wire32 lanes and a verify_rows pass. Device CRCs and rows are held
     against the oracle (StateBuilder) on 256 sampled workflows per suite.
     wirec_path: the same lanes through pack_wirec_auto, stage_corpus
     (page-locked memory, a side stream) and replay_wirec_to_crc, whose CRCs
     and errors must equal the int64 path's; the host-to-device time of the
     int64, wire32 and wirec bytes.
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (tolerance 0: every value is an integer), timed with CUDA
     events (median of REPS; only the kernel's launch lies between the
     events, its checks and arguments made before), beside its bound:
     kernel A on int64 and wire32 lanes, kernel A with tasks
     (kernel_replay_tasks: every state tensor and all 12 task-log tensors
     against replay_tasks_scan_plain, the state against kernel A's outside
     the timer-created bits, the task streams against the oracle's on the
     sampled workflows, no overflow at 128/128 and the plain version's
     overflow rows at 4/4), A's wirec reader, B, C, D, and kernel E
     (decode_wirec), which must also give the lanes themselves and,
     replayed by kernel A, the fused reader's state.
  4. the paths the suites never reach: the `overflow` suite, continue-as-new
     chains, divergent branch trees and a lane-level random corpus (also
     packed as wirec, whole and split into a carried prefix and a suffix);
     kernel A must equal the plain version on every state tensor and the
     oracle on the valid histories, and kernel A with tasks its plain
     version on every state and task-log tensor.
  5. fallback_ladder, bench.py's `_fallback_suite` configuration: the
     `overflow` suite x 16,384 (seed 20260730, target_events 120) packed as
     wirec and replayed, the capacity-flagged rows through
     EscalationLadder.escalate_wirec, the rest through the oracle; every
     final CRC must equal the oracle-only arbitration, and the dense
     `escalate` of the same rows must give the same rows and errors.
  6. rebuild_path: DeviceRebuilder(device="cuda").rebuild over the same
     16,384 overflow jobs (a recovery storm of one shard's workflows):
     chunks of task-emitting replay and payload rows through the bulk
     executor, the capacity-flagged jobs through the ladder's
     escalate_states, then hydration; every rebuilt state's payload row
     must equal the oracle's, every job rebuilt on the card and the
     flagged ones by the ladder, none by the oracle. Prints each leg's
     seconds and jobs/s.
Each driven path (main path, wirec_path, fallback_ladder, rebuild_path)
runs with every launch count set to 0 just before it and read just after,
and fails if a kernel of that path was never launched. The last lines are the launch
counts, the card's name and power limit, the per-kernel table, and
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no "ok" line. Without CUDA it exits non-zero at
once.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time
import zlib

# H100 SXM published peaks: HBM bytes/s, and the non-tensor-core scalar rate,
# used for the kernels' integer ALU operations (no integer rate outside the
# tensor cores is published).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

SEED = 20260730
TARGET_EVENTS = 120
REPS = 5  # timed runs per kernel, after one warm-up; the median is kept
PLAIN_REPS = 3  # timed runs of a plain replay, which takes a second or more
DEVICE = "cuda"
#: the kernels each driven path must launch (ops/_build.launches keys)
MAIN_PATH_KERNELS = ("replay", "payload", "crc32", "verify_rows")
WIREC_PATH_KERNELS = ("replay_wirec", "payload", "crc32")
REBUILD_PATH_KERNELS = ("replay_tasks", "payload", "replay")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Host-side corpus generation (a process pool of fresh interpreters)
# ---------------------------------------------------------------------------

def _oracle_row(batches):
    """(payload row with sticky 0, current branch) of the oracle's final
    state, following a continue-as-new chain; None when the payload cannot
    hold the state (TABLE_OVERFLOW rows)."""
    from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    sb = StateBuilder()
    sb.replay_history(batches)
    ms = sb.new_run_state if sb.new_run_state is not None else sb.ms
    try:
        row = payload_row(ms)
    except OverflowError:
        return None
    row[STICKY_ROW_INDEX] = 0
    return row, ms.version_histories.current_index


def _oracle_tasks(batches):
    """The oracle's (transfer, timer) task streams, as tuples of the
    numeric fields a TaskLog holds."""
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    ms = StateBuilder().replay_history(batches)
    return ([(int(t.task_type), t.version, t.event_id) for t in ms.transfer_tasks],
            [(int(t.task_type), t.version, t.visibility_timestamp, t.event_id,
              int(t.timeout_type), t.attempt) for t in ms.timer_tasks])


def _gen_chunk(task):
    """One pool task: (suite, first index, count, sampled indices, with
    task streams) → (histories, {index: (oracle row, branch[, streams])})."""
    from cadence_tpu_torch.gen.corpus import generate_history

    suite, start, count, sample, with_tasks = task
    hs = [generate_history(suite, SEED, i, TARGET_EVENTS) for i in range(start, start + count)]
    oracle = {i: _oracle_row(hs[i - start]) + ((_oracle_tasks(hs[i - start]),)
                                               if with_tasks else ())
              for i in sample}
    return hs, oracle


def _gen_chains(task):
    """Continue-as-new chains: each row is three runs of one suite, packed
    with encode_chain; the oracle witness is the last run's final state."""
    from cadence_tpu_torch.gen.corpus import generate_history
    from cadence_tpu_torch.ops.encode import encode_chain

    suite, start, count, max_events = task
    lanes, oracle = [], {}
    for i in range(start, start + count):
        runs = [generate_history(suite, SEED + r, i, 40) for r in range(3)]
        lanes.append(encode_chain(runs, max_events))
        oracle[i] = _oracle_row(runs[-1])
    return lanes, oracle


def _branch_tree(rng: random.Random, i: int):
    """A divergent version-history tree as tests/test_chain_branch.py builds
    them: a prefix on branch 0, then some of: a losing suffix persisted
    VH-only, a winning fork on branch 1, a stale lower fork, a switch back."""
    from cadence_tpu_torch.core.enums import EventType as ET
    from cadence_tpu_torch.core.events import HistoryBatch, HistoryEvent
    from cadence_tpu_torch.gen.corpus import generate_history

    prefix = generate_history("echo_signal", SEED, i, 30)[:rng.randint(1, 3)]
    v0 = rng.randint(1, 4)
    for b in prefix:
        for e in b.events:
            e.version = v0
    nid = prefix[-1].events[-1].id + 1

    def signals(first, version, n):
        return [HistoryBatch(domain_id="d", workflow_id=f"t{i}", run_id="r", events=[
            HistoryEvent(id=first + k, event_type=ET.WorkflowExecutionSignaled,
                         version=version, timestamp=1000 + first + k) for k in range(n)])]

    segs = [(prefix, 0, 0, False)]
    shape = rng.randrange(4)
    if shape == 0:    # arrival order: losing suffix VH-only, then the winning fork
        segs += [(signals(nid, v0, 2), 0, 0, True), (signals(nid, v0 + 8, 2), 1, 0, False)]
    elif shape == 1:  # local continues higher, a stale lower fork arrives late
        segs += [(signals(nid, v0 + 2, 1), 0, 0, False), (signals(nid, v0 + 1, 1), 1, 0, True)]
    elif shape == 2:  # fork, then the old branch overtakes again
        segs += [(signals(nid, v0 + 3, 2), 1, 0, False),
                 (signals(nid + 2, v0 + 5, 2), 0, 1, False)]
    else:             # several version bumps on a fork
        segs += [(signals(nid + k, v0 + 1 + k, 1), 1, 0, False) for k in range(rng.randint(1, 6))]
    return segs


def _gen_trees(task):
    from cadence_tpu_torch.ops.encode import encode_segments

    start, count, max_events = task
    rng = random.Random(f"{SEED}:trees:{start}")
    return [encode_segments(_branch_tree(rng, i), max_events) for i in range(start, start + count)]


def _chunks(n: int, size: int):
    """(first index, count) of each chunk of `size` covering range(n)."""
    return [(s, min(size, n - s)) for s in range(0, n, size)]


def _concat(tasks, parts):
    """Concatenate the pool's per-task (items, {index: oracle}) results,
    re-basing each task's indices (task[1] is its first) to the whole."""
    items, oracle = [], {}
    for task, (part, orc) in zip(tasks, parts):
        oracle.update({len(items) + i - task[1]: v for i, v in orc.items()})
        items.extend(part)
    return items, oracle


def generate(args):
    """All host corpora, made in one process pool."""
    import multiprocessing as mp

    import numpy as np

    from cadence_tpu_torch.gen.corpus import SUITES

    rng = np.random.default_rng(SEED)
    tasks = []
    for suite in SUITES:
        sample = rng.choice(args.per_suite, size=min(256, args.per_suite), replace=False)
        for start, n in _chunks(args.per_suite, 1024):
            tasks.append((suite, start, n, sorted(int(i) for i in sample
                                                  if start <= i < start + n), True))
    otasks = [("overflow", s, n, list(range(s, s + n)), False)
              for s, n in _chunks(args.overflow, 1024)]
    ctasks = [(SUITES[k % len(SUITES)], s, n, 3 * 80)
              for k, (s, n) in enumerate(_chunks(args.chains, 512))]
    ttasks = [(s, n, 40) for s, n in _chunks(args.trees, 1024)]

    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(os.cpu_count()) as pool:
        pending = [pool.map_async(fn, ts, chunksize=1) for fn, ts in (
            (_gen_chunk, tasks), (_gen_chunk, otasks), (_gen_chains, ctasks), (_gen_trees, ttasks))]
        main_parts, over_parts, chain_parts, tree_parts = (p.get() for p in pending)
    histories, oracle = _concat(tasks, main_parts)
    over_h, over_oracle = _concat(otasks, over_parts)
    chain_lanes, chain_oracle = _concat(ctasks, chain_parts)
    return {
        "histories": histories, "oracle": oracle,
        "overflow": over_h, "overflow_oracle": over_oracle,
        "chains": np.stack(chain_lanes), "chain_oracle": chain_oracle,
        "trees": np.stack([x for part in tree_parts for x in part]),
        "seconds": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
# Device helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = REPS, setup=None, inner: int = 1):
    """Median milliseconds of `fn` over `reps` timed runs (after one warm-up),
    each run `inner` back-to-back calls between two CUDA events; `setup()`
    runs before the first event and its result is `fn`'s argument."""
    import torch

    def once():
        arg = setup() if setup else None
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn(arg)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / inner

    once()
    return statistics.median(once() for _ in range(reps))


def states_equal(a, b, what: str) -> None:
    import torch

    from cadence_tpu_torch.ops.state import leaves

    bad = [n for (n, x), (_, y) in zip(leaves(a), leaves(b))
           if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y)]
    if bad:
        fail(f"{what}: kernel and plain version differ on {bad}")


def logs_equal(a, b, what: str) -> None:
    import torch

    bad = [f for f, x, y in zip(a._fields, a, b)
           if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y)]
    if bad:
        fail(f"{what}: kernel and plain version differ on task-log fields {bad}")


def log_streams(log, w: int):
    """Workflow w's task streams from a TaskLog of numpy arrays, in the
    oracle's tuple form (_oracle_tasks)."""
    tr = [(int(log["tr_type"][w, i]), int(log["tr_version"][w, i]),
           int(log["tr_event_id"][w, i])) for i in range(int(log["tr_count"][w]))]
    tm = [tuple(int(log[f][w, i]) for f in ("tm_type", "tm_version", "tm_vis", "tm_event_id",
                                             "tm_timeout_type", "tm_attempt"))
          for i in range(int(log["tm_count"][w]))]
    return tr, tm


def task_bytes_ops(events, log):
    """What task emission adds to kernel A's work on these lanes: the
    entries this run emitted, each written once (24 B a transfer, 48 B a
    timer), with the counts and overflow flags; as operations, a dozen per
    entry and a K-wide slot walk of the activity and timer tables at each
    applied batch-end event."""
    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as L

    n_tr, n_tm = int(log.tr_count.sum()), int(log.tm_count.sum())
    W = log.tr_count.shape[0]
    ends = int(((events[:, :, 0] > 0) & (events[:, :, 6] == 1)).sum())
    nbytes = n_tr * 24 + n_tm * 48 + W * (8 + 8 + 1)
    ops = 12 * (n_tr + n_tm) + ends * (3 * L.max_activities + 2 * L.max_timers + 30)
    return nbytes, ops


def ptxas_usage(build_log: str, kernel: str) -> dict:
    """Registers and spill bytes nvcc reported for the kernel whose mangled
    name contains `kernel`."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            out = {}
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry function" in nxt:
                    break
                if "registers" in nxt:
                    out["registers"] = int(nxt.split("Used ")[1].split(" registers")[0])
                if "spill" in nxt:
                    out["spill_store_bytes"] = int(nxt.split(" bytes spill stores")[0]
                                                   .split(",")[-1])
                    out["spill_load_bytes"] = int(nxt.split(" bytes spill loads")[0]
                                                  .split(",")[-1])
            return out
    return {}


def state_bytes(s) -> int:
    from cadence_tpu_torch.ops.state import leaves

    return sum(t.numel() * t.element_size() for _, t in leaves(s))


def replay_ops(events, layout=None) -> int:
    """Integer operations kernel A does on these lanes: a fixed cost per real
    event (lane reads, version-history update, guards, batch-end) plus a
    K-wide scan for the event types that look up a table. Counted from the
    event types this run's data holds, not the most it could need."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT
    from cadence_tpu_torch.core.enums import EventType as ET

    L = layout or DEFAULT_LAYOUT
    types = events[:, :, 1].to(torch.int64)
    real = events[:, :, 0] > 0
    counts = torch.bincount((types[real] + 1).clamp(0, 43), minlength=44).cpu().numpy()
    per_type = np.full(44, 80)
    scans = {ET.ActivityTaskScheduled: L.max_activities, ET.ActivityTaskStarted: L.max_activities,
             ET.ActivityTaskCompleted: L.max_activities, ET.ActivityTaskFailed: L.max_activities,
             ET.ActivityTaskTimedOut: L.max_activities, ET.ActivityTaskCanceled: L.max_activities,
             ET.ActivityTaskCancelRequested: L.max_activities,
             ET.TimerStarted: L.max_timers, ET.TimerFired: L.max_timers,
             ET.TimerCanceled: L.max_timers}
    for t, k in scans.items():
        per_type[int(t) + 1] += 3 * k
    return int((counts * per_type).sum())


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip() if out else "nvidia-smi: no output"


def h2d_ms(NW, arrays, dev, reps: int = 3) -> dict:
    """Milliseconds of copying `arrays`, first put in page-locked host
    memory, to the card with native/wirec.stage_h2d (median of `reps`
    after a warm-up): `host`, the host clock from the call to the end of a
    synchronise; `device`, CUDA events on the current stream around it (the
    side stream's copies start after the first and the current stream waits
    for them before the second)."""
    import torch

    tensors = [NW.pinned(a) for a in arrays]

    def once():
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        NW.stage_h2d(tensors, dev)
        b.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, a.elapsed_time(b)

    once()
    runs = [once() for _ in range(reps)]
    return {"host": statistics.median(h for h, _ in runs),
            "device": statistics.median(d for _, d in runs)}


def decode_ops(profile, rows: int) -> int:
    """Integer operations of decoding `rows` wirec event rows: a load, a
    shift and an OR per byte read, a multiply, an add and the padding
    select per lane (the select alone for a CONST lane)."""
    return rows * sum(3 * e.width + 3 if e.width else 1 for e in profile)


def check_launches(launches: dict, path: str, kernels) -> None:
    """Fail unless every kernel of `path` launched in its run."""
    for k in kernels:
        if launches[k] == 0:
            fail(f"{path}: kernel {k} was never launched")


def kernel_record(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops,
                  library_ms=None, **extra):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    rec.update(extra)
    return rec


def max_abs_err(a, b) -> int:
    import torch

    if a.dtype == torch.bool:
        return int((a != b).sum())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--small", action="store_true",
                   help="run every phase at a few thousand workflows")
    args = p.parse_args()
    full = not args.small
    config = "suites-16k" if full else "small"
    args.per_suite = 16384 if full else 512
    args.overflow = 16384 if full else 512
    args.chains = 2048 if full else 128
    args.trees = 4096 if full else 256
    args.lanes_w = 65536 if full else 2048
    args.lanes_e = 128

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from cadence_tpu_torch import device as D
    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT, crc32_of_rows
    from cadence_tpu_torch.engine.ladder import EscalationLadder
    from cadence_tpu_torch.gen.lanes import random_lanes
    from cadence_tpu_torch.native import wirec as NW
    from cadence_tpu_torch.ops import _build, replay as R, wirec as WC
    from cadence_tpu_torch.ops.crc import crc32_launch, crc32_rows, crc32_rows_plain
    from cadence_tpu_torch.ops.encode import (LANE_BRANCH, LANE_EVENT_ID, encode_corpus,
                                              gather_subcorpus, to_wire32)
    from cadence_tpu_torch.ops.payload import (payload_launch, payload_rows, payload_rows_narrow,
                                               payload_rows_narrow_plain)
    from cadence_tpu_torch.ops.convert import task_log_to_numpy
    from cadence_tpu_torch.ops.state import (CAPACITY_ERRORS, init_state, leaves, widen_layout,
                                             widen_state)
    from cadence_tpu_torch.ops.taskgen import init_task_log
    from cadence_tpu_torch.utils.metrics import M_NATIVE_PACKS, SCOPE_TPU_NATIVE, MetricsRegistry

    t_start = time.perf_counter()
    # --- host corpora first, in a pool of spawned workers
    corp = generate(args)
    histories, oracle = corp["histories"], corp["oracle"]
    emit("generate", workflows=len(histories), overflow=len(corp["overflow"]),
         chains=int(corp["chains"].shape[0]), trees=int(corp["trees"].shape[0]),
         workers=os.cpu_count(), seconds=corp["seconds"])

    # --- 1. probe and build
    smi = smi_line()
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.load()
    emit("probe", smi=smi, **D.report(), build_seconds=_build.build_seconds,
         compile_seconds=_build.compile_seconds, load_seconds=time.perf_counter() - t0)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("ptxas:", line.strip(), flush=True)

    # --- 2. the main path (suites-16k)
    t0 = time.perf_counter()
    events_np = encode_corpus(histories)          # also the comparison input
    t_encode = time.perf_counter() - t0
    wire_np = to_wire32(events_np)
    W, E = events_np.shape[:2]
    real = int((events_np[:, :, LANE_EVENT_ID] > 0).sum())
    if (events_np[:, :, LANE_BRANCH] != 0).any():
        fail("suite corpora carry a branch lane")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rows, crcs, errors = R.replay_corpus(histories, device=DEVICE)
    t_corpus = time.perf_counter() - t0
    t1 = time.perf_counter()
    crc_w, err_w = R.replay_to_crc32(wire_np, device=DEVICE)
    s32 = R.replay_events32(wire_np, device=DEVICE)
    rows32 = payload_rows(s32)
    mismatch = R.verify_rows(rows32, torch.from_numpy(rows).to(dev), s32.current_branch,
                             torch.zeros(W, dtype=torch.int32, device=dev), device=DEVICE)
    mismatch_np = mismatch.cpu().numpy()
    torch.cuda.synchronize()
    t_wire = time.perf_counter() - t1
    main_launches = dict(_build.launches)
    if (errors != 0).any():
        fail(f"main path: {int((errors != 0).sum())} rows with errors {np.unique(errors)}")
    if not np.array_equal(crc_w.cpu().numpy().astype(np.uint32), crcs):
        fail("main path: wire32 CRCs differ from the int64 path")
    if not np.array_equal(err_w.cpu().numpy(), errors):
        fail("main path: wire32 errors differ")
    if mismatch_np.any():
        fail(f"main path: verify_rows flags {int(mismatch_np.sum())} rows")
    bad = []
    for i, (row, branch, _) in oracle.items():
        if (not np.array_equal(rows[i], row) or crcs[i] != crc32_of_rows(row[None])[0]
                or branch != 0):
            bad.append(i)
    if bad:
        fail(f"main path: {len(bad)} sampled rows differ from the oracle, first {bad[:5]}")
    zl = np.array([zlib.crc32(r.astype("<i8").tobytes()) for r in rows[:4096]], dtype=np.uint32)
    if not np.array_equal(zl, crcs[:4096]):
        fail("main path: device CRCs differ from zlib")
    check_launches(main_launches, "main path", MAIN_PATH_KERNELS)
    emit("main_path", config=config, workflows=W, max_events=E, real_events=real,
         oracle_sampled=len(oracle), encode_s=t_encode, replay_corpus_s=t_corpus,
         wire32_and_verify_s=t_wire, launches=main_launches,
         lanes_bytes=int(events_np.nbytes), wire32_bytes=int(wire_np.nbytes))

    # --- wirec_path: the same lanes compressed, staged and replayed with the
    # decode fused into kernel A
    reg = MetricsRegistry()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    wc = NW.pack_wirec_auto(events_np, registry=reg)
    t_pack = time.perf_counter() - t0
    t1 = time.perf_counter()
    crc_c, err_c = R.replay_wirec_to_crc(*NW.stage_corpus(wc, dev), wc.profile, device=DEVICE)
    crc_c, err_c = crc_c.cpu().numpy().astype(np.uint32), err_c.cpu().numpy()
    t_wirec = time.perf_counter() - t1
    wirec_launches = dict(_build.launches)
    if not np.array_equal(crc_c, crcs) or not np.array_equal(err_c, errors):
        fail("wirec_path: CRCs or errors differ from the int64 path")
    check_launches(wirec_launches, "wirec_path", WIREC_PATH_KERNELS)
    h2d = {fmt: h2d_ms(NW, arrays, dev) for fmt, arrays in (
        ("int64", [events_np]), ("wire32", [wire_np]),
        ("wirec", [wc.slab, wc.bases, wc.n_events]))}
    emit("wirec_path", native_packer=reg.counter(SCOPE_TPU_NATIVE, M_NATIVE_PACKS) == 1,
         pack_s=t_pack, stage_and_replay_s=t_wirec, wirec_bytes=wc.wire_bytes,
         bytes_per_event=wc.bytes_per_event(), lanes_bytes_per_event=events_np.nbytes / real,
         wire32_bytes_per_event=wire_np.nbytes / real, slab_bytes_per_row=int(wc.slab.shape[2]),
         h2d_ms=h2d, launches=wirec_launches)

    # --- 3. each kernel against its plain version, at the main path's shapes; timed
    ev = torch.from_numpy(events_np).to(dev)
    ev32 = torch.from_numpy(wire_np).to(dev)
    records = []  # "launches" is filled in from the driven paths' counts at the end

    fresh = lambda: init_state(W, DEFAULT_LAYOUT, dev)  # noqa: E731
    s_k = R.replay_scan(fresh(), ev)
    s_p = R.replay_scan_plain(fresh(), ev)
    states_equal(s_k, s_p, "replay int64")
    s_k32 = R.replay_scan(fresh(), ev32, wire32=True)
    states_equal(s_k32, s_p, "replay wire32")
    states_equal(R.replay_scan_plain(fresh(), ev32, wire32=True), s_p, "plain wire32")
    err_a = max(max_abs_err(x, y) for s in (s_k, s_k32)
                for (_, x), (_, y) in zip(leaves(s), leaves(s_p)))
    launch = lambda run: run()  # noqa: E731
    ms_a = cuda_ms(launch, setup=lambda: R.replay_launch(fresh(), ev))
    ms_a32 = cuda_ms(launch, setup=lambda: R.replay_launch(fresh(), ev32, wire32=True))
    ms_ap = cuda_ms(lambda s: R.replay_scan_plain(s, ev), 3, setup=fresh)
    ms_ap32 = cuda_ms(lambda s: R.replay_scan_plain(s, ev32, wire32=True), 3, setup=fresh)
    sb = state_bytes(s_k)
    records.append(kernel_record(
        "replay", "cadence_tpu_torch/csrc/replay.cu", "cadence_tpu/ops/transitions.py:154",
        None, err_a, ms_a, ms_ap, ev.numel() * 8 + sb, replay_ops(ev),
        ms_wire32=ms_a32, plain_ms_wire32=ms_ap32,
        bound_ms_wire32=(ev32.numel() * 4 + sb) / HBM_BYTES_PER_S * 1e3,
        events_per_s=real / (ms_a / 1e3), events_per_s_wire32=real / (ms_a32 / 1e3),
        timed=f"median of {REPS} single launches, each on a fresh state; plain: median of 3"))
    emit("kernel_replay", equal_states=66, max_abs_err=err_a, ms=ms_a, ms_wire32=ms_a32,
         plain_ms=ms_ap, events_per_s=real / (ms_a / 1e3), device=name, smi=smi)

    # A with tasks: kernel A's TASKS variant against its plain version, the
    # oracle's task streams, and kernel A without tasks
    fresh_log = lambda cap=128: init_task_log(W, cap, cap, dev)  # noqa: E731
    s_t, log_t = R.replay_tasks_scan(fresh(), fresh_log(), ev)
    s_tp, log_tp = R.replay_tasks_scan_plain(fresh(), fresh_log(), ev)
    states_equal(s_t, s_tp, "replay with tasks")
    logs_equal(log_t, log_tp, "replay with tasks")
    pairs = [(x, y) for (_, x), (_, y) in zip(leaves(s_t), leaves(s_tp))]
    err_t = max(max_abs_err(x, y) for x, y in pairs + list(zip(log_t, log_tp)))
    s_t32, log_t32 = R.replay_tasks_scan(fresh(), fresh_log(), ev32, wire32=True)
    states_equal(s_t32, s_t, "replay with tasks, wire32 lanes against int64 lanes")
    logs_equal(log_t32, log_t, "replay with tasks, wire32 lanes against int64 lanes")
    del s_t32, log_t32
    timer_bits = {"activities.timer_status", "timers.task_status"}
    differ = {n for (n, x), (_, y) in zip(leaves(s_t), leaves(s_k)) if not torch.equal(x, y)}
    if not differ <= timer_bits:
        fail(f"replay with tasks: state differs from kernel A's outside the timer bits: {differ}")
    if bool(log_t.overflow.any()):
        fail(f"replay with tasks: {int(log_t.overflow.sum())} rows overflow at 128/128")
    log_np = task_log_to_numpy(log_t)
    bad = [i for i, (_, _, streams) in oracle.items() if log_streams(log_np, i) != streams]
    if bad:
        fail(f"replay with tasks: {len(bad)} sampled task streams differ from the oracle, "
             f"first {bad[:5]}")
    s4, log4 = R.replay_tasks_scan(fresh(), fresh_log(4), ev)
    s4p, log4p = R.replay_tasks_scan_plain(fresh(), fresh_log(4), ev)
    states_equal(s4, s4p, "replay with tasks at 4/4")
    logs_equal(log4, log4p, "replay with tasks at 4/4")
    overflow_at_4 = int(log4.overflow.sum())
    if not overflow_at_4:
        fail("replay with tasks at 4/4: no row overflows")
    del s_tp, log_tp, pairs, s4, log4, s4p, log4p
    ms_t = cuda_ms(launch, setup=lambda: R.replay_tasks_launch(fresh(), fresh_log(), ev))
    ms_tp = cuda_ms(lambda a: R.replay_tasks_scan_plain(a[0], a[1], ev), PLAIN_REPS,
                    setup=lambda: (fresh(), fresh_log()))
    ms_fill = cuda_ms(lambda _: fresh_log(), inner=5)
    t_bytes, t_ops = task_bytes_ops(ev, log_t)
    log_bytes = sum(t.numel() * t.element_size() for t in log_t)
    regs = ptxas_usage(_build.build_log, "replay_kernelILi0ELb1E")
    records.append(kernel_record(
        "replay_tasks", "cadence_tpu_torch/csrc/replay.cu", "cadence_tpu/ops/taskgen.py:221",
        None, err_t, ms_t, ms_tp, ev.numel() * 8 + sb + t_bytes, replay_ops(ev) + t_ops,
        hook="cadence_tpu_torch/csrc/taskgen.cuh", no_tasks_ms=ms_a,
        init_task_log_ms=ms_fill, init_task_log_bound_ms=log_bytes / HBM_BYTES_PER_S * 1e3,
        transfer_entries=int(log_t.tr_count.sum()), timer_entries=int(log_t.tm_count.sum()),
        ptxas=regs, ptxas_no_tasks=ptxas_usage(_build.build_log, "replay_kernelILi0ELb0E"),
        timed=f"median of {REPS} single launches, each on a fresh state and log; "
              f"plain: median of {PLAIN_REPS}"))
    emit("kernel_replay_tasks", equal_states=66, equal_log_tensors=12, wire32_equal=True,
         max_abs_err=err_t, ms=ms_t, no_tasks_ms=ms_a, plain_ms=ms_tp, init_task_log_ms=ms_fill,
         oracle_streams_equal=len(oracle), state_differs_from_kernel_a_in=sorted(differ),
         transfer_entries=int(log_t.tr_count.sum()), timer_entries=int(log_t.tm_count.sum()),
         overflow_rows_at_4=overflow_at_4, ptxas=regs)
    del s_t, log_t, log_np

    # B: base layout, and a 2x-widened state projected to the base layout
    rows_k, ovf_k = payload_rows_narrow(s_k, DEFAULT_LAYOUT)
    rows_p, ovf_p = payload_rows_narrow_plain(s_k, DEFAULT_LAYOUT)
    err_b = max(max_abs_err(rows_k, rows_p), max_abs_err(ovf_k, ovf_p))
    wide = widen_state(s_k, widen_layout(DEFAULT_LAYOUT, 2))
    wk, wo = payload_rows_narrow(wide, DEFAULT_LAYOUT)
    wp, wpo = payload_rows_narrow_plain(wide, DEFAULT_LAYOUT)
    err_b = max(err_b, max_abs_err(wk, wp), max_abs_err(wo, wpo), max_abs_err(wk, rows_p))
    if err_b:
        fail(f"payload kernel differs from its plain version (max abs err {err_b})")
    ms_b = cuda_ms(launch, setup=lambda: payload_launch(s_k, DEFAULT_LAYOUT)[0], inner=20)
    ms_bp = cuda_ms(lambda _: payload_rows_narrow_plain(s_k, DEFAULT_LAYOUT))
    masked = [torch.where(t.occ, ids, torch.full_like(ids, 1 << 62)) for t, ids in (
        (s_k.timers, s_k.timers.started_id), (s_k.activities, s_k.activities.schedule_id),
        (s_k.children, s_k.children.initiated_id), (s_k.signals, s_k.signals.initiated_id),
        (s_k.cancels, s_k.cancels.initiated_id))]
    ms_sort = cuda_ms(lambda _: [torch.sort(m, dim=1) for m in masked], inner=20)
    L = DEFAULT_LAYOUT
    kv, b = L.max_version_history_items, L.max_branches
    tables = [(L.max_timers, 9), (L.max_activities, 9), (L.max_children, 9),
              (L.max_signals, 9), (L.max_request_cancels, 9)]
    b_read = W * (10 * 8 + 4 + 1 + 4 + 4 + 2 * kv * 8 + sum(k * bpk for k, bpk in tables))
    b_ops = W * sum(3 * k * k for k, _ in tables)
    records.append(kernel_record(
        "payload", "cadence_tpu_torch/csrc/payload.cu", "cadence_tpu/ops/payload.py:36",
        None, err_b, ms_b, ms_bp, b_read + W * (L.width * 8 + 1), b_ops,
        yardstick="torch.sort of the five masked ID tables", yardstick_ms=ms_sort))
    emit("kernel_payload", max_abs_err=err_b, ms=ms_b, plain_ms=ms_bp, torch_sort_ms=ms_sort)

    # C: CRC32 against the plain version and zlib
    c_k = crc32_rows(rows_k)
    c_p = crc32_rows_plain(rows_k)
    err_c = max_abs_err(c_k, c_p)
    zl = np.array([zlib.crc32(r.astype("<i8").tobytes()) for r in rows_k[:4096].cpu().numpy()])
    if err_c or not np.array_equal(c_k[:4096].cpu().numpy(), zl):
        fail(f"crc32 kernel differs from its plain version or zlib (max abs err {err_c})")
    ms_c = cuda_ms(launch, setup=lambda: crc32_launch(rows_k)[0], inner=20)
    ms_cp = cuda_ms(lambda _: crc32_rows_plain(rows_k))
    records.append(kernel_record(
        "crc32", "cadence_tpu_torch/csrc/crc32.cu", "cadence_tpu/ops/crc.py:50",
        None, err_c, ms_c, ms_cp, W * L.width * 8 + W * 8,
        W * L.width * 24))
    emit("kernel_crc32", max_abs_err=err_c, ms=ms_c, plain_ms=ms_cp)

    # D: verify with planted differences
    g = torch.Generator(device="cpu").manual_seed(SEED)
    exp_rows = rows_k.clone()
    plant = torch.rand(W, generator=g) < 0.1
    cols = torch.randint(0, L.width, (W,), generator=g)
    exp_rows[plant.to(dev), cols.to(dev)[plant.to(dev)]] += 1
    branch = s_k.current_branch
    exp_branch = branch.clone()
    flip = (torch.rand(W, generator=g) < 0.05).to(dev)
    exp_branch[flip] = 1 - exp_branch[flip]
    v_k = R.verify_rows(rows_k, exp_rows, branch, exp_branch, device=DEVICE)
    v_p = R.verify_rows_plain(rows_k, exp_rows, branch, exp_branch)
    err_d = max_abs_err(v_k, v_p)
    if err_d or not v_k.any() or v_k.all():
        fail(f"verify_rows kernel differs from its plain version ({err_d} bits)")
    ms_d = cuda_ms(launch, setup=lambda: R.verify_launch(rows_k, exp_rows, branch, exp_branch)[0],
                   inner=20)
    ms_dp = cuda_ms(lambda _: R.verify_rows_plain(rows_k, exp_rows, branch, exp_branch))
    records.append(kernel_record(
        "verify_rows", "cadence_tpu_torch/csrc/verify.cu", "cadence_tpu/ops/replay.py:330",
        None, err_d, ms_d, ms_dp, 2 * W * L.width * 8 + 2 * W * 4 + W,
        W * (L.width + 1), yardstick="(rows != expected).any(1) | (branch != expected_branch)",
        yardstick_ms=ms_dp))
    emit("kernel_verify_rows", max_abs_err=err_d, planted=int(v_p.sum()), ms=ms_d, plain_ms=ms_dp)
    # A's wirec reader, on the main path's wirec corpus staged afresh
    slab_d, bases_d, n_d = NW.stage_corpus(wc, dev)
    prof = wc.profile
    s_kw = R.wirec_scan(fresh(), slab_d, bases_d, n_d, prof)
    s_pw = R.wirec_scan_plain(fresh(), slab_d, bases_d, n_d, prof)
    states_equal(s_kw, s_pw, "replay wirec")
    states_equal(s_kw, s_k, "replay wirec against replay int64")
    err_aw = max(max_abs_err(x, y) for (_, x), (_, y) in zip(leaves(s_kw), leaves(s_pw)))
    del s_pw
    half = E // 2
    carried = R.replay_scan(fresh(), ev[:, :half].contiguous())
    suffix = NW.pack_wirec_auto(events_np[:, half:], registry=reg)
    states_equal(R.replay_wirec_from_state(*NW.stage_corpus(suffix, dev), suffix.profile,
                                           carried, device=DEVICE), s_k,
                 "replay wirec of the suffix from a carried prefix against replay int64")
    del carried
    ms_aw = cuda_ms(launch, setup=lambda: R.wirec_launch(fresh(), slab_d, bases_d, n_d, prof))
    ms_awp = cuda_ms(lambda s: R.wirec_scan_plain(s, slab_d, bases_d, n_d, prof), PLAIN_REPS,
                     setup=fresh)
    wirec_in = slab_d.numel() + bases_d.numel() * 8 + n_d.numel() * 4
    records.append(kernel_record(
        "replay_wirec", "cadence_tpu_torch/csrc/replay.cu", "cadence_tpu/ops/replay.py:121",
        None, err_aw, ms_aw, ms_awp, wirec_in + sb, replay_ops(ev) + decode_ops(prof, W * E),
        events_per_s=real / (ms_aw / 1e3), int64_ms=ms_a,
        timed=f"median of {REPS} single launches, each on a fresh state; "
              f"plain: median of {PLAIN_REPS}"))
    emit("kernel_replay_wirec", equal_states=66, max_abs_err=err_aw, ms=ms_aw, plain_ms=ms_awp,
         int64_ms=ms_a, events_per_s=real / (ms_aw / 1e3),
         slab_bytes_per_row=int(slab_d.shape[2]))

    # E: the full-tensor decode, against its plain version, the lanes
    # themselves, and kernel A's fused reader
    d_k = WC.decode_wirec(slab_d, bases_d, n_d, prof, device=DEVICE)
    d_p = WC.decode_wirec_plain(slab_d, bases_d, n_d, prof)
    err_e = max_abs_err(d_k, d_p)
    if err_e or not torch.equal(d_k, ev):
        fail(f"decode_wirec kernel differs from its plain version or the lanes ({err_e})")
    del d_p
    states_equal(R.replay_scan(fresh(), d_k), s_kw,
                 "kernel A on kernel E's output against the fused reader")
    ms_e = cuda_ms(launch, setup=lambda: WC.decode_launch(slab_d, bases_d, n_d, prof)[0],
                   inner=5)
    ms_ep = cuda_ms(lambda _: WC.decode_wirec_plain(slab_d, bases_d, n_d, prof))
    records.append(kernel_record(
        "decode_wirec", "cadence_tpu_torch/csrc/wirec.cu", "cadence_tpu/ops/wirec.py:355",
        None, err_e, ms_e, ms_ep, wirec_in + d_k.numel() * 8, decode_ops(prof, W * E),
        on_main_path=False))
    emit("kernel_decode_wirec", max_abs_err=err_e, equal_to_lanes=True, ms=ms_e, plain_ms=ms_ep)
    del s_k, s_p, s_k32, s_kw, wide, ev, ev32, d_k, slab_d, bases_d, n_d

    # --- 4. the paths the suites never reach
    task_checks = {}

    def both(lanes, what, layout=DEFAULT_LAYOUT):
        """Kernel A, kernel A with tasks and kernel B against their plain
        versions on these lanes."""
        evd = torch.from_numpy(np.ascontiguousarray(lanes)).to(dev)
        Wl = evd.shape[0]
        k = R.replay_scan(init_state(Wl, layout, dev), evd)
        states_equal(k, R.replay_scan_plain(init_state(Wl, layout, dev), evd), what)
        rk, ok = payload_rows_narrow(k, DEFAULT_LAYOUT)
        rp, op = payload_rows_narrow_plain(k, DEFAULT_LAYOUT)
        if max_abs_err(rk, rp) or max_abs_err(ok, op):
            fail(f"{what}: payload kernel differs from its plain version")
        kt, lt = R.replay_tasks_scan(init_state(Wl, layout, dev), init_task_log(Wl, 128, 128, dev),
                                     evd)
        pt, lp = R.replay_tasks_scan_plain(init_state(Wl, layout, dev),
                                           init_task_log(Wl, 128, 128, dev), evd)
        states_equal(kt, pt, f"{what} with tasks")
        logs_equal(lt, lp, f"{what} with tasks")
        task_checks[what] = {"transfer_entries": int(lt.tr_count.sum()),
                             "timer_entries": int(lt.tm_count.sum()),
                             "overflow_rows": int(lt.overflow.sum())}
        return k, rk.cpu().numpy()

    def against_oracle(rows_, errs, orc, what):
        """Rows without an error equal the oracle's; a row the device flags
        may only carry a capacity error (the oracle has no capacities), and
        a state the payload cannot hold must be flagged."""
        n = 0
        for i, v in orc.items():
            if errs[i] != 0:
                if errs[i] not in CAPACITY_ERRORS:
                    fail(f"{what}: row {i} has error {errs[i]} on a valid history")
                continue
            if v is None or not np.array_equal(rows_[i], v[0]):
                fail(f"{what}: row {i} differs from the oracle")
            n += 1
        return n

    over_ev = encode_corpus(corp["overflow"])
    k, r = both(over_ev, "overflow suite")
    errs = k.error.cpu().numpy()
    n_or = against_oracle(r, errs, corp["overflow_oracle"], "overflow suite")
    if not (errs == 10).any():
        fail("overflow suite: no TABLE_OVERFLOW row")
    emit("overflow_suite", workflows=len(errs), table_overflow=int((errs == 10).sum()),
         oracle_equal=n_or)

    k, r = both(corp["chains"], "continue-as-new chains")
    errs = k.error.cpu().numpy()
    n_ch = against_oracle(r, errs, corp["chain_oracle"], "chains")
    emit("chains", workflows=len(errs), resets=int((corp["chains"][:, :, 17] & 1).sum()),
         oracle_equal=n_ch)

    k, _ = both(corp["trees"], "branch trees")
    cb = k.current_branch.cpu().numpy()
    if not (cb == 1).any() or (k.error.cpu().numpy() != 0).any():
        fail("branch trees: no branch switch, or an error")
    emit("branch_trees", workflows=len(cb), switched=int((cb == 1).sum()))

    t0 = time.perf_counter()
    lanes = random_lanes(args.lanes_w, args.lanes_e, SEED)
    t_lanes = time.perf_counter() - t0
    k, _ = both(lanes, "random lanes")
    both(lanes[: args.lanes_w // 8], "random lanes at 2x", widen_layout(DEFAULT_LAYOUT, 2))
    half = args.lanes_e // 2
    carried = R.replay_events(lanes[:, :half], device=DEVICE)
    states_equal(R.replay_from_state(lanes[:, half:], carried, device=DEVICE), k,
                 "random lanes from a carried state")
    codes = np.bincount(k.error.cpu().numpy(), minlength=15).tolist()
    if 0 in codes[1:15]:
        fail(f"random lanes: some error code never fired {codes}")
    emit("random_lanes", workflows=args.lanes_w, events=args.lanes_e, error_codes=codes,
         gen_seconds=t_lanes, replay_tasks_equal_plain=task_checks)

    # the random lanes as wirec (no-op rows between real ones: the decode
    # is the JAX package's, not the lanes), whole and as a carried split
    lw = NW.pack_wirec_auto(lanes, registry=reg)
    parts = NW.stage_corpus(lw, dev)
    fresh_l = lambda: init_state(args.lanes_w, DEFAULT_LAYOUT, dev)  # noqa: E731
    kw = R.wirec_scan(fresh_l(), *parts, lw.profile)
    states_equal(kw, R.wirec_scan_plain(fresh_l(), *parts, lw.profile), "random lanes as wirec")
    dk = WC.decode_wirec(*parts, lw.profile, device=DEVICE)
    if not torch.equal(dk, WC.decode_wirec_plain(*parts, lw.profile)):
        fail("random lanes: decode_wirec kernel differs from its plain version")
    states_equal(R.replay_scan(fresh_l(), dk), kw,
                 "random lanes: kernel A on kernel E's output against the fused reader")
    sw = NW.pack_wirec_auto(lanes[:, half:], registry=reg)
    sparts = NW.stage_corpus(sw, dev)
    states_equal(R.replay_wirec_from_state(*sparts, sw.profile, carried, device=DEVICE),
                 R.wirec_scan_plain(carried, *sparts, sw.profile),
                 "random lanes as wirec from a carried state")
    emit("random_lanes_wirec", workflows=args.lanes_w, slab_bytes_per_row=int(lw.slab.shape[2]),
         suffix_slab_bytes_per_row=int(sw.slab.shape[2]),
         errors=int((kw.error != 0).sum()))
    del kw, dk, parts, sparts, carried, k

    # --- 5. fallback_ladder: bench.py's _fallback_suite on the card
    over_oracle = corp["overflow_oracle"]

    def oracle_crc(i):
        v = over_oracle.get(int(i))
        if v is None:
            fail(f"fallback_ladder: row {i} has no oracle row at the base layout")
        return np.uint32(crc32_of_rows(v[0][None])[0])

    lreg = MetricsRegistry()
    ladder = EscalationLadder(DEFAULT_LAYOUT, registry=lreg, device=DEVICE)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    oc = NW.pack_wirec_auto(over_ev, registry=lreg)
    crc_o, err_o = R.replay_wirec_to_crc(*NW.stage_corpus(oc, dev), oc.profile, device=DEVICE)
    crc_o, err_o = crc_o.cpu().numpy().astype(np.uint32), err_o.cpu().numpy()
    t1 = time.perf_counter()
    flagged = np.nonzero(err_o != 0)[0]
    cap = ladder.capacity_flagged(err_o)
    residual = sorted(set(flagged.tolist()) - set(cap.tolist()))
    crc_l, resolved, err_l = ladder.escalate_wirec(oc, cap)
    final = crc_o.copy()
    final[cap[resolved]] = crc_l[resolved]
    residual += cap[~resolved].tolist()
    t2 = time.perf_counter()
    for i in residual:
        final[i] = oracle_crc(i)
    t3 = time.perf_counter()
    ladder_launches = dict(_build.launches)
    check_launches(ladder_launches, "fallback_ladder", WIREC_PATH_KERNELS)
    rungs, counters = list(ladder.last_run), lreg.snapshot()
    if not len(cap):
        fail("fallback_ladder: no capacity-flagged row")
    oracle_only = crc_o.copy()
    for i in flagged:
        oracle_only[i] = oracle_crc(i)
    if not np.array_equal(final, oracle_only):
        fail(f"fallback_ladder: {int((final != oracle_only).sum())} CRCs differ from the "
             "oracle-only arbitration")
    bad = [i for i in np.nonzero(err_o == 0)[0] if crc_o[i] != oracle_crc(i)]
    if bad:
        fail(f"fallback_ladder: {len(bad)} unflagged rows differ from the oracle")
    dense = ladder.escalate(gather_subcorpus(over_ev, cap))
    if (not np.array_equal(dense.resolved, resolved) or not np.array_equal(dense.errors, err_l)
            or [r["rows"] for r in dense.rungs] != [r["rows"] for r in rungs]
            or not np.array_equal(crc32_of_rows(dense.rows[resolved]), crc_l[resolved])):
        fail("fallback_ladder: the dense ladder differs from the wirec ladder")
    # row 9's rung timed alone, at the first rung's shapes: kernel A's wirec
    # reader at the widened layout on the padded sub-corpus, B's narrow
    # projection to the base layout, C
    Wp, Ep = ladder._pad_dims(len(cap), int(oc.n_events[cap].max()))
    sub = WC.gather_corpus(oc, cap, Wp, Ep)
    rparts = NW.stage_corpus(sub, dev)
    fresh_r = lambda: init_state(Wp, ladder.rung_layout(1), dev)  # noqa: E731
    s_r = R.wirec_scan(fresh_r(), *rparts, sub.profile)
    rows_r, _ = payload_rows_narrow(s_r, DEFAULT_LAYOUT)
    rung_ms = {
        "replay_wirec": cuda_ms(launch, setup=lambda: R.wirec_launch(fresh_r(), *rparts,
                                                                     sub.profile)),
        "payload": cuda_ms(launch, setup=lambda: payload_launch(s_r, DEFAULT_LAYOUT)[0],
                           inner=20),
        "crc32": cuda_ms(launch, setup=lambda: crc32_launch(rows_r)[0], inner=20)}
    rung_plain_ms = cuda_ms(lambda st: crc32_rows_plain(payload_rows_narrow_plain(
        R.wirec_scan_plain(st, *rparts, sub.profile), DEFAULT_LAYOUT)[0]), PLAIN_REPS,
        setup=fresh_r)
    rung_bytes = sum(t.numel() * t.element_size() for t in rparts) + Wp * (8 + 4 + 1)
    rung_ops = (replay_ops(WC.decode_wirec_plain(*rparts, sub.profile), ladder.rung_layout(1))
                + decode_ops(sub.profile, Wp * Ep) + Wp * DEFAULT_LAYOUT.width * 24)
    rung_bound = max(rung_bytes / HBM_BYTES_PER_S, rung_ops / SCALAR_OPS_PER_S) * 1e3
    del s_r, rows_r, rparts
    emit("fallback_ladder", workflows=len(err_o),
         events=int((over_ev[:, :, LANE_EVENT_ID] > 0).sum()), flagged=len(flagged),
         capacity_flagged=len(cap), resolved=int(resolved.sum()),
         residual_oracle_rows=len(residual), oracle_fallback_rate=len(flagged) / len(err_o),
         rungs=rungs, replay_s=t1 - t0, ladder_s=t2 - t1, oracle_s=t3 - t2, total_s=t3 - t0,
         crc_parity_oracle_only=True, dense_ladder_equal=True, launches=ladder_launches,
         counters=counters, rung1_shape=[Wp, Ep], rung1_ms=rung_ms,
         rung1_kernels_ms=sum(rung_ms.values()), rung1_plain_ms=rung_plain_ms,
         rung1_bound_ms=rung_bound,
         rung1_bound_by="bytes" if rung_bytes / HBM_BYTES_PER_S >= rung_ops / SCALAR_OPS_PER_S
         else "operations")

    # --- 6. rebuild_path: the device rebuilder over the overflow jobs, a
    # recovery storm of one shard's workflows
    from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
    from cadence_tpu_torch.engine.rebuild import DeviceRebuilder
    from cadence_tpu_torch.utils import metrics as M

    jobs = [(h, None) for h in corp["overflow"]]
    M.DEFAULT_REGISTRY.reset()
    rb = DeviceRebuilder(DEFAULT_LAYOUT, device=DEVICE)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rebuilt = rb.rebuild(jobs)
    t_rebuild = time.perf_counter() - t0
    rebuild_launches = dict(_build.launches)
    check_launches(rebuild_launches, "rebuild_path", REBUILD_PATH_KERNELS)
    stats = rb.stats
    if (stats.device, stats.ladder, stats.oracle_fallback) != (len(jobs), len(cap), 0):
        fail(f"rebuild_path: stats {stats}, expected {len(jobs)} on the card, {len(cap)} "
             "through the ladder, none by the oracle")
    bad = []
    for i, ms in enumerate(rebuilt):
        row = payload_row(ms)
        row[STICKY_ROW_INDEX] = 0
        v = over_oracle.get(i)
        if v is None or not np.array_equal(row, v[0]):
            bad.append(i)
    if bad:
        fail(f"rebuild_path: {len(bad)} rebuilt payload rows differ from the oracle, "
             f"first {bad[:5]}")
    legs = {leg: M.DEFAULT_REGISTRY.histogram(M.SCOPE_REBUILD, leg).total
            for leg in (M.M_PROFILE_PACK, M.M_PROFILE_PACK_WAIT, M.M_PROFILE_H2D,
                        M.M_PROFILE_KERNEL, M.M_PROFILE_READBACK)}
    legs.update({"hydrate": rb.last_run["hydrate"], "ladder": rb.last_run["ladder"]})
    emit("rebuild_path", jobs=len(jobs), chunk_jobs=rb.chunk_jobs,
         chunks=-(-len(jobs) // rb.chunk_jobs), device=stats.device, ladder=stats.ladder,
         oracle_fallback=stats.oracle_fallback, kernel_errors=stats.kernel_errors,
         payload_equal_oracle=len(jobs), seconds=t_rebuild, jobs_per_s=len(jobs) / t_rebuild,
         pipeline_s=rb.last_run["device"], leg_seconds=legs,
         ladder_rungs=list(rb.ladder.last_run), launches=rebuild_launches)
    del rebuilt, jobs

    # --- the summary lines
    paths = {"main_path": main_launches, "wirec_path": wirec_launches,
             "fallback_ladder": ladder_launches, "rebuild_path": rebuild_launches}
    for rec in records:
        rec["launches"] = sum(p[rec["name"]] for p in paths.values())
    print(json.dumps({"launches": paths}))
    print(smi)
    print(json.dumps({"kernels": records, "device": name, "smi": smi,
                      "config": config,
                      "total_seconds": time.perf_counter() - t_start}, default=float))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
