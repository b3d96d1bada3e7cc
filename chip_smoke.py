#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cadence_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py            # the full run, on one CUDA card
    python3 chip_smoke.py --small    # the same phases at a few thousand workflows
                                     # (the north star at 16,384 x 200)
    python3 chip_smoke.py --shapes-only  # the suites corpus, the build,
                                     # kernel_launch_shapes and kernel_replay_traps
    python3 chip_smoke.py --visibility-only  # the build, kernel_vis, vis_staging
                                     # and visibility_path
    python3 chip_smoke.py --new-phases-only  # their corpora, the build, fuzz_parity,
                                     # migration_path and replication_apply
    python3 chip_smoke.py --parent DIR [--variants [NAME,...]]  # also time another
                                     # checkout's kernels A, B, C, D, E, G, H, I,
                                     # J, K, L and A's generator reader (and
                                     # VARIANTS) in kernel_launch_shapes and
                                     # kernel_vis

Phases, one JSON line each:
  1. probe: card, power limit, torch, CUDA, SM version, nvcc and Triton
     (cadence_tpu_torch/device.py report); build the kernels (csrc/*.cu)
     from this checkout.
  2. main path, configuration `suites-8k`: the five corpus suites x 8,192
     distinct workflows (seed 20260730, target_events 120), generated in a
     process pool, then replay_corpus(..., device="cuda"), replay_to_crc32 on
     the wire32 lanes and a verify_rows pass. Device CRCs and rows are held
     against the oracle (StateBuilder) on 256 sampled workflows per suite.
     The same lanes through the path's other entry points: StreamingReplayer
     in event chunks of 32 (the one-shot replay's rows and errors),
     replay_sharded_crc on the wire32 lanes over meshes of 1 and 2 slices
     of the card (replay_to_crc32's CRCs, and stats equal to the plain
     counts), and replay_corpus_mesh at 4,096 workflows a chunk
     (replay_corpus's rows).
     wirec_path: the same lanes through pack_wirec_auto, stage_corpus
     (page-locked memory, a side stream) and replay_wirec_to_crc, whose CRCs
     and errors must equal the int64 path's, then stream_wirec_mesh in 4
     workflow chunks, which must give the same CRCs; the host-to-device
     time of the int64, wire32 and wirec bytes.
     feeder_path: the same histories' wire bytes (serialized in the
     generation pool) through feed_serialized, feed_serialized32 and
     feed_serialized_wirec at 4,096 workflows a chunk: rows, CRCs and errors
     equal to the int64 path's, every real event counted, the native wirec
     encoder serving; each feed's wall, pack, pack-queue-wait and H2D
     seconds and events/s.
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (tolerance 0: every value is an integer), timed with CUDA
     events (median of REPS; only the kernel's launch lies between the
     events, its checks and arguments made before), beside its bound:
     kernel A on int64 and wire32 lanes, kernel A with tasks
     (kernel_replay_tasks: every state tensor and all 12 task-log tensors
     against replay_tasks_scan_plain, the state against kernel A's outside
     the timer-created bits, the task streams against the oracle's on the
     sampled workflows, no overflow at 128/128 and the plain version's
     overflow rows at 4/4), A's wirec reader, B (also with its fit and
     counts epilogues, each held to narrow_ok_plain and stats_plain), C,
     D, and kernel E
     (decode_wirec), which must also give the lanes themselves and,
     replayed by kernel A, the fused reader's state, and kernel F (stats,
     a shard's error and closed counts, for direct callers: the paths take
     them from B's counts epilogue) with torch.count_nonzero as its
     yardstick, kernel G (rehome: a 4,096-row gather, scatter, widen and
     narrow with init rows) with one index_select per state tensor as its
     yardstick, and kernel H (narrow_ok on a widened state, for direct
     callers: the paths take it from B's fit epilogue, held to it there).
     kernel_gen_lanes: kernel I (the device generator's lanes) at 16,384 x
     1,000 (held to its plain version in kernel_launch_shapes, which runs
     first), every history running 1..E from
     Started to Completed, 256 sampled workflows (8 blocks of 32, their lanes
     made by the plain version on the CPU in the generation pool) equal to
     kernel I's and, through kernels A and B, to the oracle's rows.
     kernel_replay_gen: kernel A's generator reader (csrc/replay_gen.cu), its
     state equal to kernel A's on kernel I's lanes (all 66 tensors) and, at
     4,096 x 1,000, to the plain fused loop's; timed at 16,384 and at a
     chunk that fills the card, and at each of its block shapes (1 or 2
     threads a workflow) at both, beside the bound; the registers and
     spills ptxas reports for its instances and for kernel A's.
     kernel_launch_shapes: kernel A's five instances and kernel B at the
     shapes the driven paths launch them with (serving flushes W in {8, 64,
     128} x 16 and 64 x 32 from carried states, held to the plain version;
     the 4,096 x 123 chunk; the 40,960 x 123 bulk; B at 64, 4,096 and
     40,960); kernel G at the resident pool's (a gather of 8, 64 and 128
     rows from a 64-row and a 128-row slab, a 64-row scatter into a slab, a
     64 -> 128 slab growth, a 64-row widen with init rows and its narrow,
     the 4,096-row gather), each equal to rehome_plain, and one rehome()
     call with host row indices behind a queued kernel A (rehome_staging);
     kernel I at the parity leg's 32 x 1,000 and at 16,384 x 1,000, equal
     to generate_lanes_plain; kernel A's generator reader at 16,384 x 1,000
     and at 131,072 x 1,000 (the north star's chunks); each beside its
     bound and the launch floor (a one-element add_ timed the same way), as
     the host launches it and (device_ms) behind a queued spin kernel, the
     card's time alone; kernel J over visibility_path's 2^20-row view
     (its write burst's three Count plans, and bench.py's six queries as
     bitmaps) and kernel L through the view's own feed (the packed block's
     copy and the launch) at its drains' shapes (a 64-row bucket holding
     one changed row x the view's 10 and 11 columns, a 4,096-row backlog
     bucket x 10) and through scan_apply at 512 and 65,536 rows x 24
     columns, each equal byte for byte to its plain version; vis_staging,
     the host's time in a one-row drain (kernel L's feed) and in one Count
     through int(), behind a queued spin kernel, and the view's device
     columns held to its host columns after one-row, backlog and
     new-column drains; with --parent DIR and --variants, other builds on
     the same arguments (the same entry points), held equal and timed in
     the same call. Kernel C at 4,096, 16,384, 40,960 and 131,072 rows of
     kernel B's suites-8k rows tiled to size (equal to its plain version
     and, on 256 sampled rows, zlib.crc32), kernel D at 4,096 and 40,960
     rows with verify_path's rate of altered rows and with none (equal to
     its plain version, beside its yardstick), verify_rows()'s host time
     at 4,096 behind a spin kernel (reduce_shapes), and kernel B with its
     fit epilogue at H_SHAPES and its counts epilogue at F_SHAPES, with the
     parent's B then H or F on the same state as its parent, and B alone
     at B_SHAPES (next_shapes). Kernel E where the paths decode wirec
     bytes (kernel A's wirec reader's launches): a 64 x 16 flush of
     carried suffixes, the feeder's 4,096 x 123 chunk, the 40,960 x 123
     corpus, and the fuzz corpus (28,672 x 117) packed whole and each of
     its seven profiles packed alone and tiled to its rows; each equal to
     its plain version and the lanes, also from a slab at an odd byte
     offset, and kernel A on its output equal to the fused reader
     (decode_shapes; --shapes-only also makes the fuzz corpus for it).
     kernel_replay_traps: kernel A (every reader, with and without tasks)
     and kernel B against their plain versions on gen/lanes.py
     trap_corpus states at x1, x2, x4 and x8 and random lanes at x8, every
     launch of a layout on the route ops/replay.py replay_route gives it.
  3b. north_star, configuration ns-1m (BASELINE.md's north star, bench.py's
     _north_star): 1,000,000 workflows rounded up to whole chunks x 1,000
     events, seed 20260730, through generate_and_replay_sharded_crc over a
     mesh of one card, dispatch depth 2 (a chunk's CRCs are queued to
     page-locked memory behind its launches, the next chunk is launched,
     then the host waits for that copy alone), at chunks of 16,384
     (bench.py's default) and 131,072 (one that fills the card): events/s,
     chunk rates, 0 error workflows, crc_xor; bench.py's parity leg
     (north_star_parity): kernel I makes the 256 sampled workflows' lanes,
     the oracle replays them in a pool of workers, and 0 of their CRCs may
     differ from the first chunk's; the first chunk on a mesh of two slices
     and unsharded equal to the mesh of one; then the host generator
     (host_generator: generate_corpus_native, 4,096 x 1,000, through
     kernels A and B), 0 errors and 64 sampled workflows equal to the
     oracle.
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
  7. verify_path: TPUReplayEngine(stores, chunk_workflows=4096).verify_all()
     over Stores holding the 16,384 overflow histories (their live states
     the MutableStates rebuild_path returned) and 2,048 histories of each
     of the four other suites (their live states the oracle's, built in
     the generation pool), 64 of the live states altered first (32 payload
     fields, 32 current-branch indices). `divergent` must be exactly the
     altered keys, `escalated` exactly the ladder-flagged keys, `fallback`
     exactly the keys with a non-capacity error; then verify_all on a mesh
     of two slices of the card over 4,096 of the keys must equal the mesh
     of 1 on them. Prints the executor's legs, the ladder's rungs, the host
     seconds of the expected rows, the wall time and workflows/s. The
     resident tier is on (its default): the first verify_all also admits
     every clean row to the pool (kernel G), whose entries, counted bytes
     and slab bytes are printed.
  8. resident_path: the same 24,576 histories stored cut after the first
     ceil(2/3) of their batches, a flooded overflow history before its
     flood (live states: the oracle's at the cut),
     through one engine: (a) a cold verify_all admits every clean key;
     (b) the held-back batches land with the final live states, and every
     admitted key must verify as a suffix hit (overflowing suffixes through
     escalate_resident), `divergent` empty, `escalated` and `fallback`
     exactly verify_path's; (c) verify_path's 64 alterations, and
     `divergent` must be exactly them, kernel A launched for the keys that
     are not resident only; (d) snapshot_sweep(force=True) and a fresh
     engine on the same stores, whose verify_all must hydrate exactly the
     keys written and give (c)'s divergent and fallback lists (escalated:
     (c)'s plus the overflowing keys (c) served that the sweep did not
     write: widened entries, altered live states).
  9. serving_path: one ServingScheduler over 4,096 workflows (1,024 each of
     echo_signal, timer_retry, concurrent_child and overflow) stored up to
     their last 8 batches (a flooded overflow history up to the batch
     before its flood);
     eight threads commit each remaining batch as a
     transaction (append to the store, upsert the oracle's state, submit
     with the batch), about 33,000 transactions, a workflow's next one
     once its previous ticket resolved. Parity divergence must be
     0, every ticket resolved, a not-ok ticket only a `device-error:` code,
     and every resident entry's payload and device state the oracle's final
     row. Prints transactions/s, flushes, coalescing, queue-wait and flush
     percentiles and the path counts.
 10. kernel_vis: kernels J (vis_mask: count and bitmap), K (vis_topk) and
     L (vis_apply) on the device visibility table at 16,777,216 rows (7
     builtin and 16 attribute columns, 3.1 GB, bench.py's population shape
     from seed 20260804): bench.py's six selectivity queries, a 12-leaf
     and/or plan and a 40-leaf one (J's table route) through J and through
     K at k = 128 and 4,096; K on
     half_open, the and/or plan and a ties table (half_open over 16 start
     times) at k = 1, 101, 128, 4,096 and 16,384 (above the select route:
     the full sort), timed beside its byte bound, torch.sort and torch.topk
     of its keys; and delta batches of 512 and 65,536 rows (pads, one
     negative index) through L, each equal to its plain version (tolerance
     0) and timed beside its bound.
 11. visibility_path: Stores().visibility with CADENCE_TPU_VISIBILITY=1 on
     the card over bench.py's population at 524,288 records and a `ties`
     domain of 4,096 records on 16 start times: with parity on, the six
     queries as Count and List, a page walk of the ties domain at 100 a
     page (every page escalates) and a string-ordering query that must
     count as fallback-predicate; with parity off, Count and List timed
     beside the host's Count (equal); then 4,096 closes, 1,024 upserts of a
     new attribute (a restage) and 512 deletes, each read back by a Count
     with parity on. Parity divergence must be 0. Prints the shape of
     every J, K and L launch of the run (launch_shapes). With --parent, the
     parent's J (count and bitmap), K (k = 1, 101, 128, 4,096) and L are
     held equal and timed beside this tree's in kernel_vis.
  9b. fuzz_parity: (a) gen/fuzz.parity_run(device="cuda") at its defaults
     (50 seeds x 4 workflows, target_events 100, 2 NDC forks a seed pair):
     dense replay_corpus against the oracle, wirec replay_wirec_to_crc
     against the oracle's CRCs, TPUReplayEngine.verify_all over the
     store-seeded histories and replay_tree_payloads over 50 NDC branch
     trees; ok, 0 of every divergence, and its workflow, event, event-kind,
     fork and decision-coverage counts equal to the run of record
     (FUZZ_RUN, FUZZ_DECISIONS). (b) each of the seven `fuzz:<profile>`
     suites x 4,096 workflows (seed 20260730, target_events 120, made in
     the generation pool) through replay_corpus and, packed as wirec,
     replay_wirec_to_crc: 0 errors, the wirec CRCs equal to the int64
     path's, 256 sampled workflows a profile equal to the oracle; each
     path's events/s.
  9c. migration_path: Stores holding 4,096 workflows of the five suites
     (every 16th whole, so closed; the rest cut after ceil(2/3) of their
     batches); host 1's TPUReplayEngine warmed through verify_all, then
     MigrationManager.migrate_out of 4 of 8 shards (snapshots through the
     shared store, the moved entries evicted); 1-3 batches appended to
     half of the moved open keys; MigrationManager.hydrate_shards on host
     2's engine: every open moved key hydrated (none cold, stale or
     divergent), the closed ones skipped, each hydrated resident row equal
     to the oracle's payload_row byte for byte, only the appended events
     replayed. Prints the hydrate wall and workflows/s.
  9d. replication_apply: an active Stores whose ReplicationPublisher
     publishes every batch of 4,096 open workflows of the five suites
     (target_events 40), and a standby Stores behind a
     ReplicationTaskProcessor with the port's engine (tpu=...): the first
     half of each history drains (every key counted cold on the device),
     verify_all warms the standby's pool, the active's snapshotter ships
     256 keys' records (publish_snapshot), the rest drains: the shipped
     records install and every key finishes on the device as a suffix
     (kernels G, A from the carried state, B), its resident row equal to
     the oracle's; the standby's histories and states equal the active's.
     The same drain over 512 of the workflows with
     CADENCE_TPU_REPL_DEVICE=0 launches no kernel.
Each driven path (main path, wirec_path, feeder_path, north_star's timed
chunk loops, north_star_parity, host_generator, fallback_ladder,
rebuild_path, verify_path, resident_path, serving_path, fuzz_parity's two
legs, migration_path, replication_apply, visibility_path)
runs with every launch count set to 0 just before it and read just after,
and fails if a kernel of that path was never launched, or if it launched
kernel H or F (FOLDED_KERNELS: the paths take their results from kernel
B's epilogues); the shape of every launch of kernels C, D, F and H and of
B with an epilogue is counted by path (launch_shapes_by_path, from
_build.launch_shapes). The last lines are the launch counts, the
card's name and power limit, the per-kernel table, and {"ok": true,
"device": {...}}. Any failed check raises: the script then exits non-zero
and prints no "ok" line. Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import random
import statistics
import subprocess
import sys
import time
import zlib

# H100 SXM published peak HBM bytes/s (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer add, multiply-add, shift and logic instructions a clock on
# one streaming multiprocessor of compute capability 9.0 (the CUDA C++
# Programming Guide's table of arithmetic instruction throughputs). The
# kernels' integer work is bounded by this times the card's SMs times the SM
# clock nvidia-smi reads (clocks.max.sm): int_ops_per_s().
INT_OPS_PER_CLOCK_PER_SM = 64

SEED = 20260730
TARGET_EVENTS = 120
REPS = 5  # timed runs per kernel, after one warm-up; the median is kept
PLAIN_REPS = 3  # timed runs of a plain replay, which takes a second or more
DEVICE = "cuda"
#: the kernels each driven path must launch (ops/_build.launches keys)
#: (payload_fit and payload_counts: kernel B's launches with its fit or
#: counts epilogue, which give the paths kernel H's and kernel F's results)
MAIN_PATH_KERNELS = ("replay", "payload", "payload_counts", "crc32", "verify_rows")
WIREC_PATH_KERNELS = ("replay_wirec", "payload", "payload_counts", "crc32")
LADDER_PATH_KERNELS = ("replay_wirec", "payload", "crc32")
REBUILD_PATH_KERNELS = ("replay_tasks", "payload", "replay")
VERIFY_PATH_KERNELS = ("replay", "payload", "payload_counts", "verify_rows", "rehome")
RESIDENT_PATH_KERNELS = ("replay", "payload", "payload_fit", "payload_counts", "verify_rows",
                         "rehome")
SERVING_PATH_KERNELS = ("replay", "payload", "payload_fit", "rehome")
#: kernels H (narrow_ok) and F (stats), which no driven path may launch: the
#: paths take their results from kernel B's epilogues; kernel_narrow_ok and
#: kernel_stats hold them to their plain versions for their direct callers
FOLDED_KERNELS = ("narrow_ok", "stats")
NORTH_STAR_KERNELS = ("replay_gen", "payload", "crc32")
#: bench.py's parity leg of the north star (the sample's lanes for the
#: oracle), and the host generator's corpus through kernels A and B
NORTH_STAR_PARITY_KERNELS = ("gen_lanes",)
HOST_GENERATOR_KERNELS = ("replay", "payload")
FEEDER_PATH_KERNELS = ("replay", "payload", "crc32", "replay_wirec")
#: the north star (BASELINE.md): 1M distinct histories of 1k events, made and
#: replayed on the card; bench.py's default chunk, and a chunk that fills it
NS_WORKFLOWS = 1_000_000
NS_EVENTS = 1000
NS_CHUNKS = (16384, 131072)
#: the generator kernels' check width (kernel I against its plain version,
#: A-gen against kernel A on kernel I's lanes), and the oracle's sample:
#: NS_BLOCKS blocks of NS_BLOCK contiguous workflows inside it
GEN_CHECK_W = 16384
NS_BLOCK, NS_BLOCKS = 32, 8
#: the host generator's corpus through kernel A, and its oracle sample
NATIVE_GEN_W, NATIVE_GEN_SAMPLE = 4096, 64
#: 32-bit instructions of the generator's 64-bit operations as the built
#: library's SASS (cuobjdump -sass of kernel I) compiles them: a multiply by
#: a constant is IMAD, IMAD.WIDE.U32, IMAD and IMAD.IADD; an add, a shift
#: or an xor two
MUL64, ADD64, SHIFT64, XOR64 = 4, 2, 2, 2
#: one splitmix hash at a step: its salt term added, two xor-shift-multiply
#: rounds, one xor-shift (the workflow's term is made once a workflow, the
#: step's once a step for the four hashes)
MIX_OPS = ADD64 + 2 * (SHIFT64 + XOR64 + MUL64) + SHIFT64 + XOR64
#: die(r, n), jnp.abs(r) % n: the abs, a signed remainder by a constant
#: through a 64-bit multiply-high, and the floor fix, 27 instructions in that
#: SASS; by a power of two (16, 8), 8
DIE_OPS, DIE2_OPS = 27, 8
#: the action's choice: five popcounts, the drain test and the select chains
SELECT_OPS = 40
#: 32-bit integer instructions of every generated event: the four hashes
#: with the step term, the timestamp's die(r3, 5000), die(r0, 16),
#: die(r1, 8) and the choice; gen_ops adds the attribute draws by type
GEN_OPS_PER_EVENT = 4 * MIX_OPS + ADD64 + DIE_OPS + 2 * DIE2_OPS + SELECT_OPS
#: verify_path's suites beside the overflow suite (whose workflows are
#: mostly gen_basic's)
VERIFY_SUITES = ("echo_signal", "timer_retry", "concurrent_child", "ndc")
#: serving_path's suites (the overflow suite's appends overflow inside the
#: scheduler)
SERVING_SUITES = ("echo_signal", "timer_retry", "concurrent_child", "overflow")
#: serving_path's submitter threads
SERVING_THREADS = 8
#: kernel_vis: rows of the columnar table (the view's capacity at 16M
#: records), and visibility_path: its population size (bench.py's 1M cut
#: to half, the first depth the script's time limit gives up when a phase
#: is added) and seed
VIS_ROWS = 1 << 24
VIS_RECORDS = 1 << 19
VIS_SEED = 20260804
#: kernels J, K and L, which visibility_path must launch
VISIBILITY_PATH_KERNELS = ("vis_mask", "vis_topk", "vis_apply")
#: kernel K's k in kernel_vis: one row, a page of 100 plus one, a page of
#: 128, 4,096, and one above the select route's largest (the full sort);
#: the queries timed at each (and the ties table), and K's functions
TOPK_KS = (1, 101, 128, 4096, 16384)
TOPK_TIMED = ("half_open", "and_or_12")
#: kernel K's functions (the plan's two instances: the by-value ones are
#: reported)
TOPK_FUNCTIONS = ("topk_scan_kernel", "topk_hist_kernel", "topk_compact_kernel",
                  "topk_sort_kernel", "vis_keys_kernel", "bitonic_tile_kernel",
                  "bitonic_global_kernel")


#: fuzz_parity (a): parity_run at its defaults (seeds 50, 4 workflows a
#: seed, target_events 100, 2 NDC forks a seed pair) and the figures the
#: grammar gives for it (FUZZ_r01.json, the run of record)
FUZZ_RUN = {"workflows": 200, "events": 17942, "event_kinds": 42, "ndc_forked": 50}
FUZZ_DECISIONS = {
    "ScheduleActivityTask": 877, "RequestCancelActivityTask": 224, "StartTimer": 723,
    "CompleteWorkflowExecution": 47, "FailWorkflowExecution": 19, "CancelTimer": 264,
    "CancelWorkflowExecution": 95, "RequestCancelExternalWorkflowExecution": 226,
    "RecordMarker": 296, "ContinueAsNewWorkflowExecution": 23,
    "StartChildWorkflowExecution": 542, "SignalExternalWorkflowExecution": 287,
    "UpsertWorkflowSearchAttributes": 203}
#: parity_run's kernels: A's int64 reader (dense replay, verify_all, the NDC
#: tree replay) and wirec reader, B (verify_all with its counts), C, D, G
FUZZ_PARITY_KERNELS = ("replay", "replay_wirec", "payload", "payload_counts", "crc32",
                       "verify_rows", "rehome")
#: fuzz_parity (b): each profile (`fuzz:<profile>`) x FUZZ_PER_PROFILE at
#: the main path's seed and target_events, 256 sampled a profile
FUZZ_PER_PROFILE = 4096
FUZZ_SCALE_KERNELS = ("replay", "payload", "crc32", "replay_wirec")
#: migration_path: MIG_WORKFLOWS of the five suites over the reference
#: Onebox's 8 history shards, half of them moved; every 16th workflow is
#: stored closed, the rest cut after ceil(2/3) of their batches
MIG_WORKFLOWS = 4096
MIG_SHARDS = 8
#: the hydration's grouped from-state launches: G's gather, A from the
#: carried states, B
MIGRATION_PATH_KERNELS = ("replay", "payload", "rehome")
#: replication_apply: REPL_WORKFLOWS of the five suites at REPL_EVENTS a
#: history (depth cut from 120: each batch is a replication task the host
#: replicator applies one by one), their last batch held back so they stay
#: open; REPL_SHIPPED of them reach the standby's pool through shipped
#: snapshots; the kill-switch leg drains REPL_KILL_SWITCH of them
REPL_WORKFLOWS = 4096
REPL_EVENTS = 40
REPL_SHIPPED = 256
REPL_KILL_SWITCH = 512
REPLICATION_APPLY_KERNELS = ("replay", "payload", "rehome")


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line for a phase, with the seconds since the script began."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _T0},
                     default=float), flush=True)


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
    task streams) → (histories, {index: (oracle row, branch[, streams])},
    the histories serialized by the wire codec for the feeder)."""
    from cadence_tpu_torch.core.codec import serialize_history
    from cadence_tpu_torch.gen.corpus import generate_history

    suite, start, count, sample, with_tasks = task
    hs = [generate_history(suite, SEED, i, TARGET_EVENTS) for i in range(start, start + count)]
    oracle = {i: _oracle_row(hs[i - start]) + ((_oracle_tasks(hs[i - start]),)
                                               if with_tasks else ())
              for i in sample}
    return hs, oracle, [serialize_history(h) for h in hs]


def _closed_row(lanes):
    """The oracle's witness of one generated history's [E, 18] lanes: its
    payload row with sticky 0, or None when the history does not end
    Completed with nothing pending."""
    from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
    from cadence_tpu_torch.core.enums import WorkflowState
    from cadence_tpu_torch.ops.encode import decode_lanes
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    ms = StateBuilder().replay_history(decode_lanes(lanes))
    if (ms.execution_info.state != WorkflowState.Completed or ms.pending_activity_info_ids
            or ms.pending_timer_info_ids or ms.pending_child_execution_info_ids):
        return None
    row = payload_row(ms)
    row[STICKY_ROW_INDEX] = 0
    return row


def _gen_ns_oracle(task):
    """The north star's oracle: one block of contiguous workflows of the
    device generator, their lanes made by its plain version on the CPU,
    decoded and replayed by the oracle. → (lanes, {index: row or None})."""
    import torch

    from cadence_tpu_torch.ops.genkernel import generate_lanes_plain

    torch.set_num_threads(1)
    start, count, events = task
    lanes = generate_lanes_plain(SEED, start, count, events, "cpu").numpy()
    return lanes, {start + i: _closed_row(lanes[i]) for i in range(count)}


def _closed_rows(lanes):
    """The oracle's witness of each history of a [W, E, 18] block."""
    return [_closed_row(x) for x in lanes]


def _gen_native_oracle(task):
    """The host generator's oracle on sampled workflows: {index: row or
    None}."""
    from cadence_tpu_torch.native.gen_native import generate_corpus_native

    indices, events = task
    return {i: _closed_row(generate_corpus_native(SEED, i, 1, events, num_threads=1)[0][0])
            for i in indices}


def _gen_states(task):
    """verify_path's live states: the oracle's MutableState of each of a
    suite's histories (the main path's histories of the same indices)."""
    from cadence_tpu_torch.gen.corpus import generate_history
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    suite, start, count = task
    return [StateBuilder().replay_history(generate_history(suite, SEED, i, TARGET_EVENTS))
            for i in range(start, start + count)]


def flood_batch(h) -> int:
    """Index of the first batch that schedules more activities than the
    base layout's table holds (the overflow suite's flood, always its
    third batch), or len(h)."""
    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT
    from cadence_tpu_torch.core.enums import EventType

    for i, b in enumerate(h):
        if sum(e.event_type == EventType.ActivityTaskScheduled
               for e in b.events) > DEFAULT_LAYOUT.max_activities:
            return i
    return len(h)


def resident_cut(h) -> int:
    """resident_path's cut: the first ceil(2/3) of a history's batches, or
    the batches before its flood, so the flood arrives as an append that
    overflows the pinned state (escalate_resident: kernel G, B's fit epilogue)."""
    return min(-(-2 * len(h) // 3), flood_batch(h))


def serving_cut(h) -> int:
    """serving_path's cut: all but the last 8 batches (or the first batch),
    or all but the last batch before the flood: that batch's transaction
    pins the state, and the flood then overflows it inside the scheduler."""
    return min(len(h) - 8 if len(h) > 8 else 1, max(1, flood_batch(h) - 1))


def _gen_cut_states(task):
    """resident_path's live states at the cut: the oracle's MutableState of
    each history's first resident_cut batches."""
    from cadence_tpu_torch.gen.corpus import generate_history
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    suite, start, count = task
    out = []
    for i in range(start, start + count):
        h = generate_history(suite, SEED, i, TARGET_EVENTS)
        out.append(StateBuilder().replay_history(h[:resident_cut(h)]))
    return out


def _gen_serving(task):
    """serving_path's workflows: (history, the oracle's MutableState at the
    serving cut, [(expected row, branch) after each later batch, or None
    where the oracle's state does not fit the payload row])."""
    import copy

    from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
    from cadence_tpu_torch.gen.corpus import generate_history
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    suite, start, count = task
    out = []
    for i in range(start, start + count):
        h = generate_history(suite, SEED, i, TARGET_EVENTS)
        cut = serving_cut(h)
        sb = StateBuilder()
        sb.replay_history(h[:cut])
        at_cut = copy.deepcopy(sb.ms)
        expected = []
        for b in h[cut:]:
            sb.apply_batch(b)
            try:
                row = payload_row(sb.ms)
            except OverflowError:  # the state outgrows the payload here
                expected.append(None)
                continue
            row[STICKY_ROW_INDEX] = 0
            expected.append((row, sb.ms.version_histories.current_index))
        out.append((h, at_cut, expected))
    return out


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


def _gen_fuzz(task):
    """fuzz_parity (b)'s corpus: one profile's workflows through
    generate_history("fuzz:<profile>") → (histories, their unpadded lanes
    (encode_batches_resumable), {index: oracle row following the
    continue-as-new chain})."""
    from cadence_tpu_torch.gen.corpus import generate_history
    from cadence_tpu_torch.ops.encode import encode_batches_resumable

    profile, start, count, sample = task
    hs = [generate_history(f"fuzz:{profile}", SEED, i, TARGET_EVENTS)
          for i in range(start, start + count)]
    return (hs, [encode_batches_resumable(h)[0] for h in hs],
            {i: _oracle_row(hs[i - start]) for i in sample})


def _gen_migration(task):
    """migration_path's workflows: (store-shaped history up to its append,
    batches stored before the move, the oracle's MutableState there, its
    MutableState after the appended batches or None). Every 16th workflow
    is stored whole (closed); the others are cut after ceil(2/3) of their
    batches, and 1-3 more batches wait to be appended after the move."""
    import copy

    from cadence_tpu_torch.gen.corpus import SUITES, generate_history
    from cadence_tpu_torch.gen.fuzz import strip_new_run_events
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    start, count = task
    out = []
    for g in range(start, start + count):
        h = strip_new_run_events([generate_history(SUITES[g % len(SUITES)], SEED + 7, g,
                                                   TARGET_EVENTS)])[0]
        if g % 16 == 0:
            cut, k = len(h), 0
        else:
            cut = -(-2 * len(h) // 3)
            k = max(0, min(1 + g % 3, len(h) - 1 - cut))
        sb = StateBuilder()
        sb.replay_history(h[:cut])
        at_cut = copy.deepcopy(sb.ms)
        for b in h[cut:cut + k]:
            sb.apply_batch(b)
        out.append((h[:cut + k], cut, at_cut, sb.ms if k > 0 else None))
    return out


def _gen_replication(task):
    """replication_apply's workflows: (store-shaped history without its
    last batch, so the run stays open; the first half's batch count; the
    oracle's MutableState after the first half and at the end)."""
    import copy

    from cadence_tpu_torch.gen.corpus import SUITES, generate_history
    from cadence_tpu_torch.gen.fuzz import strip_new_run_events
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    start, count = task
    out = []
    for g in range(start, start + count):
        h = strip_new_run_events([generate_history(SUITES[g % len(SUITES)], SEED + 8, g,
                                                   REPL_EVENTS)])[0][:-1]
        half = -(-len(h) // 2)
        sb = StateBuilder()
        sb.replay_history(h[:half])
        at_half = copy.deepcopy(sb.ms)
        for b in h[half:]:
            sb.apply_batch(b)
        out.append((h, half, at_half, sb.ms))
    return out


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
    vtasks = [(suite, s, n) for suite in VERIFY_SUITES
              for s, n in _chunks(args.verify_per_suite, 512)]
    rtasks = ([("overflow", s, n) for s, n in _chunks(args.overflow, 1024)]
              + [(suite, s, n) for suite in VERIFY_SUITES
                 for s, n in _chunks(args.verify_per_suite, 512)])
    stasks = [(suite, s, n) for suite in SERVING_SUITES
              for s, n in _chunks(args.serving_per_suite, 256)]
    from cadence_tpu_torch.gen.fuzz import PROFILES

    ftasks = []
    for profile in PROFILES:
        sample = rng.choice(args.fuzz_per_profile, size=min(256, args.fuzz_per_profile),
                            replace=False)
        for start, n in _chunks(args.fuzz_per_profile, 1024):
            ftasks.append((profile, start, n, sorted(int(i) for i in sample
                                                     if start <= i < start + n)))
    mtasks = _chunks(args.mig_workflows, 512)
    ptasks = _chunks(args.repl_workflows, 512)
    if args.shapes_only:  # the suites alone
        otasks = ctasks = ttasks = vtasks = rtasks = stasks = []
    if args.shapes_only or args.visibility_only:  # the fuzz corpus stays for kernel E's shapes
        mtasks = ptasks = []
    if args.visibility_only:
        ftasks = []
    if args.new_phases_only:
        tasks = otasks = ctasks = ttasks = vtasks = rtasks = stasks = []
    ns_rng = np.random.default_rng(SEED + 6)
    ntasks = [(int(b) * NS_BLOCK, NS_BLOCK, args.ns_events)
              for b in sorted(ns_rng.choice(GEN_CHECK_W // NS_BLOCK, NS_BLOCKS, replace=False))]
    native_sample = sorted(int(i) for i in ns_rng.choice(NATIVE_GEN_W, NATIVE_GEN_SAMPLE,
                                                         replace=False))
    gtasks = [(native_sample[k::8], args.ns_events) for k in range(8)]
    if args.shapes_only or args.new_phases_only:
        ntasks = gtasks = []

    from cadence_tpu_torch.native.build import load_generator

    t0 = time.perf_counter()
    if load_generator() is None:  # built here once, before the workers load it
        fail("generate: no g++ to build the host generator")
    with mp.get_context("spawn").Pool(os.cpu_count()) as pool:
        pending = [pool.map_async(fn, ts, chunksize=1) for fn, ts in (
            (_gen_chunk, tasks), (_gen_chunk, otasks), (_gen_chains, ctasks), (_gen_trees, ttasks),
            (_gen_states, vtasks), (_gen_cut_states, rtasks), (_gen_serving, stasks),
            (_gen_ns_oracle, ntasks), (_gen_native_oracle, gtasks), (_gen_fuzz, ftasks),
            (_gen_migration, mtasks), (_gen_replication, ptasks))]
        (main_parts, over_parts, chain_parts, tree_parts, state_parts, cut_parts,
         serving_parts, ns_parts, native_parts, fuzz_parts, mig_parts,
         repl_parts) = (p.get() for p in pending)
    histories, oracle = _concat(tasks, [(h, o) for h, o, _ in main_parts])
    blobs = [b for _, _, part in main_parts for b in part]
    over_h, over_oracle = _concat(otasks, [(h, o) for h, o, _ in over_parts])
    chain_lanes, chain_oracle = _concat(ctasks, chain_parts)
    fuzz, fuzz_oracle = {}, {}
    for task, (hs, lanes, orc) in zip(ftasks, fuzz_parts):  # a profile's tasks in order
        got = fuzz.setdefault(task[0], ([], []))
        got[0].extend(hs)
        got[1].extend(lanes)
        fuzz_oracle.update({(task[0], i): v for i, v in orc.items()})
    return {
        "histories": histories, "oracle": oracle,
        "overflow": over_h, "overflow_oracle": over_oracle,
        "chains": np.stack(chain_lanes) if chain_lanes else np.zeros((0, 1, 18), np.int64),
        "chain_oracle": chain_oracle,
        "trees": (np.stack([x for part in tree_parts for x in part]) if tree_parts
                  else np.zeros((0, 1, 18), np.int64)),
        "verify_states": [ms for part in state_parts for ms in part],
        "cut_states": [ms for part in cut_parts for ms in part],
        "serving": [w for part in serving_parts for w in part],
        "blobs": blobs,
        "ns_blocks": [(task[0], lanes) for task, (lanes, _) in zip(ntasks, ns_parts)],
        "ns_oracle": {i: row for _, orc in ns_parts for i, row in orc.items()},
        "native_oracle": {i: row for part in native_parts for i, row in part.items()},
        "fuzz": fuzz, "fuzz_oracle": fuzz_oracle,
        "migration": [w for part in mig_parts for w in part],
        "replication": [w for part in repl_parts for w in part],
        "seconds": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
# Device helpers
# ---------------------------------------------------------------------------

#: cycles of the spin kernel cuda_ms(behind=True) queues ahead of its first
#: event (about 0.1 ms), longer than the host takes to enqueue a launch
BEHIND_CYCLES = 200_000


def cuda_ms(fn, reps: int = REPS, setup=None, inner: int = 1, warm: bool = True,
            behind: bool = False):
    """Median milliseconds of `fn` over `reps` timed runs (after one warm-up
    unless `warm` is False), each run `inner` back-to-back calls between two
    CUDA events; `setup()` runs before the first event and its result is
    `fn`'s argument. With `behind`, a spin kernel is queued first, so the
    card is still busy when the host has enqueued the launch: the time is
    the card's alone, without the host's enqueue."""
    import torch

    def once():
        arg = setup() if setup else None
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if behind:
            torch.cuda._sleep(BEHIND_CYCLES)
        a.record()
        for _ in range(inner):
            fn(arg)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / inner

    if warm:
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


def ptxas_usage(build_log: str, kernel, *more) -> dict:
    """Registers, stack frame and spill bytes nvcc reported for the kernel
    whose mangled name contains `kernel` and each of `more`."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and all(k in line for k in (kernel,) + more):
            out = {}
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry function" in nxt:
                    break
                if "registers" in nxt:
                    out["registers"] = int(nxt.split("Used ")[1].split(" registers")[0])
                if "stack frame" in nxt:
                    out["stack_frame_bytes"] = int(nxt.split(" bytes stack frame")[0].split()[-1])
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


#: the kernels whose launches check_launches logs by shape (_build.launch_shapes:
#: C's and D's rows [W, width], F's error [W], H's output [W], B's rows
#: [W, width] where it ran an epilogue)
SHAPE_KERNELS = ("crc32", "verify_rows", "stats", "narrow_ok", "payload_fit", "payload_counts")
#: path -> kernel -> "W x width" -> launches, from each path's check_launches
SHAPES_BY_PATH = {}


def check_launches(launches: dict, path: str, kernels, shapes=None) -> None:
    """Fail unless every kernel of `path` launched in its run and none of
    FOLDED_KERNELS did; log its launches of SHAPE_KERNELS by shape
    (`shapes`, or _build.launch_shapes since the run's reset_launches) in
    SHAPES_BY_PATH."""
    from cadence_tpu_torch.ops import _build

    got = {k: {} for k in SHAPE_KERNELS}
    for (kernel, shape), n in sorted((_build.launch_shapes if shapes is None else shapes).items()):
        if kernel in got:
            got[kernel][" x ".join(map(str, shape))] = n
    SHAPES_BY_PATH[path] = got
    for k in kernels:
        if launches[k] == 0:
            fail(f"{path}: kernel {k} was never launched")
    for k in FOLDED_KERNELS:
        if launches[k]:
            fail(f"{path}: kernel {k} was launched {launches[k]} times; the paths take its "
                 "result from kernel B's epilogue")


_INT_OPS_PER_S = []


def int_ops_per_s() -> float:
    """The card's 32-bit integer instruction rate: INT_OPS_PER_CLOCK_PER_SM x
    its SMs x the SM clock nvidia-smi reads as clocks.max.sm (MHz)."""
    if not _INT_OPS_PER_S:
        import torch

        mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=60).stdout.split()[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _INT_OPS_PER_S.append(INT_OPS_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6)
    return _INT_OPS_PER_S[0]


def bound_ms(nbytes, ops) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the integer instructions over int_ops_per_s()."""
    return max(nbytes / HBM_BYTES_PER_S, ops / int_ops_per_s()) * 1e3


def kernel_record(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops,
                  library_ms=None, **extra):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_ops_per_s() * 1e3
    rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    if "route" in extra:
        raise ValueError("kernel_record: `route` names the kernel's language (cuda or triton)")
    rec.update(extra)
    return rec


def max_abs_err(a, b) -> int:
    import torch

    if a.dtype == torch.bool:
        return int((a != b).sum())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def alter_live_states(stores, keys, rng) -> list:
    """64 live states altered, each replaced by an altered copy: 32 payload
    fields, 32 current-branch indices (a duplicate branch made current:
    the same row, another branch). Returns the altered keys."""
    import copy

    altered = [keys[int(i)] for i in rng.choice(len(keys), 64, replace=False)]
    for n, key in enumerate(altered):
        ms = copy.deepcopy(stores.execution.get_workflow(*key))
        if n < 32:
            ms.execution_info.signal_count += 1
        else:
            vhs = ms.version_histories
            vhs.histories.append(copy.deepcopy(vhs.histories[vhs.current_index]))
            vhs.current_index = len(vhs.histories) - 1
        stores.execution.upsert_workflow(ms)
    return altered


def pool_stats(resident) -> dict:
    """The resident pool's entries, the bytes its budget counts (the JAX
    package's accounting), the bytes its slabs hold on the card, and the
    rows it took in through the host (snapshot hydration only)."""
    return {"entries": len(resident), "counted_bytes": resident.resident_bytes,
            "slab_bytes": resident.slab_bytes,
            "widened_entries": resident.stats()["widened_entries"],
            "host_rows": resident.host_rows}


def verify_path(args, corp, rebuilt, escalated, residual):
    """Phase 7: TPUReplayEngine.verify_all over Stores, as an operator's
    `admin verify` runs it. `escalated` and `residual` are the overflow
    rows fallback_ladder resolved on the card and left for the oracle.
    Returns (the launch counts of the run, what resident_path reuses)."""
    import numpy as np
    import torch

    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.gen.corpus import SUITES
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.parallel.mesh import Mesh
    from cadence_tpu_torch.utils import metrics as M

    per = args.verify_per_suite
    hists = list(corp["overflow"]) + [
        h for suite in VERIFY_SUITES
        for h in corp["histories"][SUITES.index(suite) * args.per_suite:][:per]]
    live = list(rebuilt) + corp["verify_states"]
    t0 = time.perf_counter()
    stores = Stores()
    keys = []
    for h, ms in zip(hists, live):
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(ms)
        keys.append(key)
    if len(keys) != len(live) or stores.execution.list_executions() != keys:
        fail("verify_path: the live states' keys differ from the histories'")
    rng = np.random.default_rng(SEED)
    altered = alter_live_states(stores, keys, rng)
    t_stores = time.perf_counter() - t0

    over_keys = keys[:len(corp["overflow"])]
    want_escalated = sorted(over_keys[int(i)] for i in escalated)
    want_fallback = sorted(over_keys[int(i)] for i in residual)
    M.DEFAULT_REGISTRY.reset()
    engine = TPUReplayEngine(stores, chunk_workflows=4096)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = engine.verify_all()
    t_verify = time.perf_counter() - t0
    launches = dict(_build.launches)
    check_launches(launches, "verify_path", VERIFY_PATH_KERNELS)
    if sorted(res.divergent) != sorted(altered):
        fail(f"verify_path: {len(res.divergent)} divergent keys, not the 64 altered ones")
    if sorted(res.escalated) != want_escalated:
        fail(f"verify_path: {len(res.escalated)} escalated keys, not the {len(want_escalated)} "
             "the ladder resolves")
    if sorted(res.fallback) != want_fallback:
        fail(f"verify_path: {len(res.fallback)} fallback keys, not the {len(want_fallback)} "
             "with a non-capacity error")
    if res.total != len(keys) or res.verified_on_device + len(res.fallback) != len(keys):
        fail(f"verify_path: {res.verified_on_device} verified on the card and "
             f"{len(res.fallback)} by the oracle, of {res.total}")
    legs = {leg: M.DEFAULT_REGISTRY.histogram(M.SCOPE_TPU_REPLAY, leg).total
            for leg in (M.M_PROFILE_PACK, M.M_PROFILE_PACK_WAIT, M.M_PROFILE_H2D,
                        M.M_PROFILE_KERNEL, M.M_PROFILE_READBACK)}

    # the same stores on a mesh of two slices of the card, over 4,096 keys
    sub = [keys[int(i)] for i in sorted(rng.choice(len(keys), min(4096, len(keys)),
                                                   replace=False))]
    engine2 = TPUReplayEngine(stores, chunk_workflows=4096,
                              mesh=Mesh([torch.device(DEVICE)] * 2))
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res2 = engine2.verify_all(sub)
    t_mesh2 = time.perf_counter() - t0
    launches2 = dict(_build.launches)
    check_launches(launches2, "verify_path (mesh of 2)", VERIFY_PATH_KERNELS)
    # rows from the card into slabs on the card go through kernel G alone
    if engine.resident.host_rows or engine2.resident.host_rows:
        fail(f"verify_path: {engine.resident.host_rows} + {engine2.resident.host_rows} rows "
             "admitted through the host")
    in_sub = set(sub)
    for name in ("divergent", "fallback", "escalated", "device_errors"):
        want = sorted(x for x in getattr(res, name)
                      if (x[0] if name == "device_errors" else x) in in_sub)
        if sorted(getattr(res2, name)) != want:
            fail(f"verify_path: the mesh of 2 differs from the mesh of 1 on {name}")
    if res2.total != len(sub) or res2.verified_on_device != len(sub) - len(res2.fallback):
        fail("verify_path: the mesh of 2 verified another count than the mesh of 1")
    pool = pool_stats(engine.resident)
    if pool["entries"] != (res.verified_on_device - len(res.escalated)
                           - len(set(res.divergent) - set(res.escalated))):
        fail(f"verify_path: {pool['entries']} keys admitted, not every verified-clean key")
    emit("verify_path", workflows=len(keys), overflow=len(over_keys), per_suite=per,
         suites=list(VERIFY_SUITES), chunk_workflows=engine.chunk_workflows,
         chunk_shapes=engine.last_run_chunk_shapes, verified_on_device=res.verified_on_device,
         divergent=len(res.divergent), altered=len(altered), escalated=len(res.escalated),
         fallback=len(res.fallback), device_errors=len(res.device_errors),
         stores_s=t_stores, seconds=t_verify, workflows_per_s=len(keys) / t_verify,
         leg_seconds=legs, expected_rows_s=engine.last_run["expected_rows"],
         ladder_s=engine.last_run["ladder"], arbitrate_s=engine.last_run["arbitrate"],
         ladder_rungs=list(engine.ladder.last_run), launches=launches,
         mesh2={"workflows": len(sub), "seconds": t_mesh2, "divergent": len(res2.divergent),
                "escalated": len(res2.escalated), "chunks": len(engine2.last_run_chunk_shapes),
                "equal_to_mesh_of_1": True, "launches": launches2,
                "resident_pool": pool_stats(engine2.resident)}, resident_pool=pool)
    return launches, {"hists": hists, "live": live, "keys": keys,
                      "want_escalated": want_escalated, "want_fallback": want_fallback}


def resident_path(args, corp, ctx):
    """Phase 8: the resident tier through one engine, over verify_path's
    histories stored at resident_cut (their live states the oracle's
    there). Returns the launch counts of the run."""
    import numpy as np
    import torch

    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.utils import metrics as M

    hists, keys = ctx["hists"], ctx["keys"]
    stores = Stores()
    for key, h, ms in zip(keys, hists, corp["cut_states"]):
        for b in h[:resident_cut(h)]:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(ms)
    M.DEFAULT_REGISTRY.reset()
    engine = TPUReplayEngine(stores, chunk_workflows=4096)
    counter = lambda name: M.DEFAULT_REGISTRY.counter(M.SCOPE_TPU_RESIDENT, name)  # noqa: E731
    steps = {}
    torch.cuda.synchronize()
    _build.reset_launches()

    def step(name, fn):
        before = dict(_build.launches)
        ev0 = counter(M.M_RESIDENT_EVENTS_APPENDED)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps[name] = {"seconds": dt, "workflows_per_s": len(keys) / dt,
                       "resident": len(res.resident), "snapshot": len(res.snapshot),
                       "divergent": len(res.divergent), "escalated": len(res.escalated),
                       "fallback": len(res.fallback), "partition_s": engine.last_run["resident"],
                       "events_appended": counter(M.M_RESIDENT_EVENTS_APPENDED) - ev0,
                       "launches": {k: _build.launches[k] - before[k]
                                    for k in ("replay", "rehome", "payload_fit")},
                       "pool": pool_stats(engine.resident)}
        return res

    # (a) every key cold; every verified-clean key admitted
    res_a = step("a_cold", engine.verify_all)
    if not res_a.ok or res_a.resident:
        fail("resident_path (a): a divergent or resident key on a cold pool")
    admitted = set(engine.resident.keys())
    clean = [k for k in keys if k not in set(res_a.escalated) | set(res_a.fallback)]
    if sorted(admitted) != sorted(clean):
        fail(f"resident_path (a): {len(admitted)} keys admitted, not the {len(clean)} clean ones")

    # (b) the held-back batches and the final live states land
    for key, h, ms in zip(keys, hists, ctx["live"]):
        for b in h[resident_cut(h):]:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(ms)
    widened0 = counter(M.M_RESIDENT_WIDENED)
    hits0, suffix0 = counter(M.M_CACHE_HITS), counter(M.M_RESIDENT_SUFFIX_HITS)
    res_b = step("b_suffix", engine.verify_all)
    if res_b.divergent:
        fail(f"resident_path (b): {len(res_b.divergent)} divergent keys")
    if sorted(res_b.escalated) != ctx["want_escalated"] or \
            sorted(res_b.fallback) != ctx["want_fallback"]:
        fail(f"resident_path (b): escalated {len(res_b.escalated)} / fallback "
             f"{len(res_b.fallback)}, not verify_path's {len(ctx['want_escalated'])} / "
             f"{len(ctx['want_fallback'])}")
    grew = {k for k, h in zip(keys, hists) if resident_cut(h) < len(h)}
    suffix_hits = counter(M.M_RESIDENT_SUFFIX_HITS) - suffix0
    exact_hits = counter(M.M_CACHE_HITS) - hits0
    if (suffix_hits, exact_hits) != (len(admitted & grew), len(admitted - grew)) or \
            not admitted <= set(res_b.resident) | set(res_b.fallback):
        fail(f"resident_path (b): {suffix_hits} suffix and {exact_hits} exact hits, not the "
             f"{len(admitted & grew)} and {len(admitted - grew)} the admitted keys make")
    steps["b_suffix"].update(suffix_hits=suffix_hits, exact_hits=exact_hits)
    steps["b_suffix"]["widened_rows"] = counter(M.M_RESIDENT_WIDENED) - widened0
    steps["b_suffix"]["renarrowed_rows"] = counter(M.M_RESIDENT_NARROWED)

    # (c) verify_path's 64 alterations
    rng = np.random.default_rng(SEED)
    altered = alter_live_states(stores, keys, rng)
    engine.last_run_chunk_shapes = []
    res_c = step("c_altered", engine.verify_all)
    if sorted(res_c.divergent) != sorted(altered):
        fail(f"resident_path (c): {len(res_c.divergent)} divergent keys, not the 64 altered")
    cold = len(keys) - len(res_c.resident)
    shapes = engine.last_run_chunk_shapes
    want_rows = (-(-cold // 4096)) * min(4096, cold) if cold else 0
    a_launches = steps["c_altered"]["launches"]["replay"]
    if sum(w for w, _ in shapes) != want_rows or (
            cold <= 4096 and a_launches != len(shapes) + len(engine.ladder.last_run if cold else [])):
        fail("resident_path (c): kernel A ran for keys that are resident")
    steps["c_altered"]["cold_keys"] = cold
    if engine.resident.host_rows:
        fail(f"resident_path (a)-(c): {engine.resident.host_rows} rows admitted through the host")

    # (d) sweep, then a fresh engine on the same stores
    t0 = time.perf_counter()
    report = engine.snapshot_sweep(force=True)
    t_sweep = time.perf_counter() - t0
    fresh = TPUReplayEngine(stores, chunk_workflows=4096)
    engine = fresh
    res_d = step("d_hydrated", fresh.verify_all)
    if sorted(res_d.snapshot) != sorted(report.keys_written):
        fail(f"resident_path (d): {len(res_d.snapshot)} keys hydrated, not the "
             f"{report.written} written")
    # a key (c) served from the pool that the sweep did not write (a widened
    # entry, or an altered live state the checksum gate refused) is cold
    # here, and escalates again when its history overflows the base layout
    unswept = (set(res_c.resident) - set(report.keys_written)) & set(ctx["want_escalated"])
    if sorted(res_d.divergent) != sorted(res_c.divergent) or \
            sorted(res_d.fallback) != sorted(res_c.fallback) or \
            sorted(res_d.escalated) != sorted(set(res_c.escalated) | unswept):
        fail(f"resident_path (d): the lists differ from (c)'s: divergent "
             f"{len(res_d.divergent)}/{len(res_c.divergent)}, fallback {len(res_d.fallback)}/"
             f"{len(res_c.fallback)}, escalated {len(res_d.escalated)}/{len(res_c.escalated)} "
             f"+ {len(unswept)} resident in (c) and not swept")
    steps["d_hydrated"].update(sweep_s=t_sweep, written=report.written, unswept_escalated=len(unswept),
                               skipped_checksum=report.skipped_checksum,
                               hydrate_s=fresh.last_run["resident"])
    launches = dict(_build.launches)
    check_launches(launches, "resident_path", RESIDENT_PATH_KERNELS)
    emit("resident_path", workflows=len(keys), steps=steps, launches=launches)
    return launches


def serving_path(args, corp):
    """Phase 9: one ServingScheduler, eight submitter threads committing the
    serving corpus's held-back batches as transactions. Returns the launch
    counts of the run."""
    import threading

    import numpy as np
    import torch

    from cadence_tpu_torch.engine.cache import batch_crc
    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.ops.payload import payload_rows_narrow
    from cadence_tpu_torch.oracle.state_builder import StateBuilder
    from cadence_tpu_torch.utils import metrics as M

    work = corp["serving"]
    stores = Stores()
    keys, builders = [], []
    for h, at_cut, _ in work:
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h[:serving_cut(h)]:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(at_cut)
        keys.append(key)
        builders.append(StateBuilder(at_cut))
    M.DEFAULT_REGISTRY.reset()
    engine = TPUReplayEngine(stores)
    sched = engine.serving_scheduler()
    flushes = []
    flush = sched._flush

    def timed_flush(batch):
        t0 = time.perf_counter()
        flush(batch)
        flushes.append((time.perf_counter() - t0, sum(1 + i.coalesced for i in batch)))

    sched._flush = timed_flush
    # the shapes kernels A and B are launched with: each suffix flush's
    # append groups (W, E) and each cold admit's padded corpus (Wp, E)
    append_shapes, cold_shapes = collections.Counter(), collections.Counter()
    append_report, cold_launch = engine.resident.replay_append_report, sched._cold_launch

    def counted_append(*a, **k):
        results, report = append_report(*a, **k)
        append_shapes.update(report.chunk_shapes)
        return results, report

    def counted_cold(corpus, device):
        cold_shapes[tuple(corpus.shape[:2])] += 1
        return cold_launch(corpus, device)

    engine.resident.replay_append_report = counted_append
    sched._cold_launch = counted_cold
    tickets = [[] for _ in keys]
    #: the expected row and branch of each workflow's last submitted
    #: transaction
    last = [None] * len(keys)
    torch.cuda.synchronize()
    _build.reset_launches()

    errors = []

    def submitter(t):
        # a workflow's transactions are sequential: round r+1 of a workflow
        # commits once its round-r ticket resolved (the device maintenance
        # itself is asynchronous); the thread's workflows interleave
        owned = range(t, len(keys), SERVING_THREADS)
        rounds = max(len(work[i][2]) for i in owned)
        try:
            for r in range(rounds):
                for i in owned:
                    h, _, expected = work[i]
                    if r >= len(expected):
                        continue
                    if tickets[i]:
                        tickets[i][-1].result(timeout=600)
                    batch = h[serving_cut(h) + r]
                    builders[i].apply_batch(batch)
                    stores.execution.upsert_workflow(builders[i].ms)
                    stores.history.append_batch(*keys[i], list(batch.events))
                    if expected[r] is None:
                        continue  # no payload row to hand over: the next one reads the store
                    chained = r == 0 or expected[r - 1] is not None
                    row, branch = expected[r]
                    tickets[i].append(sched.submit(keys[i], row, branch, batch_crc(batch),
                                                   batch=batch if chained else None))
                    last[i] = expected[r]
        except Exception as exc:  # reported after the join
            errors.append(f"thread {t}: {type(exc).__name__}: {exc}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(SERVING_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        fail(f"serving_path: submitter failed: {errors[:3]}")
    if not sched.drain(timeout=600):
        fail("serving_path: the queue did not drain")
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = dict(_build.launches)
    sched.stop()
    n_txns = sum(len(per) for per in tickets)
    results = [tk.result(timeout=0) for per in tickets for tk in per if tk.done()]
    if len(results) != n_txns:
        fail(f"serving_path: {n_txns - len(results)} tickets never resolved")
    bad = [r.error for r in results if not r.ok and not r.error.startswith("device-error:")]
    if bad:
        fail(f"serving_path: {len(bad)} tickets failed other than by a device error: {bad[:3]}")
    stats = sched.stats()
    if stats["parity_divergence"]:
        fail(f"serving_path: {stats['parity_divergence']} parity divergences")
    # every key still resident holds the oracle's final row, on the host and
    # on the card (its gathered state projected again by kernel B)
    resident = [(i, engine.resident.entry_for(k)) for i, k in enumerate(keys)]
    resident = [(i, e) for i, e in resident if e is not None]
    wrong = [i for i, e in resident
             if not np.array_equal(e.payload, last[i][0]) or e.branch != last[i][1]]
    by_slab = {}
    for i, e in resident:
        by_slab.setdefault(id(e.slot.slab), []).append((i, e))
    for group in by_slab.values():
        rows, _ = payload_rows_narrow(engine.resident.gather([e for _, e in group]),
                                      engine.layout)
        rows = rows.cpu().numpy()
        wrong += [i for j, (i, _) in enumerate(group) if not np.array_equal(rows[j], last[i][0])]
    if wrong:
        fail(f"serving_path: {len(wrong)} resident entries differ from the oracle's final row")
    check_launches(launches, "serving_path", SERVING_PATH_KERNELS)
    waits = sorted(r.queue_wait_s for r in results)
    fl = sorted(d for d, _ in flushes)
    pct = lambda xs, q: xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0  # noqa: E731
    emit("serving_path", workflows=len(keys), threads=SERVING_THREADS, transactions=n_txns,
         unsubmitted=sum(len(w[2]) for w in work) - n_txns,
         seconds=t_serve, transactions_per_s=n_txns / t_serve, flushes=len(flushes),
         mean_flush_transactions=(sum(n for _, n in flushes) / len(flushes)) if flushes else 0,
         coalescing_factor=stats["coalescing_factor"],
         coalesced_appends=stats["coalesced_appends"],
         queue_wait_ms={"p50": pct(waits, 0.5) * 1e3, "p99": pct(waits, 0.99) * 1e3},
         flush_ms={"p50": pct(fl, 0.5) * 1e3, "p99": pct(fl, 0.99) * 1e3},
         batched_launches=stats["batched_launches"], cold_admits=stats["cold_admits"],
         suffix_appends=stats["suffix_appends"], exact_serves=stats["exact_serves"],
         requeued=stats["requeued"], bypassed=stats["bypassed"],
         escalations=sum(r.escalated for r in results),
         not_ok=sum(not r.ok for r in results), parity_divergence=stats["parity_divergence"],
         resident_checked=len(resident), resident_pool=pool_stats(engine.resident),
         launches=launches,
         append_shapes={f"{w}x{e}": n for (w, e), n in sorted(append_shapes.items())},
         cold_shapes={f"{w}x{e}": n for (w, e), n in sorted(cold_shapes.items())})
    return launches


# ---------------------------------------------------------------------------
# Device visibility: kernels J, K and L at the table's full width, then the
# view behind Stores.visibility
# ---------------------------------------------------------------------------

#: the view's column names for the query fields (engine/visibility_device.py)
_VIS_FIELDS = {"__domain__": "domain", "workflowtype": "workflow_type",
               "closestatus": "close_status", "starttime": "start_time",
               "closetime": "close_time"}


class VisBinder:
    """compile_plan's binder over kernel_vis's synthetic columns: a field to
    its column, a string to its interned id, an int64 comparison through
    plan_leaf_int, as the view's own binder does."""

    def __init__(self, kinds, intern):
        self.kinds, self.intern = kinds, intern

    def leaf(self, field, op, value):
        from cadence_tpu_torch.ops import scan as S

        name = _VIS_FIELDS.get(field.lower(), field)
        kind = self.kinds[name]
        if kind == S.COL_I64:
            code, p = S.plan_leaf_int(op, value)
            return kind, code, name, p, 0.0
        if kind == S.COL_ID:
            return kind, S.OP_EQ if op == "=" else S.OP_NE, name, self.intern.get(value, -2), 0.0
        code = {"=": S.OP_EQ, "!=": S.OP_NE, "<": S.OP_LT, "<=": S.OP_LE, ">": S.OP_GT,
                ">=": S.OP_GE}[op]
        return kind, code, name, 0, float(value)


def vis_table(n: int, seed: int):
    """({column: numpy array}, {column: kind}, intern table, valid): the
    view's 7 builtin columns and its default budget of 16 attribute columns
    (bench.py's Priority f64 and Tag id, F0-F6 f64, S0-S6 id) over n rows of
    bench.py's population shape, 1% of the rows deleted."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    base = 1_700_000_000_000_000_000
    closed = rng.random(n) < 0.5
    r = rng.random(n)
    intern = {"bench": 0}
    intern.update({f"wt-{k}": 1 + k for k in range(8)})
    intern.update({f"tag-{k}": 9 + k for k in range(4)})
    intern.update({f"s{k}": 20 + k for k in range(100)})
    cols = {"domain": np.zeros(n, np.int64), "workflow_id": 200 + 2 * i,
            "run_id": 201 + 2 * i, "workflow_type": 1 + i % 8,
            "close_status": np.where(closed, rng.integers(0, 3, n), -1),
            "start_time": base + i * 1000, "close_time": np.where(closed, base + i * 1000 + 7, 0),
            "Priority": np.where(r < 0.5, rng.integers(0, 10, n).astype(np.float64), np.nan),
            "Tag": np.where((r >= 0.5) & (r < 0.8), 9 + rng.integers(0, 4, n), -1)}
    for k in range(7):
        f = rng.normal(size=n)
        f[rng.random(n) < 0.2] = np.nan
        cols[f"F{k}"] = f
        cols[f"S{k}"] = np.where(rng.random(n) < 0.2, -1, 20 + rng.integers(0, 100, n))
    kinds = {name: ("f64" if a.dtype == np.float64 else "id") for name, a in cols.items()}
    kinds.update(close_status="i64", start_time="i64", close_time="i64")
    return cols, kinds, intern, rng.random(n) >= 0.01


def vis_queries(n: int):
    """bench.py's six selectivity queries (bench.py:757-765) at n rows, one
    and/or plan of 12 leaves over 12 columns, and one of 40 leaves (past
    kernel J's by-value plan: its table route)."""
    cut99 = 1_700_000_000_000_000_000 + int(n * 0.999) * 1000
    wide = " OR ".join(f"(F{k % 7} > {0.05 * k:.2f} AND S{k % 7} != 's{k}')" for k in range(20))
    return [("all", ""), ("half_open", "CloseStatus = -1"),
            ("type_eighth", "WorkflowType = 'wt-3'"), ("attr_tenth", "Priority >= 9"),
            ("narrow_and", "WorkflowType = 'wt-1' AND CloseStatus = 0 AND Priority < 2"),
            ("time_tail", f"StartTime > {cut99}"),
            ("and_or_12", "(F0 > 0.5 AND S0 = 's3') OR (F1 < -1 AND S1 != 's7') OR "
                          "(F2 >= 0 AND S2 = 's1' AND F3 <= 1) OR (S3 = 's9' AND F4 != 0.25) "
                          "OR (F5 > 2 AND CloseTime > 0) OR S4 = 's2'"),
            ("wide_40", wide)]


def mask_bytes(plan, valid) -> int:
    """Kernel J's bytes on this data: every valid byte, and each plan
    column at the valid rows (a row that is not valid reads no column)."""
    return valid.shape[0] + int(valid.sum()) * 8 * len(plan.slots)


def check_topk(plan, k, cols, valid, start, order, count: int, name: str) -> int:
    """Kernel K at k against the plain order (ids and count exactly); the
    number of ids that differ (0, or the phase fails)."""
    import torch

    from cadence_tpu_torch.ops import scan as S

    ids, c_k = S.scan_topk(plan, k, cols, valid, start)
    bad = int((ids != order[:k]).sum())
    if bad or int(c_k) != count:
        fail(f"kernel_vis {name}: kernel K at k={k} differs from its plain version "
             f"({bad} ids, count {int(c_k)} against {count})")
    return bad


def time_topk(plan, k, cols, valid, start, mask) -> dict:
    """Kernel K's launch at k timed between CUDA events, beside its byte
    bound and the yardsticks on the same keys: torch.sort of the -start
    keys (the full sort), and torch.topk of them with non-matching rows
    keyed to INT64_MAX (one library call for the same selection)."""
    import torch

    from cadence_tpu_torch.ops import scan as S

    n = start.shape[0]
    neg = torch.where(start == -(1 << 63), start, -start.clamp(min=-(1 << 63) + 1))
    keys = torch.where(mask, neg, torch.full_like(neg, (1 << 63) - 1))
    k_cols = len(set(plan.slots) | {"start_time"})
    rec = {"route": S.topk_route(n, k),
           "ms": cuda_ms(lambda run: run(), setup=lambda: S.scan_topk_launch(
               plan, k, cols, valid, start)[0]),
           "bound_ms": (n * (8 * k_cols + 1) + 8 * k) / HBM_BYTES_PER_S * 1e3,
           "sort_ms": cuda_ms(lambda _: torch.sort(neg, stable=True)),
           "topk_ms": cuda_ms(lambda _: torch.topk(keys, k, largest=False))}
    del neg, keys
    return rec


#: the k at which kernel_vis times the parent's kernel K beside this tree's
PARENT_KS = (1, 101, 128, 4096)
#: the parent's kernel libraries built in this run, by their sources
_PARENT_LIBS = {}


def parent_scan_lib(args):
    """The --parent checkout's scan.cu built with nvcc (once a run), or
    None without --parent."""
    if not args.parent:
        return None
    if "scan" not in _PARENT_LIBS:
        csrc = os.path.join(args.parent, "cadence_tpu_torch", "csrc")
        _PARENT_LIBS["scan"] = build_entries(csrc, ["scan.cu"])[0]
    return _PARENT_LIBS["scan"]


def parent_ms(lib, make, check, what: str, inner: int = 1):
    """The parent's kernel on the port's launch arguments (its entry point,
    the same signature): make() gives (the port's launch, its outputs), which
    check(outputs) holds to the plain version before the parent's launch is
    timed. None where the parent's entry point has another signature."""
    def made():
        run, out = make()
        go = rebind(run, lib, run.name)
        go.out = out
        return go

    go = made()
    if ENTRY[go.launch.name] not in lib.entries:
        return None  # the parent's entry point has another signature
    go()
    if not check(go.out):
        fail(f"kernel_vis {what}: the parent's kernel differs from the plain version")
    return cuda_ms(lambda go: go(), setup=made, inner=inner)


def kernel_vis(args, dev, records):
    """Kernels J, K and L against their plain versions (exactly) on the
    columnar table at args.vis_rows rows, each launch timed between CUDA
    events beside its bound."""
    import numpy as np
    import torch

    from cadence_tpu_torch.engine.visibility_query import And, Cmp, parse_query
    from cadence_tpu_torch.ops import _build, scan as S

    launch = lambda run: run()  # noqa: E731
    n = args.vis_rows
    t0 = time.perf_counter()
    host, kinds, intern, valid_np = vis_table(n, VIS_SEED)
    cols = {name: torch.from_numpy(a).to(dev) for name, a in host.items()}
    valid = torch.from_numpy(valid_np).to(dev)
    del host
    table_bytes = sum(c.numel() * c.element_size() for c in cols.values()) + n
    t_table = time.perf_counter() - t0
    binder = VisBinder(kinds, intern)
    plans = {}
    for name, q in vis_queries(n):
        node, _ = parse_query(q)
        scoped = Cmp("__domain__", "=", "bench")
        plans[name] = S.compile_plan(And(scoped, node) if node is not None else scoped, binder)
    start = cols["start_time"]
    parent = parent_scan_lib(args)
    out = {}
    err = {"J": 0, "K": 0, "L": 0}  # values that differ from the plain version
    for name, plan in plans.items():
        pc = [cols[s] for s in plan.slots]
        want = S.scan_count_plain(plan, pc, valid)
        route = S.plan_route(*S.decode_plan(plan, pc))
        table_launches = _build.launches["vis_mask_table"]
        got = S.scan_count(plan, pc, valid)
        on_table = _build.launches["vis_mask_table"] == table_launches + 1
        if name == "wide_40" and (route != "table" or (dev.type == "cuda" and not on_table)):
            fail("kernel_vis wide_40: kernel J did not take its table route")
        bits, c_b = S.scan_bitmap(plan, pc, valid)
        want_bits, _ = S.scan_bitmap_plain(plan, pc, valid)
        err["J"] = max(err["J"], abs(int(got) - int(want)), max_abs_err(bits, want_bits))
        if int(got) != int(want) or int(c_b) != int(want) or not torch.equal(bits, want_bits):
            fail(f"kernel_vis {name}: kernel J differs from its plain version "
                 f"({int(got)}, {int(c_b)} against {int(want)})")
        rec = {"leaves": len(plan.leaves), "columns": len(plan.slots), "count": int(want),
               "j_route": route,
               "j_count_ms": cuda_ms(launch, setup=lambda: S.scan_count_launch(plan, pc, valid)[0],
                                     inner=5),
               "j_bitmap_ms": cuda_ms(launch, setup=lambda: S.scan_bitmap_launch(plan, pc,
                                                                                 valid)[0],
                                      inner=5)}
        if parent is not None:  # the parent's J on the same arguments, held equal first
            rec["parent_j_count_ms"] = parent_ms(
                parent, lambda: S.scan_count_launch(plan, pc, valid),
                lambda c: int(c) == int(want), f"{name} J", inner=5)
            rec["parent_j_bitmap_ms"] = parent_ms(
                parent, lambda: S.scan_bitmap_launch(plan, pc, valid),
                lambda out: torch.equal(out[0], want_bits) and int(out[1]) == int(want),
                f"{name} J", inner=5)
        col_bytes = mask_bytes(plan, valid)
        rec["j_count_bound_ms"] = col_bytes / HBM_BYTES_PER_S * 1e3
        rec["j_bitmap_bound_ms"] = (col_bytes + n // 8) / HBM_BYTES_PER_S * 1e3
        mask = S.mask_plain(plan, pc, valid)
        order = S.topk_order_plain(mask, start)
        ks = TOPK_KS if name in TOPK_TIMED else (128, 4096)
        table_launches = _build.launches["vis_topk_table"]
        for k in ks:
            err["K"] = max(err["K"], check_topk(plan, k, pc, valid, start, order, int(want),
                                                name))
            if name in TOPK_TIMED:
                rec[f"k{k}"] = time_topk(plan, k, pc, valid, start, mask)
                if parent is not None and k in PARENT_KS:
                    rec[f"k{k}"]["parent_ms"] = parent_ms(
                        parent, lambda: S.scan_topk_launch(plan, k, pc, valid, start),
                        lambda out: torch.equal(out[0], order[:k]) and int(out[1]) == int(want),
                        f"{name} K at k={k}")
        if name == "wide_40" and dev.type == "cuda" and (
                _build.launches["vis_topk_table"] != table_launches + len(ks)):
            fail("kernel_vis wide_40: kernel K did not take its table route")
        out[name] = rec
        del mask, order
    # K on the ties table: half_open over a start column of 16 values
    # (visibility_path's ties domain at the table's size)
    tp = plans["half_open"]
    tc = [cols[s] for s in tp.slots]
    ties = torch.from_numpy(1_700_000_000_000_000_000 + (np.arange(n, dtype=np.int64) % 16)
                            * 1000).to(dev)
    t_mask = S.mask_plain(tp, tc, valid)
    t_order = S.topk_order_plain(t_mask, ties)
    t_count = int(t_mask.sum())
    out["ties"] = {"count": t_count, "start_values": 16}
    for k in TOPK_KS:
        err["K"] = max(err["K"], check_topk(tp, k, tc, valid, ties, t_order, t_count, "ties"))
        out["ties"][f"k{k}"] = time_topk(tp, k, tc, valid, ties, t_mask)
    del ties, t_mask, t_order
    # K's traps at the table's size, each at k = 1, 101, 128 and 4,096 (the
    # select route): a plan that matches no row (count 0), one that matches
    # at most the last 7 rows (count < k: the tail is non-matching rows in
    # (-start, row) order), and half_open over a start column of INT64_MIN,
    # INT64_MAX, -1 and 0 (the key of INT64_MIN wraps, and four values tie)
    traps = {}
    for name, q in (("no_match", "WorkflowType = 'wt-none'"),
                    ("last_7", f"StartTime > {1_700_000_000_000_000_000 + (n - 8) * 1000}")):
        node, _ = parse_query(q)
        traps[name] = (S.compile_plan(And(Cmp("__domain__", "=", "bench"), node), binder), start)
    edges = torch.tensor([-(1 << 63), (1 << 63) - 1, -1, 0], dtype=torch.int64, device=dev)
    pick = np.random.default_rng(VIS_SEED + 2).integers(0, 4, n)
    traps["int64_edges"] = (tp, edges[torch.from_numpy(pick).to(dev)])
    out["traps"] = {}
    for name, (plan, st) in traps.items():
        pc = [cols[s] for s in plan.slots]
        m = S.mask_plain(plan, pc, valid)
        order = S.topk_order_plain(m, st)
        count = int(m.sum())
        first = int(st[order[0]])
        out["traps"][name] = {"count": count, "first_start": first}
        if (name == "no_match" and count != 0) or (name == "last_7" and not 0 < count < 101) \
                or (name == "int64_edges" and first != -(1 << 63)):
            fail(f"kernel_vis {name}: the trap is not what it should pin (count {count}, "
                 f"first start {first})")
        for k in (1, 101, 128, 4096):
            err["K"] = max(err["K"], check_topk(plan, k, pc, valid, st, order, count, name))
        del m, order, st
    del traps, edges
    # the records: J's count and K's k = 128 on narrow_and and half_open
    # (bench.py's selective Count and the page walk's shape), each with its
    # plain version's time and, for K, the yardsticks torch.sort and
    # torch.topk of its keys
    jp = plans["narrow_and"]
    jc = [cols[s] for s in jp.slots]
    ms_jp = cuda_ms(lambda _: S.scan_count_plain(jp, jc, valid), PLAIN_REPS)
    kp = plans["half_open"]
    kc = [cols[s] for s in kp.slots]
    ms_kp = cuda_ms(lambda _: S.scan_topk_plain(kp, 128, kc, valid, start), PLAIN_REPS)
    k128 = out["half_open"]["k128"]
    records.append(kernel_record(
        "vis_mask", "cadence_tpu_torch/csrc/scan.cu", "cadence_tpu/ops/scan.py:260", None, err["J"],
        out["narrow_and"]["j_count_ms"], ms_jp, mask_bytes(jp, valid),
        n * 12 * len(jp.leaves), also_replaces=["cadence_tpu/ops/scan.py:273"], rows=n,
        query="narrow_and", plan_route=S.plan_route(*S.decode_plan(jp, jc)),
        rows_per_lane=S.MASK_ROWS,
        ptxas=jl_ptxas(_build.build_log)["vis_mask"]))
    k_cols = len(set(kp.slots) | {"start_time"})
    records.append(kernel_record(
        "vis_topk", "cadence_tpu_torch/csrc/scan.cu", "cadence_tpu/ops/scan.py:288", None, err["K"],
        k128["ms"], ms_kp, n * (8 * k_cols + 1) + 8 * 128, 0, k128["topk_ms"], rows=n, k=128,
        query="half_open", topk_route=k128["route"],
        library="torch.topk(keys, k, largest=False), non-matching rows keyed to INT64_MAX",
        yardstick="torch.sort(stable) of the int64 -start keys", yardstick_ms=k128["sort_ms"],
        by_k={k: out["half_open"][f"k{k}"] for k in TOPK_KS},
        ptxas={f: ptxas_usage(_build.build_log, f, "ValuePlan") or ptxas_usage(_build.build_log, f)
               for f in TOPK_FUNCTIONS}))
    # L: delta batches of 512 and 65,536 rows, with pads (index N) and one
    # negative index, into all 23 columns and valid, against the plain
    # version on a copy of the table
    g = np.random.default_rng(VIS_SEED + 1)
    names = list(cols)
    targets = [cols[nm] for nm in names] + [valid]
    copies = [t.clone() for t in targets]
    apply = {}
    for b in (512, 65536):
        kept = b - b // 16
        rows = g.choice(n, kept, replace=False).astype(np.int64)
        rows[0] -= n  # the same row, written as a negative index
        idx_np = np.full(b, n, np.int64)
        idx_np[:kept] = rows
        idx = torch.from_numpy(idx_np).to(dev)
        vals = [torch.from_numpy(g.random(b) if t.dtype == torch.float64
                                 else g.random(b) < 0.5 if t.dtype == torch.bool
                                 else g.integers(-5, 100, b)).to(dev, t.dtype)
                for t in targets]
        S.scan_apply(targets, idx, vals)
        S.scan_apply_plain(copies, idx, vals)
        bad = sum(int((t.view(torch.uint8) != c.view(torch.uint8)).sum())
                  for t, c in zip(targets, copies))
        err["L"] = max(err["L"], bad)
        if bad:
            fail(f"kernel_vis: kernel L at B={b} differs from its plain version in {bad} bytes")
        wrapped = torch.where(idx < 0, idx + n, idx)
        keep = wrapped < n
        rows_t, vals_t = wrapped[keep], [v[keep] for v in vals]
        elem = sum(t.element_size() for t in targets)
        apply[b] = {"ms": cuda_ms(launch, setup=lambda: S.scan_apply_launch(targets, idx,
                                                                            vals)[0], inner=20),
                    "parent_ms": None if parent is None else parent_ms(
                        parent, lambda: S.scan_apply_launch([t.clone() for t in copies], idx,
                                                            vals),
                        lambda out: all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                                        for x, y in zip(out, copies)), f"L at B={b}", inner=20),
                    "plain_ms": cuda_ms(lambda _: S.scan_apply_plain(copies, idx, vals)),
                    "index_copy_ms": cuda_ms(lambda _: [c.index_copy_(0, rows_t, v) for c, v in
                                                         zip(copies, vals_t)], inner=5),
                    "bound_ms": (b * 8 + 2 * kept * elem) / HBM_BYTES_PER_S * 1e3}
    a = apply[65536]
    records.append(kernel_record(
        "vis_apply", "cadence_tpu_torch/csrc/scan.cu", "cadence_tpu/ops/scan.py:310", None, err["L"],
        a["ms"], a["plain_ms"], 65536 * 8 + 2 * (65536 - 4096) * sum(
            t.element_size() for t in targets), 0, rows=65536, columns=len(targets),
        yardstick="index_copy_ of each column", yardstick_ms=a["index_copy_ms"],
        ptxas=jl_ptxas(_build.build_log)["vis_apply"]))
    emit("kernel_vis", rows=n, columns=len(targets), table_bytes=table_bytes,
         table_seconds=t_table, queries=out, apply=apply, max_abs_err=err)
    del cols, valid, targets, copies, start
    torch.cuda.empty_cache()


class VisShapeLog:
    """While entered, counts the shape of every launch of kernels J, K and
    L that ops/scan.py makes: J's (N, plan columns, count or bitmap), K's
    (N, k) and L's (B, C), by wrapping the functions that build those
    launches (L's: the view's feed, apply_packed_launch)."""

    WRAPPED = ("_mask_launch", "scan_topk_launch", "apply_packed_launch")

    def __enter__(self):
        from cadence_tpu_torch.ops import scan as S

        self.mask, self.topk, self.apply = (collections.Counter() for _ in range(3))
        self.saved = {n: getattr(S, n) for n in self.WRAPPED}
        log = self

        def mask(plan, cols, valid, bitmap):
            log.mask[(valid.shape[0], len(cols), "bitmap" if bitmap else "count")] += 1
            return log.saved["_mask_launch"](plan, cols, valid, bitmap)

        def topk(plan, k, cols, valid, start):
            log.topk[(valid.shape[0], k)] += 1
            return log.saved["scan_topk_launch"](plan, k, cols, valid, start)

        def packed(cols, table, block, dev_block, b):
            log.apply[(b, len(cols))] += 1
            return log.saved["apply_packed_launch"](cols, table, block, dev_block, b)

        for name, fn in zip(self.WRAPPED, (mask, topk, packed)):
            setattr(S, name, fn)
        return self

    def __exit__(self, *exc):
        from cadence_tpu_torch.ops import scan as S

        for name, fn in getattr(self, "saved", {}).items():
            setattr(S, name, fn)
        return False

    def summary(self) -> dict:
        key = lambda c: {" x ".join(map(str, k)): v for k, v in sorted(c.items())}  # noqa: E731
        return {"vis_mask": key(self.mask), "vis_topk": key(self.topk),
                "vis_apply": key(self.apply)}


def visibility_path(args):
    """The port's Stores.visibility with CADENCE_TPU_VISIBILITY=1 on the
    card: bench.py's population (bench.py:735-754) and a `ties` domain,
    queries with parity on, then timed with it off beside the host, then
    a write burst. Returns the launch counts of the run."""
    import random as pyrandom

    import torch

    from cadence_tpu_torch.engine.persistence import Stores, VisibilityRecord
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.utils import metrics as M

    n = args.vis_records
    knobs = {"CADENCE_TPU_VISIBILITY": "1", "CADENCE_TPU_VISIBILITY_PARITY": "1",
             "CADENCE_TPU_VISIBILITY_CAPACITY": str(n)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    shape_log = VisShapeLog()
    try:
        t0 = time.perf_counter()
        vis = Stores().visibility
        rng = pyrandom.Random(VIS_SEED)
        base = 1_700_000_000_000_000_000
        for i in range(n):
            attrs = {}
            r = rng.random()
            if r < 0.5:
                attrs["Priority"] = rng.randrange(0, 10)
            elif r < 0.8:
                attrs["Tag"] = f"tag-{rng.randrange(4)}"
            vis.record_started(VisibilityRecord("bench", f"wf-{i}", f"r-{i}", f"wt-{i % 8}",
                                                base + i * 1000, search_attrs=attrs))
            if rng.random() < 0.5:
                vis.record_closed("bench", f"wf-{i}", f"r-{i}", base + i * 1000 + 7,
                                  rng.randrange(0, 3))
        ties = [(f"tie-{i:04d}", f"tr-{i:04d}") for i in range(4096)]
        for i, (wf, run) in enumerate(ties):
            vis.record_started(VisibilityRecord("ties", wf, run, "tie", base + (i % 16) * 1000))
        t_populate = time.perf_counter() - t0
        M.DEFAULT_REGISTRY.reset()
        reg, sc = M.DEFAULT_REGISTRY, M.SCOPE_TPU_VISIBILITY
        torch.cuda.synchronize()
        shape_log.__enter__()
        _build.reset_launches()
        t_start = time.perf_counter()
        os.environ["CADENCE_TPU_VISIBILITY_PARITY"] = "0"
        vis.count("bench", "")  # the first routed query bootstraps the view
        t_bootstrap = time.perf_counter() - t_start
        os.environ["CADENCE_TPU_VISIBILITY_PARITY"] = "1"
        queries = vis_queries(n)[:6]
        sel = {}
        for name, q in queries:  # parity on: every answer re-checked on the host
            c = vis.count("bench", q)
            if len(vis.query("bench", q)) != c:
                fail(f"visibility_path {name}: list and count disagree")
            sel[name] = c
        walk, token = [], None
        while True:
            page, token = vis.query_page("ties", "", 100, token)
            walk += [(r.workflow_id, r.run_id) for r in page]
            if token is None:
                break
        fb = reg.counter(sc, M.M_VIS_FALLBACK_PREDICATE)
        vis.count("bench", "WorkflowType > 'wt-3'")
        if reg.counter(sc, M.M_VIS_FALLBACK_PREDICATE) != fb + 1:
            fail("visibility_path: string ordering did not count as fallback-predicate")
        # parity off: the device path alone, timed, then the host's count
        os.environ["CADENCE_TPU_VISIBILITY_PARITY"] = "0"
        timed = {}
        for name, q in queries:
            runs = []
            for _ in range(REPS):
                t1 = time.perf_counter()
                c = vis.count("bench", q)
                runs.append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            listed = len(vis.query("bench", q))
            timed[name] = {"count": c, "device_count_ms": statistics.median(runs) * 1e3,
                           "device_list_ms": (time.perf_counter() - t1) * 1e3}
        os.environ["CADENCE_TPU_VISIBILITY"] = "0"
        for name, q in queries:
            t1 = time.perf_counter()
            c = vis.count("bench", q)
            timed[name]["host_count_ms"] = (time.perf_counter() - t1) * 1e3
            if c != timed[name]["count"] or c != sel[name]:
                fail(f"visibility_path {name}: host count {c}, device {timed[name]['count']}")
        host_walk, token = [], None
        while True:
            page, token = vis.query_page("ties", "", 100, token)
            host_walk += [(r.workflow_id, r.run_id) for r in page]
            if token is None:
                break
        if walk != host_walk or len(walk) != len(ties):
            fail("visibility_path: the ties page walk differs from the host's")
        os.environ["CADENCE_TPU_VISIBILITY"] = "1"
        os.environ["CADENCE_TPU_VISIBILITY_PARITY"] = "1"
        # the write burst, each write followed by a count (parity on)
        t1 = time.perf_counter()
        for i, (wf, run) in enumerate(ties):
            vis.record_closed("ties", wf, run, base + 10 ** 9, i % 3)
            if vis.count("ties", "CloseStatus = -1") != len(ties) - i - 1:
                fail("visibility_path: a close was not read back")
        t_close = time.perf_counter() - t1
        # every column on the card against the host mirror, before the new
        # attribute's restage rewrites them all
        checked = {"after_close": view_columns_equal(vis._device, "visibility_path after the "
                                                                  "close burst")}
        t1 = time.perf_counter()
        t_restage = None
        for i, (wf, run) in enumerate(ties[:1024]):
            vis.upsert_search_attributes("ties", wf, run, {"Burst": i})
            if vis.count("ties", "Burst >= 0") != i + 1:
                fail("visibility_path: an upsert was not read back")
            if t_restage is None:
                t_restage = time.perf_counter() - t1  # the new column's restage
        t_upsert = time.perf_counter() - t1
        t1 = time.perf_counter()
        for i, (wf, run) in enumerate(ties[:512]):
            vis.delete_record("ties", wf, run)
            if vis.count("ties", "") != len(ties) - i - 1:
                fail("visibility_path: a delete was not read back")
        t_delete = time.perf_counter() - t1
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t_start
        checked["after_delete"] = view_columns_equal(vis._device, "visibility_path after the "
                                                                  "deletes")
        launches = dict(_build.launches)
        view = vis._device
        stats = view.stats()
        view.stop()
    finally:
        shape_log.__exit__()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if stats["parity_divergence"] or stats["quarantined"]:
        fail(f"visibility_path: {stats['parity_divergence']} parity divergences")
    if not stats["device_served"] or not stats["topk_escalations"]:
        fail(f"visibility_path: device_served {stats['device_served']}, topk_escalations "
             f"{stats['topk_escalations']}")
    check_launches(launches, "visibility_path", VISIBILITY_PATH_KERNELS)
    records = n + len(ties)
    dev_s = sum(t["device_count_ms"] for t in timed.values()) / 1e3
    host_s = sum(t["host_count_ms"] for t in timed.values()) / 1e3
    emit("visibility_path", records=records, capacity=stats["capacity"],
         populate_seconds=t_populate, bootstrap_seconds=t_bootstrap,
         restage_seconds=t_restage, selectivity={k: v / n for k, v in sel.items()},
         timed=timed, device_rows_per_s=records * len(queries) / dev_s,
         host_rows_per_s=records * len(queries) / host_s, page_walk_pages=-(-len(ties) // 100),
         burst_seconds={"record_closed": t_close, "upsert": t_upsert, "delete": t_delete},
         writes=len(ties) + 1024 + 512, seconds=t_path,
         parity_divergence=stats["parity_divergence"], device_served=stats["device_served"],
         host_fallbacks=stats["host_fallbacks"], topk_escalations=stats["topk_escalations"],
         parity_checks=stats["parity_checks"], deltas_applied=stats["deltas_applied"],
         drains=stats["drains"], launches=launches, launch_shapes=shape_log.summary(),
         columns_checked=checked)
    return launches


def gen_ops(lanes) -> int:
    """32-bit integer instructions of generating these [W, E, 18] lanes:
    GEN_OPS_PER_EVENT each, and the attribute draws the events' types use
    (a die and an add each): three for ActivityTaskScheduled, one for
    TimerStarted and one for WorkflowExecutionStarted. Counted from the
    types this run's lanes hold."""
    from cadence_tpu_torch.core.enums import EventType as ET

    types = lanes[:, :, 1]
    draws = (3 * int((types == int(ET.ActivityTaskScheduled)).sum())
             + int((types == int(ET.TimerStarted)).sum())
             + int((types == int(ET.WorkflowExecutionStarted)).sum()))
    return types.numel() * GEN_OPS_PER_EVENT + draws * (DIE_OPS + ADD64)


def gen_kernels(args, corp, dev, records, err_i: int):
    """Phases kernel_gen_lanes and kernel_replay_gen: kernel I and kernel
    A's generator reader against their plain versions, against each other
    and against the oracle, timed beside their bounds. `err_i` is kernel
    I's largest difference from its plain version at this phase's shape,
    which kernel_launch_shapes measured (and held to 0) before it."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.enums import EventType
    from cadence_tpu_torch.ops import _build, genkernel as G, replay as R
    from cadence_tpu_torch.ops.payload import payload_rows
    from cadence_tpu_torch.ops.state import init_state, leaves

    W, E = GEN_CHECK_W, args.ns_events
    launch = lambda run: run()  # noqa: E731
    # --- kernel I (equal to its plain version with tolerance 0 at this shape
    # in kernel_launch_shapes)
    if err_i:
        fail(f"gen_lanes kernel differs from its plain version (max abs err {err_i})")
    lk = G.generate_lanes(SEED, 0, W, E, dev)
    # every history closes: ids 1..E, Started first, Completed last
    ids = torch.arange(1, E + 1, device=dev)
    if (not bool((lk[:, :, 0] == ids).all())
            or not bool((lk[:, 0, 1] == int(EventType.WorkflowExecutionStarted)).all())
            or not bool((lk[:, -1, 1] == int(EventType.WorkflowExecutionCompleted)).all())):
        fail("gen_lanes: a history does not run 1..E from Started to Completed")
    # the oracle's sample: kernel I's lanes equal the CPU plain version's, and
    # kernels A and B on them give the oracle's rows; the oracle found every
    # sampled history Completed with nothing pending
    s_a = R.replay_scan(init_state(W, device=dev), lk)
    rows_a = payload_rows(s_a).cpu().numpy()
    err_a = s_a.error.cpu().numpy()
    bad = [start for start, lanes in corp["ns_blocks"]
           if not np.array_equal(lk[start:start + len(lanes)].cpu().numpy(), lanes)]
    if bad:
        fail(f"gen_lanes: kernel I's lanes differ from the CPU plain version's at blocks {bad}")
    orc = corp["ns_oracle"]
    unclosed = [i for i, row in orc.items() if row is None]
    parity = [i for i, row in orc.items() if row is not None
              and (err_a[i] != 0 or not np.array_equal(rows_a[i], row))]
    if unclosed or parity or (err_a != 0).any():
        fail(f"gen_lanes: {len(unclosed)} sampled histories not closed, {len(parity)} rows "
             f"differ from the oracle, {int((err_a != 0).sum())} rows with errors")
    ms_i = cuda_ms(launch, setup=lambda: G.generate_lanes_launch(SEED, 0, W, E, dev)[0])
    ms_ip = cuda_ms(lambda _: G.generate_lanes_plain(SEED, 0, W, E, dev), PLAIN_REPS)
    torch.cuda.empty_cache()
    regs_i = ptxas_usage(_build.build_log, "gen_lanes_kernel")
    records.append(kernel_record(
        "gen_lanes", "cadence_tpu_torch/csrc/genkernel.cu", "cadence_tpu/ops/genkernel.py:318",
        None, err_i, ms_i, ms_ip, W * E * 144, gen_ops(lk),
        also_replaces=["cadence_tpu/ops/genkernel.py:135", "cadence_tpu/ops/genkernel.py:112"],
        hook="cadence_tpu_torch/csrc/genkernel.cuh", shape=[W, E], ptxas=regs_i,
        timed=f"median of {REPS} single launches; plain: median of {PLAIN_REPS}"))
    emit("kernel_gen_lanes", workflows=W, events=E, lanes_bytes=W * E * 144, max_abs_err=err_i,
         oracle_sampled=len(orc), oracle_equal=len(orc) - len(parity), closed=W,
         ms=ms_i, plain_ms=ms_ip, bound_ms=W * E * 144 / HBM_BYTES_PER_S * 1e3, ptxas=regs_i)

    # --- kernel A's generator reader: the state of kernel A on kernel I's
    # lanes (the materialize-then-replay contract), and the plain fused loop
    s_g = G.gen_scan(init_state(W, device=dev), SEED, 0, E)
    states_equal(s_g, s_a, "replay_gen against kernel A on kernel I's lanes")
    ops_w = gen_ops(lk) + replay_ops(lk)
    del lk, s_a
    torch.cuda.empty_cache()
    wc = args.gen_plain_w
    s_gk = G.gen_scan(init_state(wc, device=dev), SEED, 0, E)
    s_gp = G.gen_scan_plain(init_state(wc, device=dev), SEED, 0, E)
    states_equal(s_gk, s_gp, f"replay_gen at {wc} x {E} against the plain fused loop")
    err_g = max(max_abs_err(x, y) for (_, x), (_, y) in zip(leaves(s_gk), leaves(s_gp)))
    del s_gk, s_gp
    fresh = lambda n: init_state(n, device=dev)  # noqa: E731
    ms_g = cuda_ms(launch, setup=lambda: G.gen_launch(fresh(W), SEED, 0, E))
    ms_gp = cuda_ms(lambda st: G.gen_scan_plain(st, SEED, 0, E), 1, setup=lambda: fresh(W),
                    warm=False)
    sb = state_bytes(s_g)
    fill = max(args.ns_chunks)
    ms_fill = cuda_ms(launch, setup=lambda: G.gen_launch(fresh(fill), SEED, 0, E))
    # each shape the launch chooses between, at both widths: threads a workflow
    by_tpw = {f"{w}x{tpw}": cuda_ms(launch, 3, setup=lambda w=w, tpw=tpw: gen_c_launch(
        _build.load().cadence_replay_gen, fresh(w), E, tpw, "replay_gen"))
        for w in (W, fill) for tpw in (1, 2)}
    # the same kernel with its draws made in the stepping loop, on the chain:
    # what making them ahead, by the whole block, saves
    inline = gen_inline_draws(s_g, E, (W, fill), (1, 2))
    torch.cuda.empty_cache()
    # the fill chunk's operations: the W-workflow count scaled to its width
    ops_fill = ops_w * fill // W
    sb_fill = sb // W * fill
    regs_g = gen_ptxas(_build.build_log)
    regs_a = a_ptxas(_build.build_log)
    records.append(kernel_record(
        "replay_gen", "cadence_tpu_torch/csrc/replay_gen.cu", "cadence_tpu/ops/genkernel.py:332",
        None, err_g, ms_g, ms_gp, sb, ops_w,
        also_replaces=["cadence_tpu/ops/genkernel.py:357", "cadence_tpu/ops/genkernel.py:371",
                       "cadence_tpu/ops/genkernel.py:440", "cadence_tpu/ops/genkernel.py:462"],
        hook="cadence_tpu_torch/csrc/replay_gen.cuh", shape=[W, E],
        events_per_s=W * E / ms_g * 1e3, fill_shape=[fill, E], fill_ms=ms_fill,
        fill_bound_ms=bound_ms(sb_fill, ops_fill), fill_events_per_s=fill * E / ms_fill * 1e3,
        ms_by_width_and_threads_per_workflow=by_tpw, ms_draws_on_the_chain=inline,
        gen_ops_per_event=GEN_OPS_PER_EVENT, int_ops_per_s=int_ops_per_s(), ptxas=regs_g,
        ptxas_kernel_a=regs_a,
        timed=f"median of {REPS} single launches, each on a fresh state; plain: one run"))
    emit("kernel_replay_gen", equal_states=66, against=["kernel A on kernel I's lanes",
                                                       f"the plain fused loop at {wc} x {E}"],
         max_abs_err=err_g, ms=ms_g, plain_ms=ms_gp, bound_ms=bound_ms(sb, ops_w),
         events_per_s=W * E / ms_g * 1e3, fill_chunk=fill, fill_ms=ms_fill,
         fill_bound_ms=bound_ms(sb_fill, ops_fill), fill_events_per_s=fill * E / ms_fill * 1e3,
         fill_state_bytes=sb_fill, ms_by_width_and_threads_per_workflow=by_tpw,
         ms_draws_on_the_chain=inline,
         gen_ops_per_event=GEN_OPS_PER_EVENT, ptxas=regs_g, ptxas_kernel_a=regs_a)
    del s_g
    torch.cuda.empty_cache()


#: csrc/replay_gen.cu edited so that each stepping thread makes its own
#: step's draws in the step (the tile phase makes none): the comparison
#: gen_inline_draws times
INLINE_DRAWS = (
    ("      if (s < n && w0 + x < W) dice[j] = gen::pack_dice(seed, first_index + w0 + x, e0 + s);",
     "      (void)s, (void)x;"),
    ("        st.step(S, c, tables, e0 + s, E, dice[s * GEN_WF + wl]);",
     "        st.step(S, c, tables, e0 + s, E,\n"
     "                gen::pack_dice(seed, first_index + w0 + wl, e0 + s));"),
)


def gen_c_launch(fn, s, E: int, tpw: int, what: str):
    """A call that runs `fn`, a C entry point with cadence_replay_gen's
    signature, on state `s` (workflows 0 .. W - 1 of SEED, E events) with
    `tpw` threads a workflow. It counts no launch."""
    from cadence_tpu_torch.ops import _build, genkernel as G
    from cadence_tpu_torch.ops.state import layout_of

    lay = layout_of(s)
    args = (_build.state_pointer_table(s), G._wrap(SEED), 0, s.state.shape[0], E,
            _build.caps(lay), lay.max_branches, lay.max_version_history_items, tpw,
            _build.stream_of(s.state))

    def go():
        _build.check(fn(*args), what)

    go.state = s  # the launch holds the state its pointers point into
    return go


def gen_inline_draws(want, E: int, widths, tpws) -> dict:
    """Milliseconds of kernel A's generator reader built from
    csrc/replay_gen.cu with INLINE_DRAWS applied (the draws on each
    stepping thread's chain), at each width and threads a workflow, each
    launch on a fresh state; its state at want's width must equal `want`
    (kernel A's generator reader's). Built with nvcc into a temporary
    directory under csrc/_build, and used for this timing alone."""
    import ctypes
    import shutil
    import tempfile

    import torch

    from cadence_tpu_torch.device import nvcc_path
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.ops.state import init_state, leaves

    src = open(os.path.join(_build._CSRC, "replay_gen.cu")).read()
    for a, b in INLINE_DRAWS:
        if a not in src:
            fail("gen_inline_draws: csrc/replay_gen.cu no longer has the line to edit")
        src = src.replace(a, b)
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build._BUILD_DIR)
    try:
        cu, so = os.path.join(tmp, "replay_gen_inline.cu"), os.path.join(tmp, "inline.so")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([nvcc_path(), _build._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-shared", "-I", _build._CSRC, "-o", so, cu], check=True,
                       capture_output=True, timeout=600)
        fn = ctypes.CDLL(so).cadence_replay_gen
        fn.restype = ctypes.c_int
        fn.argtypes = _build.load().cadence_replay_gen.argtypes

        def run(w, tpw):
            return gen_c_launch(fn, init_state(w, device=want.state.device), E, tpw,
                                "replay_gen (draws on the chain)")

        out = {}
        for w in widths:
            for tpw in tpws:
                go = run(w, tpw)
                go()
                if w == want.state.shape[0] and not all(
                        torch.equal(x, y) for (_, x), (_, y) in zip(leaves(go.state),
                                                                    leaves(want))):
                    fail("gen_inline_draws: the edited kernel's state differs")
                del go
                out[f"{w}x{tpw}"] = cuda_ms(lambda go: go(), 3, setup=lambda: run(w, tpw))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Kernels A and B at the shapes their launches have, beside a parent build
# ---------------------------------------------------------------------------

#: (W, E) of kernel A's serving flushes (engine/resident.py _append_group's
#: buckets: W a power of two from 8, E from 16), each replayed from a
#: carried state; the resident and verify chunk; the bulk (suites-8k)
FLUSH_SHAPES = ((8, 16), (64, 16), (128, 16), (64, 32))
CHUNK_W = 4096
#: the C entry point each launch name calls (a parent commit must have the
#: same signatures)
ENTRY = {"replay": "cadence_replay", "replay_tasks": "cadence_replay_tasks",
         "replay_wirec": "cadence_replay_wirec", "payload": "cadence_payload",
         "rehome": "cadence_rehome", "gen_lanes": "cadence_gen_lanes",
         "replay_gen": "cadence_replay_gen", "vis_mask": "cadence_vis_mask",
         "vis_mask_table": "cadence_vis_mask_table", "vis_topk": "cadence_vis_topk",
         "vis_topk_table": "cadence_vis_topk_table", "vis_apply": "cadence_vis_apply",
         "crc32": "cadence_crc32", "verify_rows": "cadence_verify_rows",
         "narrow_ok": "cadence_narrow_ok", "stats": "cadence_stats",
         "decode_wirec": "cadence_decode_wirec"}
#: kernel B's entry point before its epilogues (a parent commit's): its
#: parameters, and the positions of the port's arguments it takes (all but
#: out B, fit, counts and the counts scratch)
PAYLOAD_BEFORE_EPILOGUES = ("const void* ptr_table, void* rows, void* overflow, int64_t W, "
                            "const int* caps, int b, int kv, const int* out_caps, int out_kv, "
                            "int width, void* stream")
PAYLOAD_BEFORE_ARGS = tuple(range(10)) + (14,)
#: the kernels kernel_launch_shapes times, by the source files that build them
#: (and kernel A's entry points, replay*.cu)
SHAPE_SOURCES = ("payload.cu", "rehome.cu", "genkernel.cu", "scan.cu", "crc32.cu", "verify.cu",
                 "stats.cu", "wirec.cu")
#: the rows kernel C is launched with: feeder_path's 4,096-workflow chunks,
#: north_star's 16,384 and 131,072 chunks, the main path's bulk (40,960)
C_SHAPES = (4096, 16384, 40960, 131072)
#: the rows kernel D is launched with: verify_all's 4,096-key chunks and the
#: main path's bulk
D_SHAPES = (4096, 40960)
#: verify_path's alterations: 64 live states of 24,576 (about 11 a 4,096
#: chunk), half in a payload word and half in the current branch
D_ALTERED = (64, 24576)
#: rows kernel B's fit epilogue (on a rung-1 state) and its counts epilogue
#: are timed at, where kernels H and F were launched: the fit at serving's
#: 8- and 32-row flushes, the resident pool's 64-row groups and a 4,096-row
#: chunk; the counts at the resident pool's 64, verify_all's 4,096 chunks
#: and their halves on a mesh of two, the wirec mesh's 10,240, the main
#: path's 20,480 and 40,960
H_SHAPES = (8, 32, 64, 4096)
F_SHAPES = (64, 2048, 4096, 10240, 20480, 40960)
#: rows kernel B is launched with alone: a serving flush's 64, verify_all's
#: and the feeder's 4,096-row chunks, north_star's 16,384 and 131,072
#: chunks, the main path's bulk
B_SHAPES = (64, 4096, 16384, 40960, 131072)


def build_entries(csrc: str, sources, subs=()):
    """Build `sources` (file names in the kernel directory `csrc`) into one
    library with nvcc, side by side, after the text substitutions `subs`
    ((file, old, new) each; `old` must occur); returns (the library, its
    ptxas log). The entry points' argument types are the port's own;
    `lib.entries` names those whose declarations are the port's (an entry
    point of another signature is never called). Used to time the parent
    commit's kernels and variants of this tree's beside the port's, never
    by the port."""
    import ctypes
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from cadence_tpu_torch.device import nvcc_path
    from cadence_tpu_torch.ops import _build

    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build._BUILD_DIR)
    try:
        src = os.path.join(tmp, "csrc")
        shutil.copytree(csrc, src, ignore=shutil.ignore_patterns("_build"))
        for name, old, new in subs:
            path = os.path.join(src, name)
            text = open(path).read()
            if old not in text:
                fail(f"build_entries: {name} no longer has {old!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        objs = [os.path.join(tmp, s + ".o") for s in sources]
        cmds = [[nvcc_path(), _build._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c", "-o", o, os.path.join(src, s)]
                for s, o in zip(sources, objs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            logs = [out for out, _ in pool.map(_build._run, cmds)]
        so = os.path.join(tmp, "entries.so")
        _build._run([nvcc_path(), _build._ARCH, "-shared", "-o", so] + objs)
        lib = ctypes.CDLL(so)
        port = _build.load()
        theirs = entry_declarations(src, sources)
        mine = entry_declarations(_build._CSRC, sorted(os.listdir(_build._CSRC)))
        lib.entries = {e for e in ENTRY.values() if e in theirs and theirs[e] == mine.get(e)}
        # {entry: the positions of the port's arguments it takes}, for an
        # older entry point that takes fewer
        lib.adapt = {}
        if theirs.get(ENTRY["payload"]) == PAYLOAD_BEFORE_EPILOGUES:
            lib.entries.add(ENTRY["payload"])
            lib.adapt[ENTRY["payload"]] = PAYLOAD_BEFORE_ARGS
        for entry in lib.entries:
            getattr(lib, entry).restype = ctypes.c_int
            types = getattr(port, entry).argtypes
            getattr(lib, entry).argtypes = [types[i] for i in lib.adapt.get(entry,
                                                                            range(len(types)))]
        return lib, "\n".join(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # the loaded library stays mapped


def entry_declarations(csrc: str, sources) -> dict:
    """{entry point: its parameter list, whitespace collapsed} of the
    `extern "C"` functions in `sources` (file names in `csrc`)."""
    import re

    out = {}
    for name in sources:
        path = os.path.join(csrc, name)
        if name.endswith(".cu") and os.path.isfile(path):
            for entry, params in re.findall(r'extern "C" \w+ (\w+)\(([^)]*)\)', open(path).read()):
                out[entry] = " ".join(params.split())
    return out


def rebind(launch, lib, name: str):
    """The launch `launch` (a port wrapper's, kernel `name`) as a call of
    `lib`'s entry point with the same arguments (those it takes, where it is
    an older entry point: lib.adapt), after the launch's `copy` step where
    it has one (kernel L's packed block). It counts no launch."""
    import torch

    from cadence_tpu_torch.ops import _build

    fn = getattr(lib, ENTRY[name])
    args = launch.args
    taken = getattr(lib, "adapt", {}).get(ENTRY[name])
    if taken is not None:
        if any(isinstance(a, torch.Tensor) for i, a in enumerate(args) if i not in taken):
            fail(f"{name} ({lib._name}): the older entry point has no output for an epilogue")
        args = [args[i] for i in taken]
    c_args = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args)
    copy = getattr(launch, "copy", None)

    def go():
        if copy is not None:
            copy()
        _build.check(fn(*c_args), f"{name} ({lib._name})")

    go.launch = launch  # the tensors its pointers point into
    return go


def carried_split(lanes, idx, tail: int):
    """(prefix, suffix) lanes of the workflows `idx` of [W, E, 18] `lanes`:
    each workflow's last `tail` real events (or all of them, when it has
    fewer) in the suffix, the rest in the prefix, both padded with id-0
    rows."""
    import numpy as np

    ev = lanes[idx]
    n = (ev[:, :, 0] > 0).sum(1)
    cut = np.maximum(n - tail, 0)
    pre = np.zeros((len(idx), max(1, int(cut.max())), ev.shape[2]), dtype=ev.dtype)
    suf = np.zeros((len(idx), tail, ev.shape[2]), dtype=ev.dtype)
    for i in range(len(idx)):
        pre[i, :cut[i]] = ev[i, :cut[i]]
        suf[i, :n[i] - cut[i]] = ev[i, cut[i]:n[i]]
    return pre, suf


def outputs_equal(a, b, what: str) -> None:
    """Two launches' outputs (states, task logs, tensors) are equal."""
    import torch

    from cadence_tpu_torch.ops.state import ReplayState
    from cadence_tpu_torch.ops.taskgen import TaskLog

    for x, y in zip(a, b):
        if isinstance(x, ReplayState):
            states_equal(x, y, what)
        elif isinstance(x, TaskLog):
            logs_equal(x, y, what)
        elif not torch.equal(x, y):
            fail(f"{what}: outputs differ")


def kept(launch, *outputs):
    """(launch, outputs), the launch holding the outputs its pointers point
    into."""
    launch.keep = outputs
    return launch, outputs


def launch_shapes(events_np, dev, gen_events: int, variants=(), fuzz=None) -> dict:
    """Phase kernel_launch_shapes: kernel A (each reader, with and without
    tasks), kernel B, kernel G, kernel I and A's generator reader timed at the shapes the driven
    paths launch them with, each beside its bound and the launch floor (a
    one-element add_ timed the same way). Each of `variants` ((name, library
    from build_entries)) runs the same arguments and must give the same
    outputs; a variant named "parent" (the parent commit's kernels) is timed
    in turns parent, change, change, parent, the others after the change.
    Every launch runs on fresh copies of its inputs. Kernel G is timed at
    the resident pool's shapes (rehome_shapes), kernel I at the north
    star's parity leg (NS_BLOCK x gen_events) and at GEN_CHECK_W x
    gen_events, kernel A's generator reader at GEN_CHECK_W and at the
    largest of NS_CHUNKS x gen_events, kernel E where the paths decode
    wirec bytes (decode_shapes; `fuzz` is generate()'s fuzz corpus).
    Returns the phase's record."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as L
    from cadence_tpu_torch.native import wirec as NW
    from cadence_tpu_torch.ops import genkernel as G, rehome as RH, replay as R
    from cadence_tpu_torch.ops.encode import to_wire32
    from cadence_tpu_torch.ops.payload import payload_launch
    from cadence_tpu_torch.ops.state import init_state, map_state, rehome_plain
    from cadence_tpu_torch.ops.taskgen import init_task_log

    launch = lambda run: run()  # noqa: E731
    clone = lambda s: map_state(lambda t: t.clone(), s)  # noqa: E731
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(lambda _: one.add_(1))
    floor_device = cuda_ms(lambda _: one.add_(1), behind=True)
    variants = list(variants)
    parent = dict(variants).get("parent")
    shapes = {}

    def timed(key, name, make, nbytes, ops, check=None, parent_make=None):
        """Time make()'s launch (and each variant's on its arguments),
        after holding every variant's outputs equal to the port's and the
        port's to `check`'s, when given. `parent_make(lib)`, when given,
        makes the parent's launch and outputs for the same work (the
        launches the parent made for it, in turn: rebind_all)."""
        want, want_out = make()
        want()
        if check is not None:
            outputs_equal(want_out, check, f"{key}: kernel against its plain version")
        mine = [(who, lib) for who, lib in variants
                if ENTRY[name] in lib.entries or (parent_make and lib is parent)]

        def made(lib):
            if parent_make is not None and lib is parent:
                return parent_make(lib)
            got, got_out = make()
            return rebind(got, lib, name), got_out

        for who, lib in mine:
            got, got_out = made(lib)
            got()
            outputs_equal(got_out, want_out, f"{key}: {who} against the port")
        other = lambda lib: lambda: made(lib)[0]  # noqa: E731
        runs = {}
        timed_parent = parent is not None and (parent_make is not None
                                               or ENTRY[name] in parent.entries)
        if timed_parent:
            runs["parent"] = [cuda_ms(launch, setup=other(parent))]
        runs["change"] = [cuda_ms(launch, setup=lambda: make()[0])
                          for _ in range(2 if timed_parent else 1)]
        for who, lib in mine:
            runs.setdefault(who, []).append(cuda_ms(launch, setup=other(lib)))
        # the card's time alone, behind a queued spin kernel
        device = {"change": cuda_ms(launch, setup=lambda: make()[0], behind=True)}
        for who, lib in mine:
            device[who] = cuda_ms(launch, setup=other(lib), behind=True)
        rec = {"kernel": name, "ms": {who: statistics.mean(v) for who, v in runs.items()},
               "runs": runs, "device_ms": device, "bound_ms": bound_ms(nbytes, ops),
               "floor_ms": floor, "floor_device_ms": floor_device}
        shapes[key] = rec
        emit("kernel_launch_shape", shape=key, **rec)

    def readers(tag, s0, ev, suf, E, plain=None):
        """Kernel A's readers at one shape from state s0 (fresh or carried):
        int64, wire32, wirec, and with tasks on int64 and wire32 lanes.
        Returns the int64 reader's final state."""
        W = ev.shape[0]
        sb = state_bytes(s0)
        final = R.replay_scan(clone(s0), ev)
        if plain is not None:
            states_equal(final, plain, f"replay {tag}: kernel against its plain version")
        timed(f"replay {tag}", "replay", lambda: kept(R.replay_launch(s := clone(s0), ev), s),
              ev.numel() * 8 + sb, replay_ops(ev))
        ev32 = torch.from_numpy(to_wire32(suf)).to(dev)
        timed(f"replay wire32 {tag}", "replay",
              lambda: kept(R.replay_launch(s := clone(s0), ev32, wire32=True), s),
              ev32.numel() * 4 + sb, replay_ops(ev), check=(final,))
        wc = NW.pack_wirec_auto(suf)
        parts = NW.stage_corpus(wc, dev)
        wplain = None if plain is None else (R.wirec_scan_plain(s0, *parts, wc.profile),)
        timed(f"replay_wirec {tag}", "replay_wirec",
              lambda: kept(R.wirec_launch(s := clone(s0), *parts, wc.profile), s),
              sum(t.numel() * t.element_size() for t in parts) + sb,
              replay_ops(ev) + decode_ops(wc.profile, W * E), check=wplain)
        for lanes, wire32, t in ((ev, False, ""), (ev32, True, " wire32")):
            fresh_log = lambda: init_task_log(W, 128, 128, dev)  # noqa: E731
            s_t, log_t = R.replay_tasks_scan(clone(s0), fresh_log(), lanes, wire32)
            tplain = None if plain is None else R.replay_tasks_scan_plain(s0, fresh_log(), lanes,
                                                                          wire32)
            t_bytes, t_ops = task_bytes_ops(ev, log_t)

            def make_t():
                s, log = clone(s0), fresh_log()
                return kept(R.replay_tasks_launch(s, log, lanes, wire32), s, log)

            timed(f"replay_tasks{t} {tag}", "replay_tasks", make_t,
                  lanes.numel() * lanes.element_size() + sb + t_bytes, replay_ops(ev) + t_ops,
                  check=tplain)
            del s_t, log_t
        return final

    W_all = events_np.shape[0]
    finals = {}
    # the serving flush shapes, from carried states: every reader at 64 x 16
    for Wf, Ef in FLUSH_SHAPES:
        idx = np.linspace(0, W_all - 1, Wf).astype(np.int64)
        pre, suf = carried_split(events_np, idx, Ef)
        s0 = R.replay_scan(init_state(Wf, L, dev), torch.from_numpy(pre).to(dev))
        ev = torch.from_numpy(suf).to(dev)
        plain = R.replay_scan_plain(s0, ev)
        tag = f"{Wf}x{Ef} carried"
        if (Wf, Ef) == (64, 16):
            finals[Wf] = readers(tag, s0, ev, suf, Ef, plain)
        else:
            states_equal(R.replay_scan(clone(s0), ev), plain, f"replay {tag}")
            timed(f"replay {tag}", "replay",
                  lambda: kept(R.replay_launch(s := clone(s0), ev), s),
                  ev.numel() * 8 + state_bytes(s0), replay_ops(ev))
    # the resident and verify chunk and the bulk, from fresh states
    for Wc in (CHUNK_W, W_all):
        sub = events_np[:Wc]
        ev = torch.from_numpy(sub).to(dev)
        finals[Wc] = readers(f"{Wc}x{sub.shape[1]}", init_state(Wc, L, dev), ev, sub,
                             sub.shape[1])
        del ev
    # kernel B at a flush, a chunk and the bulk, on those final states
    for Wb in (64, CHUNK_W, W_all):
        s = finals[Wb]

        def make_b():
            run, rows, overflow = payload_launch(s, L)
            return kept(run, rows, overflow)

        nbytes, ops = payload_bytes_ops(Wb, L)
        timed(f"payload {Wb}", "payload", make_b, nbytes, ops)
    # kernel G at the resident pool's shapes, on rows of the chunk's and the
    # bulk's final states
    for key, src, rows, out_lay, dst, d_rows in rehome_shapes(finals[CHUNK_W], finals[W_all],
                                                             finals[64], dev):
        def make_g(src=src, rows=rows, out_lay=out_lay, dst=dst, d_rows=d_rows):
            d = None if dst is None else clone(dst)
            run, out = RH.rehome_launch(src, rows, out_lay, d, d_rows)
            return kept(run, out)

        want = rehome_plain(src, rows, out_lay, None if dst is None else clone(dst), d_rows)
        timed(key, "rehome", make_g, rehome_bytes(src, rows, out_lay), 0, check=(want,))
        del want
    staging = rehome_staging(events_np, finals[CHUNK_W], dev)
    # kernel I at the parity leg's launch (NS_BLOCK workflows; bench.py's
    # sample blocks start anywhere) and at the check width, each launch's
    # largest difference from the plain version kept for kernel_gen_lanes
    gen_err = {}
    for Wi, first in ((NS_BLOCK, 5 * NS_BLOCK), (GEN_CHECK_W, 0)):
        key = f"gen_lanes {Wi}x{gen_events}"
        plain = G.generate_lanes_plain(SEED, first, Wi, gen_events, dev)
        gen_err[key] = max_abs_err(G.generate_lanes(SEED, first, Wi, gen_events, dev), plain)
        timed(key, "gen_lanes",
              lambda Wi=Wi, first=first: kept(*G.generate_lanes_launch(SEED, first, Wi,
                                                                        gen_events, dev)),
              plain.numel() * 8, gen_ops(plain), check=(plain,))
        if Wi == GEN_CHECK_W:
            ops_check = gen_ops(plain) + replay_ops(plain)
        del plain
    torch.cuda.empty_cache()
    # kernel A's generator reader at the check width and at the north star's
    # chunk that fills the card, from fresh states (its operations those of
    # the check width's lanes, scaled)
    row_bytes = state_bytes(init_state(1, L, "meta"))
    for Wg in (GEN_CHECK_W, max(NS_CHUNKS)):
        timed(f"replay_gen {Wg}x{gen_events}", "replay_gen",
              lambda Wg=Wg: kept(G.gen_launch(s := init_state(Wg, L, dev), SEED, 0, gen_events),
                                 s),
              Wg * row_bytes, ops_check * Wg // GEN_CHECK_W)
        torch.cuda.empty_cache()
    reduce = reduce_shapes(finals[W_all], dev, timed)
    next_shapes(finals[CHUNK_W], finals[W_all], dev, timed)
    decode = decode_shapes(events_np, fuzz, dev, timed)
    vis_shapes(dev, timed)
    vis_feeds = vis_staging(dev)
    return {"floor_ms": floor, "floor_device_ms": floor_device, "shapes": shapes,
            "rehome_staging": staging, "gen_lanes_max_abs_err": gen_err, "vis_staging": vis_feeds,
            "reduce_shapes": reduce, "decode_shapes": decode}


def next_shapes(chunk, bulk, dev, timed) -> None:
    """Kernel B with its fit and counts epilogues where the paths launch
    it with them, timed as launched and on the card alone against the
    parent's launches for the same work (its B, then H or F on the same
    state): the fit at H_SHAPES on the first rows of the chunk's final
    state widened to rung 1 with rows made unfit on every rule (as
    kernel_narrow_ok makes them), the counts at F_SHAPES on the bulk's
    final state tiled to size; and B alone, its epilogues off, at the rows
    of B_SHAPES that launch_shapes does not time. Each equal to its plain
    versions."""
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as L
    from cadence_tpu_torch.ops import rehome as RH
    from cadence_tpu_torch.ops.payload import payload_launch, payload_rows_narrow_plain
    from cadence_tpu_torch.ops.state import widen_layout
    from cadence_tpu_torch.ops.stats import stats_launch

    def tiled(n):  # the bulk's final state, its rows repeated to n
        return RH.rehome(bulk, torch.arange(n, device=dev) % bulk.state.shape[0], L)

    L1 = widen_layout(L, 2)
    for n in H_SHAPES:
        h = RH.rehome(chunk, torch.arange(n, device=dev) % chunk.state.shape[0], L1)
        h.activities.occ[::5, L.max_activities + 3] = True
        h.timers.occ[1::7, L.max_timers] = True
        h.vh_count[3::13, L.max_branches] = 1

        def pair(h=h):  # the parent's work: B, then H on the same state
            b, rows, ovf = payload_launch(h, L)
            k, fit = RH.narrow_ok_launch(h, L)
            return ((b, "payload"), (k, "narrow_ok")), (rows, ovf, fit)

        timed(f"payload fit {n}", "payload", lambda h=h: kept(*payload_launch(h, L, fit=True)),
              *payload_bytes_ops(n, L, L1, fit=True),
              check=payload_rows_narrow_plain(h, L, fit=True),
              parent_make=lambda lib, pair=pair: rebind_all(lib, *pair()))
    for n in F_SHAPES:
        s = tiled(n)

        def pair(s=s):  # the parent's work: B, then F on the same state
            b, rows, ovf = payload_launch(s, L)
            f, counts = stats_launch(s.error, s.close_status)
            return ((b, "payload"), (f, "stats")), (rows, ovf, counts)

        timed(f"payload counts {n}", "payload",
              lambda s=s: kept(*payload_launch(s, L, counts=True)),
              *payload_bytes_ops(n, L, counts=True),
              check=payload_rows_narrow_plain(s, L, counts=True),
              parent_make=lambda lib, pair=pair: rebind_all(lib, *pair()))
        del s
    for n in B_SHAPES:
        if n in (64, CHUNK_W, bulk.state.shape[0]):
            continue  # timed by launch_shapes
        s = tiled(n)
        timed(f"payload {n}", "payload", lambda s=s: kept(*payload_launch(s, L)),
              *payload_bytes_ops(n, L), check=payload_rows_narrow_plain(s, L))
        del s
        torch.cuda.empty_cache()


def in_turn(calls, outputs):
    """(one call of `calls` in turn, `outputs`): the parent's kernel B and
    the kernel a path launched after it on the same state, as one timed
    launch."""
    def go():
        for call in calls:
            call()

    go.keep = (calls, outputs)
    return go, outputs


def rebind_all(lib, calls, outputs):
    """in_turn of `lib`'s entry points on the port launches `calls`
    ((launch, kernel name) each)."""
    return in_turn([rebind(launch, lib, name) for launch, name in calls], outputs)


def reduce_shapes(state, dev, timed, reps: int = REPS) -> dict:
    """Kernels C and D at their launch shapes (C_SHAPES, D_SHAPES), on
    kernel B's rows of `state` (the bulk's final state) tiled to size, each
    through `timed` (as launched and on the card alone, beside its bound,
    the parent and the variants). C is held to crc32_rows_plain and, on 256
    sampled rows, to zlib.crc32; D to verify_rows_plain at verify_path's
    rate of altered rows (D_ALTERED) and with none (every row read whole),
    beside its yardstick, (rows != expected).any(1) | (branch !=
    expected_branch), on the card alone. Then the host's time in one
    verify_rows() call at 4,096 rows as the engine makes it (every input
    already on the card), in verify_launch and in the bare launch, each
    behind a queued spin kernel. Returns the yardstick and host times."""
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as L
    from cadence_tpu_torch.ops import replay as R
    from cadence_tpu_torch.ops.crc import crc32_launch, crc32_rows_plain
    from cadence_tpu_torch.ops.payload import payload_rows

    base = payload_rows(state, L)
    width = base.shape[1]
    g = torch.Generator().manual_seed(SEED)

    def tiled(t, n):  # a fresh [n, ...] tensor of t's rows, repeated
        return t.repeat((-(-n // t.shape[0]),) + (1,) * (t.dim() - 1))[:n].clone()

    for n in C_SHAPES:
        rows = tiled(base, n)
        want = crc32_rows_plain(rows)
        pick = torch.randint(0, n, (256,), generator=g)
        zl = [zlib.crc32(r.astype("<i8").tobytes()) for r in rows[pick.to(dev)].cpu().numpy()]
        if want[pick.to(dev)].cpu().tolist() != zl:
            fail(f"crc32 {n}: the plain version differs from zlib")
        timed(f"crc32 {n}", "crc32", lambda rows=rows: kept(*crc32_launch(rows)),
              n * (width * 8 + 8), n * width * 24, check=(want,))
        del rows, want
    out = {"yardstick": "(rows != expected).any(1) | (branch != expected_branch)",
           "yardstick_device_ms": {}}
    for n in D_SHAPES:
        rows, branch = tiled(base, n), tiled(state.current_branch, n)
        for rate, k in (("verify_path", round(n * D_ALTERED[0] / D_ALTERED[1])), ("none", 0)):
            exp, exp_br = rows.clone(), branch.clone()
            idx = torch.randperm(n, generator=g)[:k].to(dev)
            cols = torch.randint(0, width, (k // 2,), generator=g).to(dev)
            exp[idx[:k // 2], cols] += 1
            exp_br[idx[k // 2:]] = 1 - exp_br[idx[k // 2:]]
            want = R.verify_rows_plain(rows, exp, branch, exp_br)
            if int(want.sum()) != k:
                fail(f"verify_rows {n} {rate}: {int(want.sum())} rows flagged, {k} altered")
            key = f"verify_rows {n} {rate}"
            timed(key, "verify_rows",
                  lambda exp=exp, exp_br=exp_br: kept(*R.verify_launch(rows, exp, branch, exp_br)),
                  n * (2 * width * 8 + 2 * 4 + 1), n * (width + 1), check=(want,))
            out["yardstick_device_ms"][key] = cuda_ms(
                lambda _, exp=exp, exp_br=exp_br: R.verify_rows_plain(rows, exp, branch, exp_br),
                behind=True)
        if n == min(D_SHAPES):  # the wrapper's host time, as the engine calls it
            spin_ms = cuda_ms(lambda _: torch.cuda._sleep(STAGING_SPIN_CYCLES))
            run, _ = R.verify_launch(rows, exp, branch, exp_br)
            calls = {"verify_rows": lambda: R.verify_rows(rows, exp, branch, exp_br, device=dev),
                     "verify_launch": lambda: R.verify_launch(rows, exp, branch, exp_br)[0](),
                     "launch": run}
            host = {}
            for name, call in calls.items():
                times = []
                for _ in range(reps + 1):
                    torch.cuda.synchronize()
                    torch.cuda._sleep(STAGING_SPIN_CYCLES)
                    t0 = time.perf_counter()
                    call()
                    times.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                host[name] = statistics.median(times[1:])
            out["host_ms_at_4096"] = host
            out["spin_ms"] = spin_ms
        del rows, branch, exp, exp_br
    emit("reduce_shapes", **out)
    return out


#: kernel A's wirec reader's flush shape: 64 workflows' last 16 events from
#: carried states (launch_shapes' 64 x 16 readers)
E_FLUSH = (64, 16)


def decode_shapes(events_np, fuzz, dev, timed) -> dict:
    """Kernel E at the shapes where the paths decode wirec bytes (kernel
    A's wirec reader's launches), through `timed` (as launched and on the
    card alone, beside its bound and the parent's E): the serving flush
    (E_FLUSH, the carried suffixes), feeder_path's chunk (CHUNK_W x E), the
    main wirec corpus (the suites' W x E), and fuzz_scale's seven-profile
    corpus (`fuzz`, as generate() makes it) packed whole, as fuzz_scale
    packs it, and each profile's workflows packed alone and tiled to the
    corpus's rows (the profiles differ in B and in their DELTA lanes).
    Each corpus is held first: E's output equal to its plain version and
    to the lanes (their padding rows as PAD_VALUES), also from a copy of
    the slab at an odd byte offset, and kernel A on E's output equal to
    A's fused wirec reader. Beside each, the card's time alone to fill a
    tensor of the output's size and to copy the output into it. Returns
    {shape: its slab's B, K and DELTA lanes, and those two times}."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as L
    from cadence_tpu_torch.gen.fuzz import PROFILES
    from cadence_tpu_torch.native import wirec as NW
    from cadence_tpu_torch.ops import replay as R, wirec as WC
    from cadence_tpu_torch.ops.encode import LANE_EVENT_ID, assemble_corpus
    from cadence_tpu_torch.ops.state import init_state

    W_all, E_all = events_np.shape[:2]
    idx = np.linspace(0, W_all - 1, E_FLUSH[0]).astype(np.int64)
    corpora = [(f"{E_FLUSH[0]}x{E_FLUSH[1]} carried",
                carried_split(events_np, idx, E_FLUSH[1])[1], 1),
               (f"{CHUNK_W}x{E_all}", events_np[:CHUNK_W], 1),
               (f"{W_all}x{E_all}", events_np, 1)]
    if fuzz:
        lanes = assemble_corpus([x for p in PROFILES for x in fuzz[p][1]])
        tag = f"{lanes.shape[0]}x{lanes.shape[1]}"
        corpora.append((f"fuzz_scale {tag}", lanes, 1))
        first = 0
        for p in PROFILES:
            n = len(fuzz[p][1])
            if lanes.shape[0] % n:
                fail(f"decode_shapes: fuzz:{p}'s {n} workflows do not tile {lanes.shape[0]}")
            corpora.append((f"fuzz:{p} {tag}", lanes[first:first + n], lanes.shape[0] // n))
            first += n
    pad = torch.tensor(WC.PAD_VALUES, dtype=torch.int64, device=dev)
    out = {}
    for key, lanes, reps in corpora:
        wc = NW.pack_wirec_auto(lanes)
        prof = wc.profile
        slab, bases, n_ev = (t.repeat((reps,) + (1,) * (t.dim() - 1))
                             for t in NW.stage_corpus(wc, dev))
        want = torch.from_numpy(np.ascontiguousarray(lanes)).to(dev).repeat(reps, 1, 1)
        want[want[:, :, LANE_EVENT_ID] == 0] = pad
        plain = WC.decode_wirec_plain(slab, bases, n_ev, prof)
        got = WC.decode_wirec(slab, bases, n_ev, prof, device=dev)
        if not torch.equal(plain, want):
            fail(f"decode_wirec {key}: the plain version differs from the lanes")
        flat = torch.empty(slab.numel() + 1, dtype=torch.uint8, device=dev)
        odd = flat[1:].view(slab.shape)
        odd.copy_(slab)
        if odd.data_ptr() % 2 != 1:
            fail(f"decode_wirec {key}: the slab copy is not at an odd address")
        if not torch.equal(WC.decode_wirec(odd, bases, n_ev, prof, device=dev), got):
            fail(f"decode_wirec {key}: the kernel differs on a slab at an odd byte offset")
        del flat, odd, want
        W = slab.shape[0]
        states_equal(R.replay_scan(init_state(W, L, dev), got),
                     R.wirec_scan(init_state(W, L, dev), slab, bases, n_ev, prof),
                     f"decode_wirec {key}: kernel A on kernel E's output against the fused reader")
        del got
        nbytes = (slab.numel() + bases.numel() * 8 + n_ev.numel() * 4
                  + plain.numel() * plain.element_size())
        timed(f"decode_wirec {key}", "decode_wirec",
              lambda slab=slab, bases=bases, n_ev=n_ev, prof=prof: kept(
                  *WC.decode_launch(slab, bases, n_ev, prof)),
              nbytes, decode_ops(prof, slab.shape[0] * slab.shape[1]), check=(plain,))
        # the card's rate for the output's bytes alone: written once, and
        # read and written once
        blank = torch.empty_like(plain)
        out[key] = {"slab_bytes_per_row": int(slab.shape[2]), "bases": int(bases.shape[1]),
                    "delta_lanes": sum(e.kind == WC.KIND_DELTA for e in prof),
                    "output_fill_device_ms": cuda_ms(lambda _: blank.fill_(7), behind=True),
                    "output_copy_device_ms": cuda_ms(lambda _: blank.copy_(plain), behind=True)}
        del slab, bases, n_ev, plain, blank
        torch.cuda.empty_cache()
    emit("decode_shapes", **out)
    return out


def burst_table(records: int, ties: int, capacity: int, seed: int):
    """({column: numpy array}, {column: kind}, intern table, valid): the
    device view's columns in visibility_path's write burst, as the view
    holds them (engine/visibility_device.py _col_order): `records` rows of
    bench.py's population in domain "bench", then `ties` rows of the ties
    domain on 16 start times, half of them closed, the first eighth with
    the Burst attribute, and the rest of the capacity invalid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, cap = records, capacity
    i = np.arange(n, dtype=np.int64)
    t = np.arange(ties, dtype=np.int64)
    base = 1_700_000_000_000_000_000
    intern = {"bench": 0, "ties": 500, "tie": 501}
    intern.update({f"wt-{k}": 1 + k for k in range(8)})
    intern.update({f"tag-{k}": 9 + k for k in range(4)})

    def col(fill, bench, tie, dtype=np.int64):
        out = np.full(cap, fill, dtype=dtype)
        out[:n], out[n:n + ties] = bench, tie
        return out

    closed = rng.random(n) < 0.5
    r = rng.random(n)
    cols = {"domain": col(-1, 0, 500), "workflow_id": col(-1, 1000 + 2 * i, 1000 + 2 * (n + t)),
            "run_id": col(-1, 1001 + 2 * i, 1001 + 2 * (n + t)),
            "workflow_type": col(-1, 1 + i % 8, 501),
            "close_status": col(0, np.where(closed, rng.integers(0, 3, n), -1),
                                np.where(t < ties // 2, t % 3, -1)),
            "start_time": col(0, base + i * 1000, base + (t % 16) * 1000),
            "close_time": col(0, np.where(closed, base + i * 1000 + 7, 0),
                              np.where(t < ties // 2, base + 10 ** 9, 0)),
            "Burst": col(np.nan, np.nan, np.where(t < ties // 8, t, np.nan), np.float64),
            "Priority": col(np.nan, np.where(r < 0.5, rng.integers(0, 10, n), np.nan), np.nan,
                            np.float64),
            "Tag": col(-1, np.where((r >= 0.5) & (r < 0.8), 9 + rng.integers(0, 4, n), -1), -1)}
    kinds = {name: ("f64" if a.dtype == np.float64 else "id") for name, a in cols.items()}
    kinds.update(close_status="i64", start_time="i64", close_time="i64")
    valid = np.zeros(cap, dtype=bool)
    valid[:n + ties] = True
    return cols, kinds, intern, valid


#: kernel J's plans in visibility_path's write burst: the Count after each
#: delete, after each close, after each upsert of the new attribute
BURST_PLANS = (("ties_domain", None), ("ties_open", "CloseStatus = -1"),
               ("ties_burst", "Burst >= 0"))
#: the view's columns before the burst's new attribute: 7 builtins,
#: Priority and Tag, and valid; after it, Burst before Priority (the view's
#: _col_order: builtins, then attributes by name)
BURST_COLUMNS = ("domain", "workflow_id", "run_id", "workflow_type", "close_status",
                 "start_time", "close_time", "Priority", "Tag")
BURST_COLUMNS_NEW = BURST_COLUMNS[:7] + ("Burst",) + BURST_COLUMNS[7:]
#: kernel L's drains through the view's feed: (B, real rows, columns); the
#: burst's one-row buckets before and after its new attribute, and a
#: backlog bucket (visibility_path's shape log: 4,096 of 64 x 10, 1,535 of
#: 64 x 11, 462 of 1,024-4,096 x 10)
FEED_SHAPES = ((64, 1, BURST_COLUMNS), (64, 1, BURST_COLUMNS_NEW), (4096, 3000, BURST_COLUMNS))


def vis_delta(g, n: int, b: int, real: int, targets, dev):
    """(idx, vals) of one delta batch of b rows into the [n] columns
    `targets`: `real` distinct rows (the first written as a negative
    index), the rest pads (index n), as the view pads a bucket."""
    import numpy as np
    import torch

    rows = g.choice(n, real, replace=False).astype(np.int64)
    rows[0] -= n
    idx_np = np.full(b, n, np.int64)
    idx_np[:real] = rows
    vals = [torch.from_numpy(g.random(b) if t.dtype == torch.float64
                             else g.random(b) < 0.5 if t.dtype == torch.bool
                             else g.integers(-5, 100, b)).to(dev, t.dtype)
            for t in targets]
    return torch.from_numpy(idx_np).to(dev), vals


def vis_shapes(dev, timed) -> None:
    """Kernels J and L at the shapes visibility_path launches them with,
    through `timed` (launch_shapes'): J over the view's 2^20-row capacity
    (524,288 records and the ties domain of 4,096) for the burst's three
    plans (count) and bench.py's six queries (bitmap); L at the burst's
    delta (a 64-row bucket holding one changed row, the view's 10 columns),
    and at 512 and 65,536 rows into 24 columns of 2^20 rows (scan_apply:
    the kernel alone); and L through the view's own feed at FEED_SHAPES
    (feed_shape: the packed block's copy and the launch)."""
    import numpy as np
    import torch

    from cadence_tpu_torch.engine.visibility_query import And, Cmp, parse_query
    from cadence_tpu_torch.ops import scan as S

    n = 2 * VIS_RECORDS
    host, kinds, intern, valid_np = burst_table(VIS_RECORDS, 4096, n, VIS_SEED)
    cols = {name: torch.from_numpy(a).to(dev) for name, a in host.items()}
    valid = torch.from_numpy(valid_np).to(dev)
    del host
    binder = VisBinder(kinds, intern)

    def plan_of(domain, q):
        scoped = Cmp("__domain__", "=", domain)
        node = parse_query(q)[0] if q else None
        return S.compile_plan(And(scoped, node) if node is not None else scoped, binder)

    def mask_shape(key, plan, bitmap: bool):
        pc = [cols[s] for s in plan.slots]
        if bitmap:
            want = S.scan_bitmap_plain(plan, pc, valid)
            make = lambda: S.scan_bitmap_launch(plan, pc, valid)  # noqa: E731
        else:
            want = (S.scan_count_plain(plan, pc, valid),)

            def make():
                run, count = S.scan_count_launch(plan, pc, valid)
                return run, (count,)
        nbytes = mask_bytes(plan, valid) + (n // 8 if bitmap else 0)
        timed(key, "vis_mask", make, nbytes, 0, check=want)

    for name, q in BURST_PLANS:
        mask_shape(f"vis_mask count {name} {n}", plan_of("ties", q), False)
    for name, q in vis_queries(VIS_RECORDS)[:6]:
        mask_shape(f"vis_mask bitmap {name} {n}", plan_of("bench", q), True)
    # L: the burst's delta into the view's columns, then 512 and 65,536 rows
    # into 24 columns of the same length
    g = np.random.default_rng(VIS_SEED + 3)
    burst = [cols[c] for c in BURST_COLUMNS] + [valid]
    wide = burst + [torch.zeros(n, dtype=torch.float64 if k % 2 else torch.int64, device=dev)
                    for k in range(24 - len(burst))]
    for key, targets, b, real in ((f"vis_apply burst 64 (1 row) x {len(burst)}", burst, 64, 1),
                                  ("vis_apply 512 x 24", wide, 512, 512 - 32),
                                  ("vis_apply 65536 x 24", wide, 65536, 65536 - 4096)):
        idx, vals = vis_delta(g, n, b, real, targets, dev)
        # the columns compared as bytes (a NaN equals itself there)
        u8 = lambda ts: tuple(t.view(torch.uint8) for t in ts)  # noqa: E731
        want = u8(S.scan_apply_plain([t.clone() for t in targets], idx, vals))

        def make(targets=targets, idx=idx, vals=vals):
            fresh = [t.clone() for t in targets]
            return kept(S.scan_apply_launch(fresh, idx, vals)[0], *u8(fresh))

        elem = sum(t.element_size() for t in targets)
        timed(key, "vis_apply", make, b * 8 + 2 * real * elem, 0, check=want)
        del want
    for b, real, names in FEED_SHAPES:
        feed_shape(g, [cols[c] for c in names] + [valid], b, real, timed)
    del cols, valid, burst, wide
    torch.cuda.empty_cache()


def feed_shape(g, targets, b: int, real: int, timed) -> None:
    """Kernel L through the view's feed, as a drain makes it: `real` changed
    rows of a host mirror of `targets` packed by pack_delta into a DeltaFeed's
    page-locked block (a b-row bucket, pads past the columns), applied by
    DeltaFeed.send to copies of the columns, and every column held byte for
    byte to scan_apply_packed_plain on the same block; then the wrapper's
    launch (the block's copy and kernel L, apply_packed_launch) timed through
    `timed`."""
    import numpy as np
    import torch

    from cadence_tpu_torch.ops import scan as S

    n, dev = targets[0].shape[0], targets[0].device
    u8 = lambda ts: tuple(t.view(torch.uint8) for t in ts)  # noqa: E731
    mirror = [t.cpu().numpy() for t in targets]
    rows = g.choice(n, real, replace=False).astype(np.int64)
    for col in mirror:  # the changed rows' new values
        col[rows] = (g.random(real) if col.dtype == np.float64 else g.random(real) < 0.5
                     if col.dtype == bool else g.integers(-5, 100, real))
    feed = S.DeltaFeed(dev)
    _, nbytes = S.apply_layout([c.itemsize for c in mirror], b)
    S.pack_delta(feed.block(nbytes), rows, mirror, b, pad=n)
    block = torch.from_numpy(feed.block(nbytes).copy())
    want = u8(S.scan_apply_packed_plain([t.clone() for t in targets], block.to(dev), b))
    sent = [t.clone() for t in targets]
    feed.send(sent, b)
    bad = sum(int((x != y).sum()) for x, y in zip(u8(sent), want))
    if bad or any(not np.array_equal(x.cpu().numpy(), m.view(np.uint8))
                  for x, m in zip(u8(sent), mirror)):
        fail(f"feed_shape {b} x {len(targets)}: DeltaFeed.send differs from "
             f"scan_apply_packed_plain ({bad} bytes) or from the host mirror")
    del sent

    def make():
        fresh = [t.clone() for t in targets]
        dev_block = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        run, _ = S.apply_packed_launch(fresh, S.apply_table(fresh), feed._host, dev_block, b)
        return kept(run, *u8(fresh))

    elem = sum(t.element_size() for t in targets)
    timed(f"vis_apply feed {b} x {len(targets)} ({real} changed)", "vis_apply", make,
          b * 8 + 2 * real * elem, 0, check=want)


#: cycles of the spin kernel vis_staging queues (about 2 ms), longer than a
#: drain's or a query's host work, so the card is busy through the call
STAGING_SPIN_CYCLES = 4_000_000


def vis_staging(dev, reps: int = REPS) -> dict:
    """The host cost of kernel J's and kernel L's feeds in the device view
    at visibility_path's capacity (2^20 rows, the view's 10 columns, 4,096
    records): one drain's _sync_device_locked after a one-row change (the
    delta staged and kernel L launched), and one scan_count of the ties
    domain read back with int(). Each is timed behind a queued spin kernel
    (`host_ms`: the host's time in the call while the card is busy, the
    count's int() after it; `device_ms`: CUDA events from before the spin
    kernel to after the call, less the spin kernel's own time) and with
    nothing queued (`alone_ms`: host clock through int() and a
    synchronise). Median of `reps` after a warm-up. Then the view's device
    columns are held to its host mirror (view_columns_equal) after those
    one-row drains (64 x 10), after a backlog drain (3,000 rows, a 4,096-row
    bucket x 10), and after a new attribute column's restage and a one-row
    drain at 64 x 11."""
    import torch

    from cadence_tpu_torch.engine.visibility_device import DeviceVisibilityView
    from cadence_tpu_torch.engine.visibility_query import And, Cmp
    from cadence_tpu_torch.ops import scan as S
    from cadence_tpu_torch.utils.metrics import MetricsRegistry

    saved = os.environ.get("CADENCE_TPU_VISIBILITY_CAPACITY")
    os.environ["CADENCE_TPU_VISIBILITY_CAPACITY"] = str(2 * VIS_RECORDS)
    try:
        view = DeviceVisibilityView(registry=MetricsRegistry(), device=dev)
    finally:
        if saved is None:
            os.environ.pop("CADENCE_TPU_VISIBILITY_CAPACITY")
        else:
            os.environ["CADENCE_TPU_VISIBILITY_CAPACITY"] = saved
    base = 1_700_000_000_000_000_000
    seq = 0

    def upsert(i, status=-1, attrs=None):
        nonlocal seq
        seq += 1
        view._apply_upsert((seq, "up", ("ties", f"tie-{i:04d}", f"tr-{i:04d}"), "tie", status,
                            base + (i % 16) * 1000, 0 if status < 0 else base + 10 ** 9,
                            attrs if attrs is not None else
                            ({"Priority": i % 10} if i % 2 else {"Tag": f"tag-{i % 4}"})))

    for i in range(4096):
        upsert(i)
    with view._lock:
        view._sync_device_locked()  # the bootstrap restage
    plan = S.compile_plan(And(Cmp("__domain__", "=", "ties"), Cmp("CloseStatus", "=", -1)),
                          view._binder())
    spin_ms = cuda_ms(lambda _: torch.cuda._sleep(STAGING_SPIN_CYCLES))
    step = iter(range(1, 10 ** 6))

    def drain():
        upsert(next(step) % 4096, status=1)  # one changed row
        with view._lock:
            view._sync_device_locked()

    def count():  # the count as a tensor; int() is taken after the host's clock
        with view._lock:
            cols, valid = view._args_locked(plan)
            return S.scan_count(plan, cols, valid)

    out = {"rows": view.capacity, "columns": len(view._col_order()) + 1, "spin_ms": spin_ms}
    for name, call in (("drain_one_row", drain), ("count_ties_open", count)):
        behind, alone = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda._sleep(STAGING_SPIN_CYCLES)
            t0 = time.perf_counter()
            got = call()
            host = (time.perf_counter() - t0) * 1e3
            b.record()
            b.synchronize()
            if got is not None:
                int(got)
            behind.append((host, a.elapsed_time(b) - spin_ms))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = call()
            if got is not None:
                int(got)
            torch.cuda.synchronize()
            alone.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"host_ms": statistics.median(h for h, _ in behind[1:]),
                     "device_ms": statistics.median(d for _, d in behind[1:]),
                     "alone_ms": statistics.median(alone[1:])}
    checked = {"one_row": view_columns_equal(view, "vis_staging after one-row drains")}
    for i in range(3000):  # a backlog: one drain of 3,000 changed rows
        upsert(i, status=2)
    with view._lock:
        view._sync_device_locked()
    checked["backlog_3000"] = view_columns_equal(view, "vis_staging after a backlog drain")
    upsert(0, attrs={"Burst": 0})  # a new attribute column: the restage
    with view._lock:
        view._sync_device_locked()
    upsert(1, attrs={"Burst": 1})  # one row into the 11 columns
    builds = view._feed.table_builds
    with view._lock:
        view._sync_device_locked()
    if view._feed.table_builds != builds + 1:
        fail("vis_staging: the drain after the new column did not rebuild the feed's table")
    checked["new_column"] = view_columns_equal(view, "vis_staging after a new column")
    out["columns_checked"] = checked
    view.stop()
    emit("vis_staging", **out)
    return out


def view_columns_equal(view, what: str) -> int:
    """Hold a device visibility view's columns and valid on the card to its
    host mirror, byte for byte, after draining what is pending; returns the
    columns compared."""
    import numpy as np

    with view._lock:
        view._drain_locked()
        pairs = [(name, view._dev_cols[name], view._host_col(name))
                 for name in view._col_order()] + [("valid", view._dev_valid, view._valid)]
        for name, dev_col, host in pairs:
            got = dev_col.cpu().numpy()
            if got.shape != host.shape or not np.array_equal(got.view(np.uint8),
                                                             host.view(np.uint8)):
                fail(f"{what}: the view's device column {name!r} differs from its host mirror")
    return len(pairs)


def rehome_shapes(chunk, bulk, batch, dev):
    """Kernel G's launches as the resident pool makes them, each as (key,
    source, source rows, out layout, destination or None, destination rows):
    the serving flush's gather of 8, 64 and 128 rows from a 64-row
    (SLAB_ROWS) and a 128-row slab (engine/resident.py _gather_locked; past
    the slab's rows the flush pads with init rows), its write-back of a
    64-row batch into slab rows (_flush_writes_locked), a slab's growth from
    64 to 128 rows (_Slab.grow), a 64-row widen with init rows and its
    narrow (the ladder's), and a verify chunk's 4,096-row gather. The slabs
    hold rows of `chunk` (base layout); `batch` is a 64-row flush's state;
    the 4,096 rows come from `bulk`. Row indices are on the card, as the
    timed launch takes them."""
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as L
    from cadence_tpu_torch.engine.resident import SLAB_ROWS
    from cadence_tpu_torch.ops.state import init_state, rehome_plain, widen_layout

    gen = torch.Generator().manual_seed(SEED)
    on = lambda rows: torch.as_tensor(rows, dtype=torch.int64).to(dev)  # noqa: E731
    perm = lambda n, k: torch.randperm(n, generator=gen)[:k]  # noqa: E731
    slabs = {r: rehome_plain(chunk, on(perm(chunk.state.shape[0], r)), L)
             for r in (SLAB_ROWS, 2 * SLAB_ROWS)}
    out = []
    for r, slab in slabs.items():
        for n in (8, 64, 128):
            rows = perm(r, min(n, r)).tolist() + [-1] * max(0, n - r)
            out.append((f"rehome gather {n} of {r}", slab, on(rows), L, None, None))
    out.append(("rehome scatter 64 into 128", batch, on(range(64)), L, slabs[2 * SLAB_ROWS],
                on(perm(2 * SLAB_ROWS, 64))))
    out.append(("rehome grow 64 to 128", slabs[SLAB_ROWS], on(range(SLAB_ROWS)), L,
                init_state(2 * SLAB_ROWS, L, dev), on(range(SLAB_ROWS))))
    L1 = widen_layout(L, 2)
    mixed = torch.arange(SLAB_ROWS)
    mixed[::7] = -1
    out.append(("rehome widen 64 with init rows", slabs[SLAB_ROWS], on(mixed), L1, None, None))
    wide = rehome_plain(slabs[SLAB_ROWS], on(range(SLAB_ROWS)), L1)
    out.append(("rehome narrow 64", wide, on(range(SLAB_ROWS)), L, None, None))
    out.append((f"rehome gather {CHUNK_W}", bulk, on(perm(bulk.state.shape[0], CHUNK_W)), L,
                None, None))
    return out


def rehome_bytes(src, rows, out_layout) -> int:
    """Kernel G's bytes: each source row's slots below both capacities read
    once (init rows read nothing), every out row written once."""
    import math

    import torch

    from cadence_tpu_torch.ops.state import init_state, leaves, layout_of

    ins = leaves(init_state(1, layout_of(src), "meta"))
    outs = leaves(init_state(1, out_layout, "meta"))
    common = sum(t.element_size() * math.prod(min(a, b) for a, b in zip(t.shape, u.shape))
                  for (_, t), (_, u) in zip(ins, outs))
    written = sum(u.element_size() * u.numel() for _, u in leaves(init_state(1, out_layout,
                                                                             "meta")))
    rows = torch.as_tensor(rows)
    return int((rows >= 0).sum()) * common + rows.numel() * written


def rehome_staging(events_np, slab_src, dev, reps: int = REPS) -> dict:
    """One rehome() call at a 64-row flush with its rows as a host list,
    behind a queued kernel A (`events_np` replayed from a fresh state: the
    bulk, about a millisecond): the host's milliseconds in the call, and the device's
    from before kernel A to after kernel G (CUDA events). `pageable` stages
    the rows as a copy from pageable memory, as ops/rehome.py did before
    its staging went through page-locked memory; `rehome` is the call as
    the port makes it; `rehome_alone` the same call with nothing queued.
    Median of `reps` after a warm-up each."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as L
    from cadence_tpu_torch.engine.resident import SLAB_ROWS
    from cadence_tpu_torch.ops import rehome as RH, replay as R
    from cadence_tpu_torch.ops.state import init_state, map_state

    ev = torch.from_numpy(events_np).to(dev)
    rows = list(range(0, 2 * SLAB_ROWS, 2))
    rows_np = np.asarray(rows, dtype=np.int64)
    slab = map_state(lambda t: t[:2 * SLAB_ROWS].clone(), slab_src)
    stages = {  # name: (the call, behind kernel A)
        "pageable": (lambda: RH.rehome_launch(slab, torch.from_numpy(rows_np).to(dev), L)[0](),
                     True),
        "rehome": (lambda: RH.rehome(slab, rows, L), True),
        "rehome_alone": (lambda: RH.rehome(slab, rows, L), False),
    }
    def kernel_a():
        s = init_state(ev.shape[0], L, dev)
        run = R.replay_launch(s, ev)
        run.keep = s  # the state its pointers point into
        return run

    out = {}
    for name, (stage, behind) in stages.items():
        runs = []
        for _ in range(reps + 1):
            a_run = kernel_a()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            if behind:
                a_run()
            t0 = time.perf_counter()
            stage()
            host = (time.perf_counter() - t0) * 1e3
            b.record()
            b.synchronize()
            runs.append((host, a.elapsed_time(b)))
        out[name] = {"host_ms": statistics.median(h for h, _ in runs[1:]),
                     "device_ms": statistics.median(d for _, d in runs[1:])}
    out["kernel_a_ms"] = cuda_ms(lambda go: go(), setup=kernel_a)
    del ev, a_run
    emit("rehome_staging", rows=len(rows), behind="kernel A at the bulk", **out)
    return out


#: variants of this tree's kernels, built by text substitution and timed
#: beside the port's in kernel_launch_shapes: name -> (the sources built,
#: ((file, old, new), ...)): kernel A's staged route without its lanes
#: loaded an event ahead, with the wirec reader's register cap on every
#: reader, and with blocks of 64 workflows; kernel B with blocks of 16
#: workflows, and of 128 threads; kernel G with four units a thread (a
#: quarter of the blocks, each thread's four loads ahead of its stores),
#: and with whole rows moved an element a unit (no 16-byte units); kernel I
#: with tiles of 8 and of 16 steps, with 256 threads a block (seven warps
#: that draw and store), and with its step's update in a switch on the
#: action (each case act_all at a constant action, the branches the
#: generator reader takes); kernel A's generator reader with act_all run
#: once at the step's action before its switch on the replay's effects;
#: kernel J with 2 and 8 rows a lane in a tile (J_ROWS; the port's is 4),
#: and with 2 and 4 leaves' loads issued ahead (J_AHEAD; the port's is 1);
#: kernel C with each row split among 1, 2, 4 and 8 lanes at every W
#: (C_SPLIT; the port's 0 picks from W).
#: Built and timed with --variants (all, or the names given)
A_SOURCES = ("replay.cu", "replay_tasks.cu", "replay_global.cu")
#: the actions whose update act_all makes (csrc/genkernel.cuh; A_SIGNAL and
#: A_WFCLOSE change nothing)
GEN_ACTIONS = ("A_STARTED", "A_DSCHED", "A_DSTART", "A_DCOMPLETE", "A_ASCHED", "A_ASTART",
               "A_ACLOSE", "A_TSTART", "A_TFIRE", "A_CINIT", "A_CSTART", "A_CCLOSE")
VARIANTS = {
    "no_prefetch": (A_SOURCES, (("replay_kernel.cuh", "constexpr bool PREFETCH_LANES = true;",
                                 "constexpr bool PREFETCH_LANES = false;"),)),
    "bounds_all_readers": (A_SOURCES, (("replay_kernel.cuh",
                                        "READER == READ_WIREC ? Tables::MIN_BLOCKS : 1",
                                        "Tables::MIN_BLOCKS"),)),
    "block64": (A_SOURCES, (("replay_tables.cuh", "constexpr int STAGED_WF = 32;",
                             "constexpr int STAGED_WF = 64;"),)),
    "payload_wf16": (("payload.cu",), (("payload.cu", "constexpr int PAYLOAD_MAX_WF = 32;",
                                        "constexpr int PAYLOAD_MAX_WF = 16;"),)),
    "payload_threads128": (("payload.cu",), (("payload.cu",
                                              "constexpr int PAYLOAD_THREADS = 256;",
                                              "constexpr int PAYLOAD_THREADS = 128;"),)),
    "rehome_items4": (("rehome.cu",), (("rehome.cu", "constexpr int G_ITEMS = 1;",
                                        "constexpr int G_ITEMS = 4;"),)),
    "rehome_element_units": (("rehome.cu",), (("rehome.cu",
                                               "for (int ub = 16; ub > size; ub >>= 1)",
                                               "for (int ub = size; ub > size; ub >>= 1)"),)),
    "lanes_tile8": (("genkernel.cu",), (("genkernel.cu", "constexpr int LANES_TILE = 4;",
                                         "constexpr int LANES_TILE = 8;"),)),
    "lanes_tile16": (("genkernel.cu",), (("genkernel.cu", "constexpr int LANES_TILE = 4;",
                                          "constexpr int LANES_TILE = 16;"),)),
    "lanes_threads256": (("genkernel.cu",), (("genkernel.cu",
                                              "constexpr int LANES_THREADS = 128;",
                                              "constexpr int LANES_THREADS = 256;"),)),
    "switch_step": (("genkernel.cu",), (("genkernel.cuh", "  act_all(g, d, eid, code, a);\n",
                                         "  switch (code) {\n" + "".join(
                                             f"    case {c}: act_all(g, d, eid, {c}, a); break;\n"
                                             for c in GEN_ACTIONS)
                                         + "    default: break;\n  }\n"),)),
    "j_rows2": (("scan.cu",), (("scan.cu", "constexpr int J_ROWS = 4;",
                                "constexpr int J_ROWS = 2;"),)),
    "j_rows8": (("scan.cu",), (("scan.cu", "constexpr int J_ROWS = 4;",
                                "constexpr int J_ROWS = 8;"),)),
    "j_ahead2": (("scan.cu",), (("scan.cu", "constexpr int J_AHEAD = 1;",
                                 "constexpr int J_AHEAD = 2;"),)),
    "j_ahead4": (("scan.cu",), (("scan.cu", "constexpr int J_AHEAD = 1;",
                                 "constexpr int J_AHEAD = 4;"),)),
    **{f"crc_split{n}": (("crc32.cu",), (("crc32.cu", "constexpr int C_SPLIT = 0;",
                                          f"constexpr int C_SPLIT = {n};"),))
       for n in (1, 2, 4, 8)},
    "gen_act_all_once": (("replay_gen.cu",), (
        ("replay_gen.cuh", "    switch (code) {\n",
         "    gen::act_all(g, d, ev_id, code, a);\n    switch (code) {\n"),
        *(("replay_gen.cuh", f"        gen::act_all(g, d, ev_id, gen::{c}, a);\n", "")
          for c in GEN_ACTIONS))),
    **{f"e_stages{n}": (("wirec.cu",), (("wirec.cu", "constexpr int E_STAGES = 3;",
                                         f"constexpr int E_STAGES = {n};"),))
       for n in (2, 4)},
    "e_warps4": (("wirec.cu",), (("wirec.cu", "constexpr int E_WARPS = 8;",
                                  "constexpr int E_WARPS = 4;"),
                                 ("wirec.cu", "constexpr int E_BLOCKS_PER_SM = 4;",
                                  "constexpr int E_BLOCKS_PER_SM = 8;"))),
    # a persistent grid of one wave (E_BLOCKS_PER_SM blocks an SM), each warp
    # decoding the workflows warp, warp + warps, ... in turn
    "e_one_wave": (("wirec.cu",), (
        ("wirec.cu", "  decode_warp(a, p, e_smem + warp * warp_bytes(a.B, a.K), "
                     "int64_t(blockIdx.x) * E_WARPS + warp,\n",
         "  for (int64_t w = int64_t(blockIdx.x) * E_WARPS + warp; w < a.W;\n"
         "       w += int64_t(gridDim.x) * E_WARPS)\n"
         "    decode_warp(a, p, e_smem + warp * warp_bytes(a.B, a.K), w,\n"),
        ("wirec.cu", "  decode_wirec_kernel<<<static_cast<unsigned>(grid_blocks(W)),",
         "  int sms = 0;\n"
         "  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != "
         "cudaSuccess)\n    return static_cast<int>(rc);\n"
         "  const int64_t wave = int64_t(sms) * E_BLOCKS_PER_SM;\n"
         "  decode_wirec_kernel<<<static_cast<unsigned>(grid_blocks(W) < wave ? grid_blocks(W) "
         ": wave),"))),
    # each lane stores its own row's 16-byte pairs to device memory, 144 B
    # from its neighbour's, with no tile in shared memory
    "e_direct_stores": (("wirec.cu",), (
        ("wirec.cu", "      *reinterpret_cast<longlong2*>(tile + size_t(lane) * E_ROW_BYTES "
                     "+ 8 * (j - 1)) =\n          make_longlong2(lo, v);",
         "      __stcs(reinterpret_cast<longlong2*>(a.out + (c.w * a.E + c.r0 + lane) * "
         "WIREC_LANES + (j - 1)), make_longlong2(lo, v));"),
        ("wirec.cu", "    store_chunk(a, c, tile, lane);\n", ""))),
}
#: kernel A's instances, by reader, tasks and route (mangled-name parts
#: for ptxas_usage)
A_INSTANCES = {f"{reader}{'_tasks' if t else ''} {route}": (
    f"replay_kernelILi{r}ELb{t}E", policy, *extra)
    for reader, r, tasks in (("int64", 0, (0, 1)), ("wire32", 1, (0, 1)), ("wirec", 2, (0,)))
    for t in tasks
    for route, policy, extra in (("staged", "ChipTables", ("RegBranches",)),
                                 ("staged_shared", "ChipTables", ("SharedBranches",)),
                                 ("global", "GlobalTables", ()))}


def a_ptxas(build_log: str) -> dict:
    """Registers and spills of every instance of kernel A in a build log."""
    return {name: ptxas_usage(build_log, *parts) for name, parts in A_INSTANCES.items()}


def jl_ptxas(build_log: str) -> dict:
    """Registers and spills of kernels J (its by-value and table instances)
    and L in a build log."""
    return {"vis_mask": ptxas_usage(build_log, "vis_mask_kernel", "ValuePlan"),
            "vis_mask_table": ptxas_usage(build_log, "vis_mask_kernel", "TablePlan"),
            "vis_apply": ptxas_usage(build_log, "vis_apply_kernel")}


def cd_ptxas(build_log: str) -> dict:
    """Registers and spills of kernels C (each instance) and D in a build
    log."""
    out = {"verify_rows": ptxas_usage(build_log, "verify_kernel")}
    for p in (1, 2, 4, 8):
        found = ptxas_usage(build_log, f"crc32_kernelILi{p}E")
        if found:
            out[f"crc32 lanes{p}"] = found
    if not any(k.startswith("crc32") for k in out):
        out["crc32"] = ptxas_usage(build_log, "crc32_kernel")
    return out


def gen_ptxas(build_log: str) -> dict:
    """Registers and spills of kernel A's generator reader in a build log,
    at 1 and 2 threads a workflow."""
    return {f"tpw{t}": ptxas_usage(build_log, f"replay_gen_kernelILi{t}E") for t in (1, 2)}


def launch_shapes_phase(args, events_np, dev, fuzz=None) -> dict:
    """Build the parent commit's kernels A, B, E, G and I (with --parent) and
    this tree's VARIANTS (with --variants), run launch_shapes, emit its
    record and return it (attach_launch_shapes adds its times to the
    kernels' records)."""
    from cadence_tpu_torch.ops import _build

    from concurrent.futures import ThreadPoolExecutor

    builds = []  # (name, kernel directory, sources, substitutions)
    if args.parent:  # kernel A's (and its generator reader's), B's, G's and I's files
        csrc = os.path.join(args.parent, "cadence_tpu_torch", "csrc")
        builds.append(("parent", csrc, [f for f in sorted(os.listdir(csrc)) if f in SHAPE_SOURCES
                                        or (f.startswith("replay") and f.endswith(".cu"))], ()))
    if args.variants:
        names = list(VARIANTS) if args.variants == "all" else args.variants.split(",")
        builds += [(name, _build._CSRC, list(VARIANTS[name][0]), VARIANTS[name][1])
                   for name in names]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(1, len(builds))) as pool:
        built = list(pool.map(lambda b: build_entries(b[1], b[2], b[3]), builds))
    libs = [(b[0], lib) for b, (lib, _) in zip(builds, built)]
    if args.parent:
        _PARENT_LIBS["scan"] = libs[0][1]  # kernel_vis times the parent's J, K and L with it
    ptxas = {b[0]: {line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line}
             for b, (_, log) in zip(builds, built)}
    t_build = time.perf_counter() - t0
    out = launch_shapes(events_np, dev, args.ns_events, libs, fuzz)
    emit("kernel_launch_shapes", floor_ms=out["floor_ms"], floor_device_ms=out["floor_device_ms"],
         built=[b[0] for b in builds],
         build_seconds=t_build, ptxas={n: sorted(v) for n, v in ptxas.items()},
         ptxas_kernel_a=a_ptxas(_build.build_log),
         ptxas_kernel_b=ptxas_usage(_build.build_log, "payload_kernel"),
         ptxas_kernel_g=ptxas_usage(_build.build_log, "rehome_kernel"),
         ptxas_kernel_i=ptxas_usage(_build.build_log, "gen_lanes_kernel"),
         ptxas_replay_gen=gen_ptxas(_build.build_log),
         ptxas_kernels_j_l=jl_ptxas(_build.build_log),
         ptxas_kernels_c_d=cd_ptxas(_build.build_log),
         ptxas_kernel_e=ptxas_usage(_build.build_log, "decode_wirec_kernel"),
         ptxas_parent_e={b[0]: ptxas_usage(log, "decode_wirec_kernel")
                         for b, (_, log) in zip(builds, built) if b[0] == "parent"},
         ptxas_parent_j_l={b[0]: jl_ptxas(log) for b, (_, log) in zip(builds, built)
                           if b[0] == "parent"},
         ptxas_variants={b[0]: {**a_ptxas(log), "rehome": ptxas_usage(log, "rehome_kernel"),
                                "gen_lanes": ptxas_usage(log, "gen_lanes_kernel"),
                                "replay_gen": gen_ptxas(log), **jl_ptxas(log),
                                **cd_ptxas(log),
                                "decode_wirec": ptxas_usage(log, "decode_wirec_kernel")}
                         for b, (_, log) in zip(builds, built) if b[0] != "parent"},
         ptxas_parent_c_d={b[0]: cd_ptxas(log) for b, (_, log) in zip(builds, built)
                           if b[0] == "parent"})
    return out


def attach_launch_shapes(records, out) -> None:
    """Add kernel_launch_shapes' times, bounds and floor to the records of
    the kernels it timed."""
    for rec in records:
        mine = {k: v for k, v in out["shapes"].items() if v["kernel"] == rec["name"]}
        if mine:
            rec["ms_at_launch_shapes"] = {k: v["ms"] for k, v in mine.items()}
            rec["device_ms_at_launch_shapes"] = {k: v["device_ms"] for k, v in mine.items()}
            rec["bound_ms_at_launch_shapes"] = {k: v["bound_ms"] for k, v in mine.items()}
            rec["launch_floor_ms"] = out["floor_ms"]
            rec["launch_floor_device_ms"] = out["floor_device_ms"]
        if rec["name"] == "rehome":
            rec["staging_behind_kernel_a"] = out["rehome_staging"]
        if rec["name"] in ("vis_mask", "vis_apply"):
            rec["feeds_behind_a_spin_kernel"] = out["vis_staging"]
        if rec["name"] in SHAPE_KERNELS:
            rec["launch_shapes_by_path"] = {path: got[rec["name"]]
                                            for path, got in SHAPES_BY_PATH.items()
                                            if got[rec["name"]]}
        if rec["name"] == "payload":
            rec["epilogue_launch_shapes_by_path"] = {
                k: {path: got[k] for path, got in SHAPES_BY_PATH.items() if got[k]}
                for k in ("payload_fit", "payload_counts")}
        if rec["name"] == "verify_rows":
            rec.update(out["reduce_shapes"])


#: trap_corpus's rows (a multiple of its six kinds) and events, and the
#: layouts its states are held at: the base, rung 1, rung 2 (K = 64 for
#: activities and timers, the mask's edge; B = 8 in shared memory) and x8
#: (the global route)
TRAP_W, TRAP_E = 6 * 64, 24
TRAP_FACTORS = (1, 2, 4, 8)


def replay_traps(dev) -> dict:
    """Phase kernel_replay_traps: kernel A (int64, wire32 and wirec readers,
    with tasks on int64 and wire32 lanes) and kernel B (at the state's own
    layout and projected to the base one) held to their plain versions on
    trap_corpus's carried states at each of TRAP_FACTORS, and on random lanes
    from a fresh state at x8 (phase 4 runs them at x1 and x2); each layout's
    launches must all take the route replay_route gives it."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT
    from cadence_tpu_torch.gen.lanes import random_lanes, trap_corpus
    from cadence_tpu_torch.native import wirec as NW
    from cadence_tpu_torch.ops import _build, replay as R
    from cadence_tpu_torch.ops.convert import state_from_numpy
    from cadence_tpu_torch.ops.encode import to_wire32
    from cadence_tpu_torch.ops.payload import payload_rows_narrow, payload_rows_narrow_plain
    from cadence_tpu_torch.ops.state import init_state, map_state, widen_layout
    from cadence_tpu_torch.ops.taskgen import init_task_log

    clone = lambda s: map_state(lambda t: t.clone(), s)  # noqa: E731
    out = {}
    for factor in TRAP_FACTORS:
        lay = widen_layout(DEFAULT_LAYOUT, factor)
        st, ln = trap_corpus(TRAP_W, TRAP_E, SEED + factor, lay)
        cases = {"traps": (state_from_numpy(st, dev), ln)}
        if factor == 8:  # the paths the suites never reach, on the global route
            lanes = random_lanes(512, 48, SEED + factor)
            cases["random lanes"] = (init_state(len(lanes), lay, dev), lanes)
        torch.cuda.synchronize()
        _build.reset_launches()
        overflow = 0
        for what, (s0, ln) in cases.items():
            tag = f"{what} at x{factor}"
            ev = torch.from_numpy(ln).to(dev)
            want = R.replay_scan_plain(s0, ev)
            got = R.replay_scan(clone(s0), ev)
            states_equal(got, want, f"replay {tag}")
            try:
                ev32 = torch.from_numpy(to_wire32(ln)).to(dev)
            except OverflowError:  # the random lanes' timers wrap int32
                ev32 = None
            if ev32 is not None:
                states_equal(R.replay_scan(clone(s0), ev32, wire32=True), want,
                             f"replay wire32 {tag}")
            wc = NW.pack_wirec_auto(ln)
            parts = NW.stage_corpus(wc, dev)
            states_equal(R.wirec_scan(clone(s0), *parts, wc.profile),
                         R.wirec_scan_plain(s0, *parts, wc.profile), f"replay wirec {tag}")
            for lanes_, wire32 in ((ev, False), (ev32, True)):
                if lanes_ is None:
                    continue
                W = ev.shape[0]
                ks, kl = R.replay_tasks_scan(clone(s0), init_task_log(W, 32, 32, dev), lanes_,
                                             wire32)
                ps, pl = R.replay_tasks_scan_plain(s0, init_task_log(W, 32, 32, dev), lanes_,
                                                   wire32)
                states_equal(ks, ps, f"replay with tasks {tag} (wire32 {wire32})")
                logs_equal(kl, pl, f"replay with tasks {tag} (wire32 {wire32})")
            for out_lay in (lay, DEFAULT_LAYOUT):
                rk, ok = payload_rows_narrow(got, out_lay)
                rp, op, fp, cp = payload_rows_narrow_plain(got, out_lay, fit=True, counts=True)
                both = payload_rows_narrow(got, out_lay, fit=True, counts=True)
                if any(max_abs_err(x, y) for x, y in zip((rk, ok) + both,
                                                         (rp, op, rp, op, fp, cp))):
                    fail(f"payload {tag} to width {out_lay.width}: kernel and plain version "
                         "differ")
                overflow += int(op.sum())
            out[tag] = {"errors": np.bincount(want.error.cpu().numpy(), minlength=15).tolist()}
        launches = dict(_build.launches)
        route = R.replay_route(lay)
        names = ("replay", "replay_tasks", "replay_wirec")
        took = [R.launch_name(n, lay) for n in names]
        other = [n for n in launches if n.startswith("replay") and n not in took
                 and n != "replay_gen"]
        if any(launches[n] == 0 for n in took) or any(launches[n] for n in other):
            fail(f"traps at x{factor}: the launches {launches} are not all on the {route} "
                 "route")
        if factor > 1 and not overflow:
            fail(f"traps at x{factor}: no row overflows the base payload")
        out[f"x{factor}"] = {"route": route, "block": R.staged_block(lay),
                             "launches": {n: launches[n] for n in took + ["payload"]},
                             "base_overflow_rows": overflow}
    emit("kernel_replay_traps", workflows=TRAP_W, events=TRAP_E, **out)
    return out


def payload_bytes_ops(W: int, L, state=None, fit: bool = False, counts: bool = False):
    """Kernel B's bound at W workflows of a state at layout `state` (L's
    by default) projected to layout L: the scalars, the current branch's
    version-history row, each table's occupancy and IDs read once, the
    rows and flags written once; 3 K^2 compares a table. With `fit`, the
    other branches' version-history counts read and the fit flags
    written (its occupancy is read already); with `counts`, the error and
    close status read and the [2] counts written."""
    state = state or L
    kv = L.max_version_history_items
    tables = (state.max_timers, state.max_activities, state.max_children, state.max_signals,
              state.max_request_cancels)
    nbytes = W * (10 * 8 + 4 + 1 + 4 + 4 + 2 * kv * 8 + sum(9 * k for k in tables)
                  + L.width * 8 + 1)
    if fit:
        nbytes += W * (4 * (state.max_branches - 1) + 1)
    if counts:
        nbytes += W * 8 + 16
    return nbytes, W * sum(3 * k * k for k in tables)


def north_star(args, corp, dev):
    """Phase north_star, configuration ns-1m: bench.py's _north_star on the
    card. Workflows rounded up to whole chunks, each chunk generated,
    replayed, reduced to payload rows and hashed on the card through
    generate_and_replay_sharded_crc over a mesh of one card (one code path),
    at each chunk size of args.ns_chunks. Dispatch is depth 2: a chunk's
    CRCs and errors are queued to page-locked memory right behind its
    launches, the next chunk is launched, and only then does the host wait,
    for that copy alone. Then bench.py's parity leg: kernel I makes the
    sampled workflows' lanes, the oracle replays them, and their CRCs must
    equal the first chunk's. Then the host generator's corpus through
    kernels A and B. Returns the launch counts of three driven paths: the
    timed chunk loops (north_star), the parity leg (north_star_parity) and
    the host generator's replay (host_generator)."""
    import multiprocessing as mp
    from collections import Counter

    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import crc32_of_rows
    from cadence_tpu_torch.engine.executor import queue_to_host
    from cadence_tpu_torch.native.gen_native import generate_corpus_native
    from cadence_tpu_torch.ops import _build, genkernel as G, replay as R
    from cadence_tpu_torch.ops.state import init_state
    from cadence_tpu_torch.parallel.mesh import Mesh

    E = args.ns_events
    mesh = Mesh([dev])
    row_bytes = state_bytes(init_state(1, device=dev))
    launches = Counter()  # the timed chunk loops' launches, summed over the chunk sizes
    shapes = Counter()  # and by shape
    runs, firsts = [], []
    for chunk in args.ns_chunks:
        chunk = min(chunk, args.ns_workflows)
        n_chunks = -(-args.ns_workflows // chunk)

        def run(lo):
            return queue_to_host(G.generate_and_replay_sharded_crc(SEED, lo, chunk, E, mesh), dev)

        t0 = time.perf_counter()
        G.generate_and_replay_sharded_crc(SEED + 1, 0, chunk, E, mesh)[0].cpu()
        warm_s = time.perf_counter() - t0
        rates, errors_total, crc_xor = [], 0, 0
        _build.reset_launches()
        t_start = t_prev = time.perf_counter()
        in_flight = run(0)
        for ci in range(n_chunks):
            (crc, errors), done = in_flight
            if ci + 1 < n_chunks:  # depth 2: the next chunk is queued before this one is awaited
                in_flight = run((ci + 1) * chunk)
            done.synchronize()
            crc_np = crc.numpy().astype(np.uint32)
            err_np = errors.numpy()
            now = time.perf_counter()
            rates.append(chunk * E / (now - t_prev))
            t_prev = now
            errors_total += int((err_np != 0).sum())
            crc_xor ^= int(np.bitwise_xor.reduce(crc_np))
            if ci == 0:
                firsts.append(crc_np)
        wall = time.perf_counter() - t_start
        launches.update(_build.launches)
        shapes.update(_build.launch_shapes)
        if errors_total:
            fail(f"north_star at chunk {chunk}: {errors_total} error workflows")
        if not np.array_equal(firsts[-1][:len(firsts[0])], firsts[0][:len(firsts[-1])]):
            fail("north_star: the chunk sizes disagree on the first workflows")
        runs.append({"chunk_workflows": chunk, "chunks": n_chunks, "workflows": n_chunks * chunk,
                     "real_events": n_chunks * chunk * E, "wall_s": wall,
                     "events_per_s": n_chunks * chunk * E / wall,
                     "chunk_rate_min": min(rates), "chunk_rate_median": statistics.median(rates),
                     "chunk_rate_max": max(rates), "warm_s": warm_s,
                     "error_workflows": errors_total, "crc_xor": crc_xor,
                     "state_bytes": chunk * row_bytes})
    launches = dict(launches)
    check_launches(launches, "north_star", NORTH_STAR_KERNELS, shapes)

    # bench.py's parity leg: kernel I makes the sampled workflows' lanes on
    # the card (the fused path never holds them), the oracle replays them in
    # a pool of workers, and their CRCs must equal the first chunk's
    torch.cuda.synchronize()
    _build.reset_launches()
    blocks = [(start, G.generate_lanes(SEED, start, len(lanes), E, dev).cpu().numpy())
              for start, lanes in corp["ns_blocks"]]
    parity_launches = dict(_build.launches)
    check_launches(parity_launches, "north_star_parity", NORTH_STAR_PARITY_KERNELS)
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(min(len(blocks), os.cpu_count())) as pool:
        block_rows = pool.map(_closed_rows, [lanes for _, lanes in blocks], chunksize=1)
    t_oracle = time.perf_counter() - t0
    want = {start + i: row for (start, _), rows in zip(blocks, block_rows)
            for i, row in enumerate(rows)}
    unclosed = [i for i, row in want.items() if row is None]
    want_crc = {i: np.uint32(crc32_of_rows(row[None])[0]) for i, row in want.items()
                if row is not None}
    for run_, first in zip(runs, firsts):
        run_["parity_samples"] = len(want)
        run_["parity_failures"] = len(unclosed) + sum(1 for i, c in want_crc.items()
                                                      if first[i] != c)
        if run_["parity_failures"]:
            fail(f"north_star at chunk {run_['chunk_workflows']}: {run_['parity_failures']} "
                 f"parity failures against the oracle ({len(unclosed)} histories not closed)")

    # the first chunk on a mesh of two slices of the card, and unsharded
    c0 = min(args.ns_chunks)
    one = G.generate_and_replay_sharded_crc(SEED, 0, c0, E, mesh)
    two = G.generate_and_replay_sharded_crc(SEED, 0, c0, E, Mesh([dev] * 2))
    flat = G.generate_and_replay_crc(SEED, 0, c0, E, device=dev)
    if not all(torch.equal(a, b) for a, b in zip(one, two)) or \
            not all(torch.equal(a, b) for a, b in zip(one, flat)):
        fail("north_star: the mesh of two slices or the unsharded call differs from the mesh of 1")

    # the host generator (native/generator.cc) through kernels A and B
    t0 = time.perf_counter()
    lanes, total = generate_corpus_native(SEED, 0, NATIVE_GEN_W, E)
    t_gen = time.perf_counter() - t0
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rows, errors = R.replay_to_payload(lanes, device=dev)
    rows, errors = rows.cpu().numpy(), errors.cpu().numpy()
    t_replay = time.perf_counter() - t0
    host_launches = dict(_build.launches)
    check_launches(host_launches, "host_generator", HOST_GENERATOR_KERNELS)
    nat = corp["native_oracle"]
    bad = [i for i, row in nat.items() if row is None or not np.array_equal(rows[i], row)]
    if (errors != 0).any() or bad:
        fail(f"north_star: the host generator's corpus has {int((errors != 0).sum())} error "
             f"rows and {len(bad)} sampled rows that differ from the oracle")
    emit("north_star", config="ns-1m" if args.ns_workflows == NS_WORKFLOWS else "ns-small",
         requested_workflows=args.ns_workflows, max_events=E, seed=SEED, runs=runs,
         mesh2_and_unsharded_equal=True,
         parity_leg={"samples": len(want), "oracle_s": t_oracle, "launches": parity_launches},
         host_generator={"workflows": NATIVE_GEN_W, "events": total, "generate_s": t_gen,
                         "generate_events_per_s": total / t_gen, "replay_s": t_replay,
                         "error_workflows": 0, "oracle_sampled": len(nat),
                         "oracle_equal": len(nat), "launches": host_launches},
         launches=launches)
    return launches, parity_launches, host_launches


def feeder_path(corp, dev, rows, crcs, errors, real):
    """Phase feeder_path: the suites corpus's wire bytes through the three
    feeders at 4,096 workflows a chunk. Returns the launch counts."""
    import numpy as np
    import torch

    from cadence_tpu_torch.native import feeder as F
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.utils import metrics as M

    from cadence_tpu_torch.ops.encode import history_length

    blobs = corp["blobs"]
    E = max(history_length(h) for h in corp["histories"])
    torch.cuda.synchronize()
    _build.reset_launches()
    out = {}
    for name, fn in (("feed_serialized", F.feed_serialized),
                     ("feed_serialized32", F.feed_serialized32),
                     ("feed_serialized_wirec", F.feed_serialized_wirec)):
        M.DEFAULT_REGISTRY.reset()
        first, errs, rep = fn(blobs, E, chunk_workflows=4096, device=dev)
        if name == "feed_serialized":
            if not np.array_equal(first, rows):
                fail("feeder_path: feed_serialized's rows differ from replay_corpus's")
        elif not np.array_equal(first, crcs):
            fail(f"feeder_path: {name}'s CRCs differ from the int64 path's")
        if not np.array_equal(errs, errors):
            fail(f"feeder_path: {name}'s errors differ from replay_corpus's")
        if rep.events != real:
            fail(f"feeder_path: {name} counted {rep.events} events, not {real}")
        if name == "feed_serialized_wirec" and not rep.native_wirec:
            fail("feeder_path: the native wirec encoder did not serve")
        h2d = rep.h2d_s or M.DEFAULT_REGISTRY.histogram(M.SCOPE_TPU_REPLAY, M.M_PROFILE_H2D).total
        out[name] = {"chunks": rep.chunks, "events": rep.events, "wall_s": rep.wall_s,
                     "events_per_s": rep.events_per_sec, "pack_s": rep.pack_s,
                     "pack_queue_wait_s": rep.pack_queue_wait_s, "h2d_s": h2d,
                     "depth": rep.depth, "native_wirec": rep.native_wirec,
                     "profile_refits": rep.profile_refits, "wire_bytes": rep.wire_bytes}
    launches = dict(_build.launches)
    check_launches(launches, "feeder_path", FEEDER_PATH_KERNELS)
    emit("feeder_path", workflows=len(blobs), max_events=E, real_events=real,
         blob_bytes=sum(len(b) for b in blobs), feeds=out, launches=launches)
    return launches


def fuzz_parity(corp, dev):
    """Phase fuzz_parity: (a) the port's gen/fuzz.parity_run on the card at
    its defaults, its document held to the run of record; (b) each
    `fuzz:<profile>` corpus through replay_corpus and, packed as wirec,
    replay_wirec_to_crc, the CRCs equal, the sampled rows the oracle's.
    Returns the launch counts of (a) and (b)."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import crc32_of_rows
    from cadence_tpu_torch.gen import fuzz as FZ
    from cadence_tpu_torch.native import wirec as NW
    from cadence_tpu_torch.ops import _build, replay as R
    from cadence_tpu_torch.ops.encode import LANE_EVENT_ID, assemble_corpus
    from cadence_tpu_torch.utils.metrics import MetricsRegistry

    # (a) parity_run: dense, wirec, verify_all and the NDC tree replay
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    doc = FZ.parity_run(device=DEVICE)
    t_run = time.perf_counter() - t0
    run_launches = dict(_build.launches)
    check_launches(run_launches, "fuzz_parity (a)", FUZZ_PARITY_KERNELS)
    bad = {k: doc[k] for k in ("dense_divergent", "wirec_divergent", "device_errors",
                               "verify_divergent", "verify_fallback", "ndc_divergent")
           if doc[k] != 0}
    if not doc["ok"] or bad or doc["missing_decisions"]:
        fail(f"fuzz_parity (a): parity_run ok={doc['ok']}, {bad}, missing "
             f"{doc['missing_decisions']}")
    got = {k: doc[k] for k in FUZZ_RUN}
    if got != FUZZ_RUN or doc["decision_coverage"] != FUZZ_DECISIONS:
        fail(f"fuzz_parity (a): {got} and coverage {doc['decision_coverage']}, not the run of "
             f"record's {FUZZ_RUN}")
    if doc["verify_total"] != FUZZ_RUN["workflows"]:
        fail(f"fuzz_parity (a): verify_all saw {doc['verify_total']} workflows")

    # (b) the grammar at the main path's scale
    reg = MetricsRegistry()
    hs = [h for p in FZ.PROFILES for h in corp["fuzz"][p][0]]
    lanes = assemble_corpus([x for p in FZ.PROFILES for x in corp["fuzz"][p][1]])
    real = int((lanes[:, :, LANE_EVENT_ID] > 0).sum())
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rows, crcs, errors = R.replay_corpus(hs, device=DEVICE)
    t_int64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    wc = NW.pack_wirec_auto(lanes, registry=reg)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    crc_c, err_c = R.replay_wirec_to_crc(*NW.stage_corpus(wc, dev), wc.profile, device=DEVICE)
    crc_c, err_c = crc_c.cpu().numpy().astype(np.uint32), err_c.cpu().numpy()
    t_wirec = time.perf_counter() - t0
    scale_launches = dict(_build.launches)
    check_launches(scale_launches, "fuzz_parity (b)", FUZZ_SCALE_KERNELS)
    if rows.shape[0] != len(hs) or (errors != 0).any():
        fail(f"fuzz_parity (b): {int((errors != 0).sum())} rows with errors "
             f"{np.unique(errors).tolist()}")
    if not np.array_equal(crc_c, crcs) or not np.array_equal(err_c, errors):
        fail(f"fuzz_parity (b): {int((crc_c != crcs).sum())} wirec CRCs differ from the int64 "
             "path's")
    per_profile, base = {}, 0
    for p in FZ.PROFILES:
        n = len(corp["fuzz"][p][0])
        sample = {i: v for (q, i), v in corp["fuzz_oracle"].items() if q == p}
        diff = [i for i, v in sample.items()
                if v is None or not np.array_equal(rows[base + i], v[0])
                or crcs[base + i] != crc32_of_rows(v[0][None])[0]]
        if diff:
            fail(f"fuzz_parity (b): {len(diff)} sampled fuzz:{p} rows differ from the oracle, "
                 f"first {diff[:5]}")
        per_profile[p] = {"workflows": n, "oracle_sampled": len(sample),
                          "events": int((lanes[base:base + n, :, LANE_EVENT_ID] > 0).sum())}
        base += n
    emit("fuzz_parity",
         run={**{k: doc[k] for k in ("workflows", "events", "event_kinds", "ndc_forked",
                                     "verify_total", "verify_resident", "verify_escalated",
                                     "dense_divergent", "wirec_divergent", "device_errors",
                                     "verify_divergent", "ndc_divergent", "ok")},
              "decisions_covered": len(doc["decision_coverage"]) - len(doc["missing_decisions"]),
              "seconds": t_run, "launches": run_launches},
         scale={"workflows": len(hs), "max_events": int(lanes.shape[1]), "real_events": real,
                "profiles": per_profile, "replay_corpus_s": t_int64,
                "int64_events_per_s": real / t_int64, "wirec_pack_s": t_pack,
                "wirec_stage_and_replay_s": t_wirec, "wirec_events_per_s": real / t_wirec,
                "wirec_with_pack_events_per_s": real / (t_pack + t_wirec),
                "bytes_per_event": wc.bytes_per_event(), "crcs_equal": len(hs),
                "launches": scale_launches})
    return run_launches, scale_launches


def migration_path(corp):
    """Phase migration_path: host 1's engine warmed through verify_all,
    half of MIG_SHARDS migrated out through the shared snapshot store, 1-3
    batches appended to half of the moved open keys, then
    MigrationManager.hydrate_shards on host 2's engine. Returns the launch
    counts of the hydration."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
    from cadence_tpu_torch.core.enums import WorkflowState
    from cadence_tpu_torch.engine.migration import MigrationManager
    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.utils import metrics as M

    work = corp["migration"]
    t0 = time.perf_counter()
    stores = Stores()
    keys, live = [], {}
    for h, cut, at_cut, _after in work:
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h[:cut]:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(at_cut)
        keys.append(key)
        live[key] = at_cut
    t_stores = time.perf_counter() - t0
    host1 = TPUReplayEngine(stores, chunk_workflows=4096, device=DEVICE)
    host1.metrics = M.MetricsRegistry()
    t0 = time.perf_counter()
    res = host1.verify_all()
    t_warm = time.perf_counter() - t0
    if not res.ok or len(host1.resident) != len(keys):
        fail(f"migration_path: host 1's verify_all ok={res.ok}, {len(host1.resident)} of "
             f"{len(keys)} keys resident")
    mgr1 = MigrationManager("host-1", MIG_SHARDS, host1)
    moved = list(range(0, MIG_SHARDS, 2))
    t0 = time.perf_counter()
    out = mgr1.migrate_out(moved)
    t_out = time.perf_counter() - t0
    in_moved = [k for k in keys if mgr1.shard_of(k) in moved]
    if out.considered != len(in_moved) or out.snapshotted != len(in_moved) or out.skipped:
        fail(f"migration_path: migrate_out {out}, {len(in_moved)} keys in the moved shards")
    left = [k for k in keys if (host1.resident.entry_for(k) is not None) != (k not in in_moved)]
    if left:
        fail(f"migration_path: {len(left)} keys resident on the wrong side of the move")
    # commits land between the move and the steal: half of the moved open keys
    appended, suffix_events, moving = set(), 0, set(in_moved)
    for i, ((h, cut, _at_cut, after), key) in enumerate(zip(work, keys)):
        if after is None or key not in moving or i % 2:
            continue
        for b in h[cut:]:
            stores.history.append_batch(*key, list(b.events))
            suffix_events += len(b.events)
        stores.execution.upsert_workflow(after)
        live[key] = after
        appended.add(key)
    closed = {k for k in in_moved
              if int(live[k].execution_info.state) == int(WorkflowState.Completed)}
    host2 = TPUReplayEngine(stores, chunk_workflows=4096, device=DEVICE)
    reg = M.MetricsRegistry()
    M.preregister_migration(reg)
    host2.metrics = reg
    mgr2 = MigrationManager("host-2", MIG_SHARDS, host2, registry=reg)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rep = mgr2.hydrate_shards(moved)
    torch.cuda.synchronize()
    t_in = time.perf_counter() - t0
    launches = dict(_build.launches)
    check_launches(launches, "migration_path", MIGRATION_PATH_KERNELS)
    open_moved = len(in_moved) - len(closed)
    if (rep.considered != len(in_moved) or rep.skipped_closed != len(closed)
            or rep.hydrated != open_moved or rep.cold or rep.young or rep.stale
            or rep.already_resident or rep.parity_divergence or rep.parity_skipped_unstable):
        fail(f"migration_path: hydrate_shards {rep}; {len(in_moved)} moved keys, "
             f"{len(closed)} closed")
    if rep.suffix_events != suffix_events:
        fail(f"migration_path: {rep.suffix_events} suffix events replayed, not the "
             f"{suffix_events} appended")
    bad = []
    for key in in_moved:
        entry = host2.resident.entry_for(key)
        if key in closed:
            if entry is not None:
                bad.append(key)
            continue
        row = payload_row(live[key])
        row[STICKY_ROW_INDEX] = 0
        if (entry is None or not np.array_equal(np.asarray(entry.payload), row)
                or entry.branch != live[key].version_histories.current_index):
            bad.append(key)
    if bad:
        fail(f"migration_path: {len(bad)} hydrated rows differ from the oracle's, first {bad[:3]}")
    emit("migration_path", workflows=len(keys), shards=MIG_SHARDS, moved_shards=moved,
         moved_keys=len(in_moved), closed_skipped=rep.skipped_closed, hydrated=rep.hydrated,
         cold=rep.cold, suffix_keys=len(appended), suffix_events=rep.suffix_events,
         rows_equal_oracle=open_moved, migrate_out={"snapshotted": out.snapshotted,
                                                    "evicted": out.evicted, "seconds": t_out},
         stores_s=t_stores, warm_verify_s=t_warm, hydrate_s=t_in,
         hydrate_workflows_per_s=rep.hydrated / t_in, stats=mgr2.stats(),
         resident_pool=pool_stats(host2.resident), launches=launches)
    return launches


def replication_apply(corp):
    """Phase replication_apply: an active Stores publishing every batch of
    REPL_WORKFLOWS open workflows; a standby Stores whose
    ReplicationTaskProcessor has the port's engine (tpu=...). The first
    half of each history drains (host apply; the device counts the keys
    cold), verify_all warms the standby's pool, REPL_SHIPPED keys' snapshots
    ship from the active's snapshotter, and the rest drains: the device
    applies every open key as a suffix. Then the kill-switch leg. Returns
    the launch counts of the second drain."""
    import numpy as np
    import torch

    from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
    from cadence_tpu_torch.engine import replication as RP
    from cadence_tpu_torch.engine.cache import batch_crc
    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.rebuild import DeviceRebuilder
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.oracle.mutable_state import VersionHistory
    from cadence_tpu_torch.utils import metrics as M

    def publish(pub, active, work, part, vh):
        """Commit the first half (part 0) or the rest of each history on the
        active side, each batch published with its branch's version history."""
        n = 0
        for h, half, _at_half, _final in work:
            key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
            branch = vh.setdefault(key, VersionHistory())
            for b in (h[:half] if part == 0 else h[half:]):
                active.history.append_batch(*key, list(b.events))
                for e in b.events:
                    branch.add_or_update_item(e.id, e.version)
                pub.publish(*key, list(b.events),
                            tuple((i.event_id, i.version) for i in branch.items))
                n += 1
        return n

    def drain(proc):
        """One pass over the backlog: the per-domain bound lifted (every
        workflow shares one domain), so the touched keys reach the device
        apply as one group."""
        proc.domain_budget = 0
        return proc.process_once(batch_size=proc.source.stores.queue.size(RP.REPLICATION_QUEUE))

    def run(work, shipped: int):
        active, standby = Stores(), Stores()
        pub = RP.ReplicationPublisher(active)
        reg = M.MetricsRegistry()
        M.preregister_replication(reg)
        tpu = TPUReplayEngine(standby, chunk_workflows=4096, device=DEVICE)
        tpu.metrics = reg
        proc = RP.ReplicationTaskProcessor(
            RP.HistoryReplicator(standby, rebuilder=DeviceRebuilder(device=DEVICE)), pub,
            standby, tpu=tpu)
        proc.metrics = reg
        vh, legs = {}, {}
        t0 = time.perf_counter()
        n1 = publish(pub, active, work, 0, vh)
        for _h, _half, at_half, _final in work:
            active.execution.upsert_workflow(at_half)
        legs["publish_1_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if drain(proc) != n1:
            fail("replication_apply: the first drain left tasks behind")
        legs["drain_1_s"] = time.perf_counter() - t0
        keys = [(h[0].domain_id, h[0].workflow_id, h[0].run_id) for h, *_ in work]
        ship, warm = keys[:shipped], keys[shipped:]
        t0 = time.perf_counter()
        res = tpu.verify_all(warm)
        legs["warm_verify_s"] = time.perf_counter() - t0
        if not res.ok or len(tpu.resident) != len(warm):
            fail(f"replication_apply: the standby's verify_all ok={res.ok}, "
                 f"{len(tpu.resident)} of {len(warm)} keys resident")
        t0 = time.perf_counter()
        if ship:  # the active's snapshot writer ships every record it writes
            source = TPUReplayEngine(active, chunk_workflows=4096, device=DEVICE)
            source.snapshotter().shipper = lambda rec: pub.publish_snapshot(rec, "active")
            if not source.verify_all(ship).ok:
                fail("replication_apply: the active's verify_all of the shipped keys diverged")
            written = sum(source.snapshotter().snapshot_key(k, force=True) for k in ship)
            if written != len(ship):
                fail(f"replication_apply: {written} of {len(ship)} snapshots written")
        legs["ship_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n2 = publish(pub, active, work, 1, vh)
        for _h, _half, _at_half, final in work:
            active.execution.upsert_workflow(final)
        legs["publish_2_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        if drain(proc) != n2 + len(ship):
            fail("replication_apply: the second drain left tasks behind")
        torch.cuda.synchronize()
        legs["drain_2_s"] = time.perf_counter() - t0
        launches = dict(_build.launches)
        # the standby equals the active: histories (batch count, last batch)
        # and live states
        bad = []
        for key in keys:
            a_ms, s_ms = active.execution.get_workflow(*key), standby.execution.get_workflow(*key)
            ra, rs = payload_row(a_ms), payload_row(s_ms)
            ra[STICKY_ROW_INDEX] = rs[STICKY_ROW_INDEX] = 0
            ab, sb_ = active.history.batch_count(*key), standby.history.batch_count(*key)
            if (not np.array_equal(ra, rs) or ab != sb_
                    or a_ms.execution_info.next_event_id != s_ms.execution_info.next_event_id
                    or batch_crc(active.history.as_history_batches_range(*key, ab - 1)[0])
                    != batch_crc(standby.history.as_history_batches_range(*key, sb_ - 1)[0])):
                bad.append(key)
        if bad:
            fail(f"replication_apply: {len(bad)} standby states differ from the active's, "
                 f"first {bad[:3]}")
        return keys, tpu, proc, reg, launches, legs, n1 + n2

    work = corp["replication"]
    keys, tpu, proc, reg, launches, legs, tasks = run(work, REPL_SHIPPED)
    check_launches(launches, "replication_apply", REPLICATION_APPLY_KERNELS)
    snap = reg.snapshot().get(M.SCOPE_REPLICATION, {})
    finished = snap.get(M.M_REPL_DEVICE_APPLIED, 0)
    # every key is open: each finished on the device in the second drain
    # (cold in the first, when the standby's pool was empty)
    if (finished != len(keys) or snap.get(M.M_REPL_DEVICE_DIVERGENCE, 0)
            or snap.get(M.M_REPL_DEVICE_UNSTABLE, 0) or snap.get(M.M_REPL_DEVICE_STALE, 0)
            or snap.get(M.M_REPL_SNAP_INSTALLED, 0) != REPL_SHIPPED
            or proc.snapshots_installed != REPL_SHIPPED
            or snap.get(M.M_REPL_DEVICE_COLD, 0) != len(keys)):
        fail(f"replication_apply: device apply counters {snap}")
    bad = []
    for (h, _half, _at_half, final), key in zip(work, keys):
        entry = tpu.resident.entry_for(key)
        row = payload_row(final)
        row[STICKY_ROW_INDEX] = 0
        if entry is None or not np.array_equal(np.asarray(entry.payload), row):
            bad.append(key)
    if bad:
        fail(f"replication_apply: {len(bad)} resident rows differ from the oracle's")
    # the kill switch: the same drain, no device work
    os.environ[RP.ENABLE_DEVICE_ENV] = "0"
    try:
        k_keys, k_tpu, _k_proc, k_reg, k_launches, k_legs, k_tasks = run(
            work[:REPL_KILL_SWITCH], 0)
    finally:
        del os.environ[RP.ENABLE_DEVICE_ENV]
    k_snap = k_reg.snapshot().get(M.SCOPE_REPLICATION, {})
    if any(k_launches.values()) or any(k_snap.get(n, 0) for n in (
            M.M_REPL_DEVICE_APPLIED, M.M_REPL_DEVICE_COLD, M.M_REPL_DEVICE_SUFFIX_EVENTS)):
        fail(f"replication_apply: with {RP.ENABLE_DEVICE_ENV}=0 the drain launched "
             f"{ {k: n for k, n in k_launches.items() if n} } ({k_snap})")
    emit("replication_apply", workflows=len(keys), events_a_history=REPL_EVENTS, tasks=tasks,
         shipped=REPL_SHIPPED, finished=finished,
         cold=snap.get(M.M_REPL_DEVICE_COLD, 0),
         invalidated=reg.counter(M.SCOPE_TPU_RESIDENT, M.M_CACHE_INVALIDATIONS),
         suffix_events=snap.get(M.M_REPL_DEVICE_SUFFIX_EVENTS, 0),
         snapshots_installed=proc.snapshots_installed, standby_equal_active=len(keys),
         resident_rows_equal_oracle=len(keys), legs=legs,
         drain_2_workflows_per_s=len(keys) / legs["drain_2_s"],
         counters=snap, resident_pool=pool_stats(tpu.resident), launches=launches,
         kill_switch={"workflows": len(k_keys), "tasks": k_tasks, "launches": 0,
                      "legs": k_legs, "resident": len(k_tpu.resident)})
    return launches


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--small", action="store_true",
                   help="run every phase at a few thousand workflows")
    p.add_argument("--parent", metavar="DIR",
                   help="the root of a checkout of another commit whose entry points have this "
                        "tree's signatures: its kernels A, B, C, D, E, G, I, A's generator "
                        "reader, J and L are built and timed beside this tree's in "
                        "kernel_launch_shapes, and J, K and L in kernel_vis")
    p.add_argument("--variants", nargs="?", const="all", metavar="NAME,...",
                   help="build VARIANTS of this tree's kernels (all, or the names given) and "
                        "time them beside the port's in kernel_launch_shapes")
    p.add_argument("--shapes-only", action="store_true",
                   help="run the suites corpus, the build and kernel_launch_shapes, and stop")
    p.add_argument("--visibility-only", action="store_true",
                   help="run the build, kernel_vis, vis_staging and visibility_path, and stop")
    p.add_argument("--new-phases-only", action="store_true",
                   help="run the build, fuzz_parity, migration_path and replication_apply, "
                        "and stop")
    args = p.parse_args()
    full = not args.small
    config = "suites-8k" if full else "small"
    args.per_suite = 8192 if full else 512
    args.overflow = 16384 if full else 512
    args.chains = 2048 if full else 128
    args.trees = 4096 if full else 256
    args.lanes_w = 65536 if full else 2048
    args.verify_per_suite = 2048 if full else 128
    args.serving_per_suite = 1024 if full else 64
    args.lanes_e = 128
    args.ns_workflows = NS_WORKFLOWS if full else GEN_CHECK_W
    args.ns_events = NS_EVENTS if full else 200
    args.ns_chunks = NS_CHUNKS
    args.gen_plain_w = 4096
    args.vis_rows = VIS_ROWS if full else 1 << 16
    args.vis_records = VIS_RECORDS if full else 16384
    args.fuzz_per_profile = FUZZ_PER_PROFILE if full else 256
    args.mig_workflows = MIG_WORKFLOWS if full else 512
    args.repl_workflows = REPL_WORKFLOWS if full else 512

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from cadence_tpu_torch import device as D
    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT, crc32_of_rows
    from cadence_tpu_torch.engine.executor import replay_corpus_mesh, stream_wirec_mesh
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
    from cadence_tpu_torch.ops import rehome as RH
    from cadence_tpu_torch.ops.state import (CAPACITY_ERRORS, init_state, leaves, narrow_ok_plain,
                                             rehome_plain, widen_layout, widen_state)
    from cadence_tpu_torch.ops.stats import stats, stats_launch, stats_plain
    from cadence_tpu_torch.ops.streaming import replay_streamed
    from cadence_tpu_torch.ops.taskgen import init_task_log
    from cadence_tpu_torch.parallel.mesh import Mesh, replay_sharded_crc
    from cadence_tpu_torch.utils.metrics import M_NATIVE_PACKS, SCOPE_TPU_NATIVE, MetricsRegistry

    t_start = time.perf_counter()
    if not args.visibility_only:  # host corpora first, in a pool of spawned workers
        corp = generate(args)
        histories, oracle = corp["histories"], corp["oracle"]
        emit("generate", workflows=len(histories), overflow=len(corp["overflow"]),
             chains=int(corp["chains"].shape[0]), trees=int(corp["trees"].shape[0]),
             fuzz=sum(len(v[0]) for v in corp["fuzz"].values()),
             migration=len(corp["migration"]), replication=len(corp["replication"]),
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
    if args.shapes_only:
        launch_shapes_phase(args, encode_corpus(histories), dev, corp["fuzz"])
        replay_traps(dev)
        print(smi)
        return 0
    if args.visibility_only:
        kernel_vis(args, dev, [])
        vis_staging(dev)
        visibility_path(args)
        print(smi)
        return 0
    if args.new_phases_only:
        fuzz_launches, scale_launches = fuzz_parity(corp, dev)
        new_paths = {"fuzz_parity": fuzz_launches, "fuzz_scale": scale_launches,
                     "migration_path": migration_path(corp),
                     "replication_apply": replication_apply(corp)}
        print(json.dumps({"launches": new_paths}))
        print(smi)
        return 0

    # --- 2. the main path (suites-8k)
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
    # the same lanes through the path's other entry points
    t1 = time.perf_counter()
    st_rows, st_err = replay_streamed(events_np, 32, device=DEVICE)
    if not np.array_equal(st_rows, rows) or not np.array_equal(st_err, errors):
        fail("main path: StreamingReplayer in chunks of 32 differs from the one-shot replay")
    plain_counts = stats_plain(s32.error, s32.close_status).cpu().numpy()
    sharded_stats = {}
    for n in (1, 2):
        crc_m, err_m, st_m = replay_sharded_crc(wire_np, Mesh([dev] * n))
        if (not torch.equal(crc_m, crc_w) or not torch.equal(err_m, err_w)
                or not np.array_equal(st_m.numpy(), plain_counts)):
            fail(f"main path: replay_sharded_crc on a mesh of {n} differs from replay_to_crc32 "
                 f"or the plain counts ({st_m.tolist()} against {plain_counts.tolist()})")
        sharded_stats[n] = st_m.tolist()
    m_rows, m_err, _, m_report = replay_corpus_mesh(events_np, chunk_workflows=4096)
    if not np.array_equal(m_rows, rows) or not np.array_equal(m_err, errors):
        fail("main path: replay_corpus_mesh differs from replay_corpus")
    del st_rows, m_rows, crc_m
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t1
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
         wire32_and_verify_s=t_wire, streamed_sharded_and_mesh_s=t_entry,
         streamed_chunk_events=32, sharded_stats=sharded_stats,
         corpus_mesh_chunks=m_report.chunks, launches=main_launches,
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
    t1 = time.perf_counter()
    crc_sw, err_sw, sw_report = stream_wirec_mesh(wc, n_chunks=4)
    t_stream = time.perf_counter() - t1
    wirec_launches = dict(_build.launches)
    if not np.array_equal(crc_c, crcs) or not np.array_equal(err_c, errors):
        fail("wirec_path: CRCs or errors differ from the int64 path")
    if not np.array_equal(crc_sw, crc_c) or not np.array_equal(err_sw, err_c):
        fail("wirec_path: stream_wirec_mesh differs from replay_wirec_to_crc")
    check_launches(wirec_launches, "wirec_path", WIREC_PATH_KERNELS)
    h2d = {fmt: h2d_ms(NW, arrays, dev) for fmt, arrays in (
        ("int64", [events_np]), ("wire32", [wire_np]),
        ("wirec", [wc.slab, wc.bases, wc.n_events]))}
    emit("wirec_path", native_packer=reg.counter(SCOPE_TPU_NATIVE, M_NATIVE_PACKS) == 1,
         pack_s=t_pack, stage_and_replay_s=t_wirec, stream_wirec_mesh_s=t_stream,
         stream_wirec_mesh_chunks=sw_report.chunks, wirec_bytes=wc.wire_bytes,
         bytes_per_event=wc.bytes_per_event(), lanes_bytes_per_event=events_np.nbytes / real,
         wire32_bytes_per_event=wire_np.nbytes / real, slab_bytes_per_row=int(wc.slab.shape[2]),
         h2d_ms=h2d, launches=wirec_launches)

    # --- feeder_path: the same histories' wire bytes through the pipelined feeders
    feeder_launches = feeder_path(corp, dev, rows, crcs, errors, real)

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
        "replay", "cadence_tpu_torch/csrc/replay_kernel.cuh", "cadence_tpu/ops/transitions.py:154",
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
    regs = ptxas_usage(_build.build_log, *A_INSTANCES["int64_tasks staged"])
    records.append(kernel_record(
        "replay_tasks", "cadence_tpu_torch/csrc/replay_kernel.cuh", "cadence_tpu/ops/taskgen.py:221",
        None, err_t, ms_t, ms_tp, ev.numel() * 8 + sb + t_bytes, replay_ops(ev) + t_ops,
        hook="cadence_tpu_torch/csrc/taskgen.cuh", no_tasks_ms=ms_a,
        init_task_log_ms=ms_fill, init_task_log_bound_ms=log_bytes / HBM_BYTES_PER_S * 1e3,
        transfer_entries=int(log_t.tr_count.sum()), timer_entries=int(log_t.tm_count.sum()),
        ptxas=regs, ptxas_no_tasks=ptxas_usage(_build.build_log, *A_INSTANCES["int64 staged"]),
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
    # its epilogues: the counts on the final state, the fit on the widened
    # one (kernel_narrow_ok holds the fit on unfit rows too)
    err_b = max(err_b, *(max_abs_err(x, y) for x, y in zip(
        payload_rows_narrow(s_k, DEFAULT_LAYOUT, fit=True, counts=True),
        payload_rows_narrow_plain(s_k, DEFAULT_LAYOUT, fit=True, counts=True))))
    err_b = max(err_b, *(max_abs_err(x, y) for x, y in zip(
        payload_rows_narrow(wide, DEFAULT_LAYOUT, fit=True, counts=True),
        payload_rows_narrow_plain(wide, DEFAULT_LAYOUT, fit=True, counts=True))))
    if err_b:
        fail(f"payload kernel differs from its plain version (max abs err {err_b})")
    ms_b = cuda_ms(launch, setup=lambda: payload_launch(s_k, DEFAULT_LAYOUT)[0], inner=20)
    ms_b_counts = cuda_ms(launch, inner=20,
                          setup=lambda: payload_launch(s_k, DEFAULT_LAYOUT, counts=True)[0])
    ms_b_both = cuda_ms(launch, inner=20, setup=lambda: payload_launch(
        s_k, DEFAULT_LAYOUT, fit=True, counts=True)[0])
    ms_bp = cuda_ms(lambda _: payload_rows_narrow_plain(s_k, DEFAULT_LAYOUT))
    masked = [torch.where(t.occ, ids, torch.full_like(ids, 1 << 62)) for t, ids in (
        (s_k.timers, s_k.timers.started_id), (s_k.activities, s_k.activities.schedule_id),
        (s_k.children, s_k.children.initiated_id), (s_k.signals, s_k.signals.initiated_id),
        (s_k.cancels, s_k.cancels.initiated_id))]
    ms_sort = cuda_ms(lambda _: [torch.sort(m, dim=1) for m in masked], inner=20)
    L = DEFAULT_LAYOUT
    records.append(kernel_record(
        "payload", "cadence_tpu_torch/csrc/payload.cu", "cadence_tpu/ops/payload.py:36",
        None, err_b, ms_b, ms_bp, *payload_bytes_ops(W, L),
        yardstick="torch.sort of the five masked ID tables", yardstick_ms=ms_sort,
        ms_with_counts=ms_b_counts, ms_with_fit_and_counts=ms_b_both,
        ptxas=ptxas_usage(_build.build_log, "payload_kernel"),
        also_replaces=["cadence_tpu/ops/state.py:305 (fit epilogue)",
                       "cadence_tpu/parallel/mesh.py:104 (counts epilogue)"]))
    emit("kernel_payload", max_abs_err=err_b, ms=ms_b, plain_ms=ms_bp, torch_sort_ms=ms_sort,
         ms_with_counts=ms_b_counts, ms_with_fit_and_counts=ms_b_both)

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
    # F: a shard's stats, against the plain version; the yardstick is
    # torch.count_nonzero of each of the two tensors
    error_t, close_t = s_k.error, s_k.close_status
    f_k = stats(error_t, close_t)
    f_p = stats_plain(error_t, close_t)
    err_f = max(max_abs_err(f_k, f_p),
                max_abs_err(payload_rows_narrow(s_k, DEFAULT_LAYOUT, counts=True)[2], f_p))
    if err_f or int(f_p[1]) == 0:
        fail(f"stats kernel differs from its plain version ({f_k.tolist()} against {f_p.tolist()})")
    ms_f = cuda_ms(launch, setup=lambda: stats_launch(error_t, close_t)[0], inner=20)
    ms_fp = cuda_ms(lambda _: stats_plain(error_t, close_t), inner=20)
    ms_fl = cuda_ms(lambda _: (torch.count_nonzero(error_t), torch.count_nonzero(close_t)),
                    inner=20)
    records.append(kernel_record(
        "stats", "cadence_tpu_torch/csrc/stats.cu", "cadence_tpu/parallel/mesh.py:104",
        None, err_f, ms_f, ms_fp, W * 8 + 16, 4 * W, library_ms=ms_fl,
        library="torch.count_nonzero of each tensor",
        paths_take_it_from="kernel B's counts epilogue (launches: payload_counts)"))
    emit("kernel_stats", max_abs_err=err_f, counts=f_k.tolist(), ms=ms_f, plain_ms=ms_fp,
         count_nonzero_ms=ms_fl)
    # G: re-homing state rows at the resident pool's widths: a 4,096-row
    # base-layout gather (a verify chunk's admit, an append group's gather),
    # a scatter into a destination, a widen with init rows, a narrow;
    # every state tensor against the plain version. The yardstick is one
    # index_select per state tensor (66 calls, not one).
    n_g = min(4096, W)
    g_rows = torch.randperm(W, generator=g)[:n_g].to(dev)
    L1 = widen_layout(DEFAULT_LAYOUT, 2)
    got_g = RH.rehome(s_k, g_rows, DEFAULT_LAYOUT)
    want_g = rehome_plain(s_k, g_rows, DEFAULT_LAYOUT)
    states_equal(got_g, want_g, "rehome gather")
    err_g = max(max_abs_err(x, y) for (_, x), (_, y) in zip(leaves(got_g), leaves(want_g)))
    mixed = g_rows.clone()
    mixed[::7] = -1
    w_k = RH.rehome(s_k, mixed, L1)
    states_equal(w_k, rehome_plain(s_k, mixed, L1), "rehome widen with init rows")
    states_equal(RH.rehome(w_k, torch.arange(n_g, device=dev), DEFAULT_LAYOUT),
                 rehome_plain(w_k, torch.arange(n_g, device=dev), DEFAULT_LAYOUT),
                 "rehome narrow")
    slots = torch.randperm(2 * n_g, generator=g)[:n_g].to(dev)
    dst_k, dst_p = init_state(2 * n_g, L1, dev), init_state(2 * n_g, L1, dev)
    RH.rehome(s_k, mixed, L1, dst_k, slots)
    rehome_plain(s_k, mixed, L1, dst_p, slots)
    states_equal(dst_k, dst_p, "rehome scatter")
    del dst_k, dst_p, want_g
    ms_g = cuda_ms(launch, setup=lambda: RH.rehome_launch(s_k, g_rows, DEFAULT_LAYOUT)[0],
                   inner=20)
    ms_gp = cuda_ms(lambda _: rehome_plain(s_k, g_rows, DEFAULT_LAYOUT))
    ms_gl = cuda_ms(lambda _: [t.index_select(0, g_rows) for _, t in leaves(s_k)], inner=20)
    row_bytes = state_bytes(got_g) // n_g
    records.append(kernel_record(
        "rehome", "cadence_tpu_torch/csrc/rehome.cu", "cadence_tpu/ops/state.py:283",
        None, err_g, ms_g, ms_gp, 2 * n_g * row_bytes, 0,
        also_replaces=["cadence_tpu/ops/state.py:328", "cadence_tpu/engine/resident.py:694",
                       "cadence_tpu/engine/resident.py:710", "cadence_tpu/engine/ladder.py:341",
                       "cadence_tpu/engine/ladder.py:370"],
        rows=n_g, row_bytes=row_bytes, yardstick="index_select of each of the 66 state tensors",
        yardstick_ms=ms_gl, ptxas=ptxas_usage(_build.build_log, "rehome_kernel")))
    emit("kernel_rehome", max_abs_err=err_g, rows=n_g, ms=ms_g, plain_ms=ms_gp,
         index_select_ms=ms_gl, checked=["gather", "widen with init rows", "narrow", "scatter"])
    # H: narrow_ok on a widened state, some rows made unfit on every rule
    h_s = RH.rehome(s_k, g_rows, L1)
    h_s.activities.occ[::5, L.max_activities + 3] = True
    h_s.timers.occ[1::7, L.max_timers] = True
    h_s.signals.occ[2::11, -1] = True
    h_s.vh_count[3::13, L.max_branches] = 1
    h_s.vh_count[4::17, 0] = L.max_version_history_items + 1
    h_s.current_branch[5::19] = L.max_branches
    h_k = RH.narrow_ok(h_s, DEFAULT_LAYOUT)
    h_p = narrow_ok_plain(h_s, DEFAULT_LAYOUT)
    err_h = max(max_abs_err(h_k, h_p),
                max_abs_err(payload_rows_narrow(h_s, DEFAULT_LAYOUT, fit=True)[2], h_p))
    if err_h or h_p.all() or not h_p.any():
        fail(f"narrow_ok kernel differs from its plain version ({err_h} rows)")
    ms_h = cuda_ms(launch, setup=lambda: RH.narrow_ok_launch(h_s, DEFAULT_LAYOUT)[0], inner=20)
    ms_hp = cuda_ms(lambda _: narrow_ok_plain(h_s, DEFAULT_LAYOUT), inner=5)
    past = sum(getattr(L1, f) - getattr(L, f) for f in (
        "max_activities", "max_timers", "max_children", "max_request_cancels", "max_signals"))
    h_bytes = n_g * (4 + 4 * L1.max_branches + past + 1)
    records.append(kernel_record(
        "narrow_ok", "cadence_tpu_torch/csrc/rehome.cu", "cadence_tpu/ops/state.py:305",
        None, err_h, ms_h, ms_hp, h_bytes, n_g * (2 * L1.max_branches + past + 2),
        rows=n_g, fit=int(h_p.sum()),
        paths_take_it_from="kernel B's fit epilogue (launches: payload_fit)"))
    emit("kernel_narrow_ok", max_abs_err=err_h, rows=n_g, fit=int(h_p.sum()), ms=ms_h,
         plain_ms=ms_hp)
    del got_g, w_k, h_s
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
        "replay_wirec", "cadence_tpu_torch/csrc/replay_kernel.cuh", "cadence_tpu/ops/replay.py:121",
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
        on_main_path=False, ptxas=ptxas_usage(_build.build_log, "decode_wirec_kernel"),
        library="none: no PyTorch call decodes wirec"))
    emit("kernel_decode_wirec", max_abs_err=err_e, equal_to_lanes=True, ms=ms_e, plain_ms=ms_ep)
    del s_k, s_p, s_k32, s_kw, wide, ev, ev32, d_k, slab_d, bases_d, n_d
    torch.cuda.empty_cache()

    # kernels A and B at the shapes their launches have, and on their traps
    shapes_out = launch_shapes_phase(args, events_np, dev, corp["fuzz"])
    replay_traps(dev)

    # kernel I and kernel A's generator reader
    gen_kernels(args, corp, dev, records,
                shapes_out["gen_lanes_max_abs_err"][f"gen_lanes {GEN_CHECK_W}x{args.ns_events}"])

    # --- north_star (ns-1m): the device generator fused into kernel A
    ns_launches, parity_launches, host_gen_launches = north_star(args, corp, dev)

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
    if not torch.equal(stats(k.error, k.close_status), stats_plain(k.error, k.close_status)):
        fail("random lanes: stats kernel differs from its plain version")
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
    check_launches(ladder_launches, "fallback_ladder", LADDER_PATH_KERNELS)
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
    rung_bound = bound_ms(rung_bytes, rung_ops)
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
         rung1_bound_by="bytes" if rung_bytes / HBM_BYTES_PER_S >= rung_ops / int_ops_per_s()
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
    del jobs

    # --- 7. verify_path: the engine's bulk verify over Stores
    verify_launches, verify_ctx = verify_path(args, corp, rebuilt, cap[resolved], residual)
    del rebuilt

    # --- 8. resident_path: the resident tier and snapshots over the same histories
    resident_launches = resident_path(args, corp, verify_ctx)
    del verify_ctx

    # --- 9. serving_path: the serving scheduler under eight submitter threads
    serving_launches = serving_path(args, corp)

    # --- 9b. fuzz_parity: the fuzz grammar's parity run and its corpora at scale
    fuzz_launches, scale_launches = fuzz_parity(corp, dev)
    del corp["fuzz"]

    # --- 9c. migration_path: shard migration between two hosts' engines
    migration_launches = migration_path(corp)

    # --- 9d. replication_apply: the standby's device apply behind its pump
    replication_launches = replication_apply(corp)

    # --- 10. kernel_vis: kernels J, K and L on the columnar table
    kernel_vis(args, dev, records)

    # --- 11. visibility_path: Stores.visibility served from the card
    visibility_launches = visibility_path(args)

    # --- the summary lines
    attach_launch_shapes(records, shapes_out)
    paths = {"main_path": main_launches, "wirec_path": wirec_launches,
             "feeder_path": feeder_launches, "north_star": ns_launches,
             "north_star_parity": parity_launches, "host_generator": host_gen_launches,
             "fallback_ladder": ladder_launches, "rebuild_path": rebuild_launches,
             "verify_path": verify_launches, "resident_path": resident_launches,
             "serving_path": serving_launches, "fuzz_parity": fuzz_launches,
             "fuzz_scale": scale_launches, "migration_path": migration_launches,
             "replication_apply": replication_launches, "visibility_path": visibility_launches}
    for rec in records:
        rec["launches"] = sum(p[rec["name"]] for p in paths.values())
        if rec["name"] == "payload":
            rec["epilogue_launches"] = {e: sum(p[e] for p in paths.values())
                                        for e in ("payload_fit", "payload_counts")}
    emit("launch_shapes_by_path", **SHAPES_BY_PATH)
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
