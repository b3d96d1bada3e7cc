"""The device corpus generator: distinct histories born where they replay.

The north star is 1M histories of 1k events each. Made on the host and
shipped, their 144 GB of lanes would make the host link the benchmark, so
each event is generated on the device inside the loop that replays it: a
per-workflow workflow simulator on a counter-based splitmix64 stream,
reproducible from (seed, workflow index, step), emits one engine-shaped
event per workflow per step (decision cycles, activity chains, timers,
children, signals; every entity resolves before the close, and every
history ends with WorkflowExecutionCompleted), and the replay applies it
at once. The corpus never exists as a tensor; the host pulls 4 bytes a
workflow.

On the card:
- `generate_lanes` is kernel I (csrc/genkernel.cu), which materialises the
  same lanes for samples and the oracle's cross-checks;
- `generate_and_replay` and `generate_and_replay_crc` are kernel A's
  generator reader (csrc/replay_gen.cu, cadence_replay_gen), then kernel
  B, and C for the CRC;
- the sharded forms launch each shard on its own device of a
  parallel/mesh.Mesh and gather the results on its first device.
On the CPU (`device="cpu"`) every entry point runs the plain version:
`gen_step` and `init_gen_state` below in plain torch ops, the JAX
package's ops/genkernel.py written out, and the fused loop runs them
with ops/transitions.step one step at a time, as `_fused_scan` does, so
no lanes tensor is made. A copy of the JAX package's module in its
arithmetic: int64 adds and multiplies wrap, `>>` on int64 is arithmetic,
and `%` on int64 is floor modulo, as they are in jnp.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..core.enums import EventType
from ..device import resolve_device
from . import _build
from .crc import crc32_rows
from .encode import (
    LANE_A0,
    LANE_BATCH_FIRST,
    LANE_BATCH_LAST,
    LANE_EVENT_ID,
    LANE_EVENT_TYPE,
    LANE_TASK_ID,
    LANE_TIMESTAMP,
    NUM_LANES,
)
from .payload import payload_rows
from .replay import _copy_into
from .state import ReplayState, init_state, layout_of
from .transitions import step as replay_step

I64 = torch.int64
NANOS_MS = 1_000_000


class GenState(NamedTuple):
    ts: torch.Tensor           # [W] int64 nanos
    phase: torch.Tensor        # [W] int32: 0 none, 1 scheduled, 2 started
    dsched: torch.Tensor       # [W] int64
    dstart: torch.Tensor       # [W] int64
    act_occ: torch.Tensor      # [W, 4] bool
    act_sched: torch.Tensor    # [W, 4] int64
    act_started: torch.Tensor  # [W, 4] bool
    act_count: torch.Tensor    # [W] int64 (interned-key counter)
    tmr_occ: torch.Tensor      # [W, 3] bool
    tmr_key: torch.Tensor      # [W, 3] int64
    tmr_count: torch.Tensor    # [W] int64
    ch_occ: torch.Tensor       # [W, 2] bool
    ch_init: torch.Tensor      # [W, 2] int64
    ch_started: torch.Tensor   # [W, 2] bool


# action codes
A_STARTED, A_DSCHED, A_DSTART, A_DCOMPLETE = 0, 1, 2, 3
A_ASCHED, A_ASTART, A_ACLOSE = 4, 5, 6
A_TSTART, A_TFIRE = 7, 8
A_CINIT, A_CSTART, A_CCLOSE = 9, 10, 11
A_SIGNAL, A_WFCLOSE = 12, 13

_CODE_TO_TYPE = (
    int(EventType.WorkflowExecutionStarted),
    int(EventType.DecisionTaskScheduled),
    int(EventType.DecisionTaskStarted),
    int(EventType.DecisionTaskCompleted),
    int(EventType.ActivityTaskScheduled),
    int(EventType.ActivityTaskStarted),
    int(EventType.ActivityTaskCompleted),
    int(EventType.TimerStarted),
    int(EventType.TimerFired),
    int(EventType.StartChildWorkflowExecutionInitiated),
    int(EventType.ChildWorkflowExecutionStarted),
    int(EventType.ChildWorkflowExecutionCompleted),
    int(EventType.WorkflowExecutionSignaled),
    int(EventType.WorkflowExecutionCompleted),
)


def _wrap(x: int) -> int:
    """A Python int as the int64 it wraps to."""
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def _mix(seed, w: torch.Tensor, step, salt) -> torch.Tensor:
    """splitmix64-style counter hash of int64 tensor `w`; int64 wraparound
    is the ring, and the shifts are arithmetic. `seed`, `step` and `salt`
    are Python ints or int64 tensors."""
    z = w * -7046029254386353131
    for x, k in ((seed, 1), (step, 6364136223846793005), (salt, 1442695040888963407)):
        z = z + (_wrap(x * k) if isinstance(x, int) else x * k)
    z = (z ^ (z >> 30)) * -4658895280553007687
    z = (z ^ (z >> 27)) * -7723592293110705685
    return z ^ (z >> 31)


def _die(r: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.abs(r) % n: abs(INT64_MIN) wraps to INT64_MIN, and the floor
    modulo takes the divisor's sign."""
    return torch.abs(r) % n


def _first(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(one-hot of the first True per row, any per row)."""
    K = mask.shape[1]
    idx = mask.to(torch.int32).argmax(dim=1)
    anyv = mask.any(dim=1)
    onehot = (torch.arange(K, device=mask.device)[None, :] == idx[:, None]) & anyv[:, None]
    return onehot, anyv


def _indices(num_workflows: int, first_index: int, device) -> torch.Tensor:
    return torch.arange(num_workflows, dtype=I64, device=device) + first_index


def init_gen_state(num_workflows: int, seed: int, first_index: int, device=None) -> GenState:
    W = num_workflows
    dev = resolve_device(device)
    w = _indices(W, first_index, dev)
    jitter = _die(_mix(seed, w, 0, 17), 1_000_000)
    z64 = lambda *shape: torch.zeros((W,) + shape, dtype=I64, device=dev)  # noqa: E731
    zb = lambda k: torch.zeros((W, k), dtype=torch.bool, device=dev)  # noqa: E731
    return GenState(
        ts=1_700_000_000_000_000_000 + jitter * NANOS_MS,
        phase=torch.zeros((W,), dtype=torch.int32, device=dev),
        dsched=z64(), dstart=z64(),
        act_occ=zb(4), act_sched=z64(4), act_started=zb(4), act_count=z64(),
        tmr_occ=zb(3), tmr_key=z64(3), tmr_count=z64(),
        ch_occ=zb(2), ch_init=z64(2), ch_started=zb(2),
    )


def _select(conds, values, default):
    """jnp.select: the value of the first condition that holds."""
    out = default
    for c, v in reversed(list(zip(conds, values))):
        out = torch.where(c, v, out)
    return out


def _take(sel: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.where(sel, table, torch.zeros_like(table)).sum(dim=1)


def step_dice(seed: int, first_index: int, num_workflows: int, step: int, device) -> dict:
    """The draws gen_step takes at scan step `step`: the four counter hashes
    (salts 1-4: r0-r3) and the values it takes from them, by name as
    DICE_FIELDS and unpack_dice give them, and started_a0 (600 + die(r2,
    6600), used at step 0)."""
    w = _indices(num_workflows, first_index, device)
    r0, r1, r2, r3 = (_mix(seed, w, step, salt) for salt in (1, 2, 3, 4))
    return {"ts_ms": _die(r3, 5000) + 1, "die1": _die(r0, 16), "die2": _die(r1, 8),
            "started_a0": 600 + _die(r2, 6600), "sched_to_start": 5 + _die(r2, 115),
            "sched_to_close": 30 + _die(r2, 570), "start_to_close": 10 + _die(r3, 290),
            "timer_s": 1 + _die(r2, 600)}


def gen_step(g: GenState, seed: int, first_index: int, step: int, total_events: int,
             dice: dict = None) -> Tuple[GenState, torch.Tensor]:
    """Plain version of the generator step: emit the event lanes [W, 18]
    of scan step `step` and advance the generator state. Every workflow
    emits exactly one real event per step, so every id is step + 1. The
    step's draws are `dice` (step_dice's keys) when given, else made here."""
    W = g.ts.shape[0]
    dev = g.ts.device
    d = step_dice(seed, first_index, W, step, dev) if dice is None else dice

    eid = torch.full((W,), step + 1, dtype=I64, device=dev)
    ts = g.ts + d["ts_ms"] * NANOS_MS

    pending = (g.act_occ.sum(dim=1) + g.tmr_occ.sum(dim=1) + g.ch_occ.sum(dim=1)).to(I64)
    # an unstarted activity or child needs two drain events (start, close)
    n_unstarted = ((g.act_occ & ~g.act_started).sum(dim=1)
                   + (g.ch_occ & ~g.ch_started).sum(dim=1)).to(I64)
    remaining = total_events - step
    # margin 4: one normal step can grow pending + n_unstarted by 2 while
    # remaining drops by 1
    drain = remaining <= pending + n_unstarted + 4

    # -- the action code
    die = d["die1"]
    die2 = d["die2"]
    act_free = ~g.act_occ.all(dim=1)
    act_unstarted = (g.act_occ & ~g.act_started).any(dim=1)
    act_any = g.act_occ.any(dim=1)
    # closes only land on STARTED items, as the engine's histories have them
    act_started_any = (g.act_occ & g.act_started).any(dim=1)
    tmr_free = ~g.tmr_occ.all(dim=1)
    tmr_any = g.tmr_occ.any(dim=1)
    ch_free = ~g.ch_occ.all(dim=1)
    ch_unstarted = (g.ch_occ & ~g.ch_started).any(dim=1)
    ch_any = g.ch_occ.any(dim=1)
    ch_started_any = (g.ch_occ & g.ch_started).any(dim=1)

    c = lambda k: torch.full((W,), k, dtype=I64, device=dev)  # noqa: E731
    wh = lambda cond, a, b: torch.where(cond, a if torch.is_tensor(a) else c(a),  # noqa: E731
                                        b if torch.is_tensor(b) else c(b))
    external = _select(
        [die2 <= 1, die2 == 2, die2 == 3, die2 == 4, die2 == 5, die2 == 6, die2 == 7],
        [wh(act_free, A_ASCHED, A_SIGNAL),
         wh(act_unstarted, A_ASTART, A_SIGNAL),
         wh(act_started_any, A_ACLOSE, A_SIGNAL),
         wh(tmr_free, A_TSTART, wh(tmr_any, A_TFIRE, A_SIGNAL)),
         wh(tmr_any, A_TFIRE, A_SIGNAL),
         wh(ch_free, A_CINIT, wh(ch_started_any, A_CCLOSE, A_SIGNAL)),
         wh(ch_unstarted, A_CSTART, wh(ch_started_any, A_CCLOSE, A_SIGNAL))],
        c(A_SIGNAL))
    normal = _select(
        [g.phase == 1, g.phase == 2],
        [wh(die < 13, A_DSTART, A_SIGNAL), wh(die < 6, A_DCOMPLETE, external)],
        wh(die < 8, A_DSCHED, external))
    # start before close within each family: closes pick the FIRST occupied
    # slot and all starts precede all closes
    drained = _select(
        [act_unstarted, act_any, ch_unstarted, tmr_any, ch_any, torch.full_like(drain,
                                                                               remaining > 1)],
        [c(A_ASTART), c(A_ACLOSE), c(A_CSTART), c(A_TFIRE), c(A_CCLOSE), c(A_SIGNAL)],
        c(A_WFCLOSE))

    code = torch.where(drain, drained, normal)
    code = torch.where(eid == 1, c(A_STARTED), code)
    code = torch.where(eid == 2, c(A_DSCHED), code)

    def m(k):
        return code == k

    # -- per-action state updates and attribute lanes
    a = [torch.zeros((W,), dtype=I64, device=dev) for _ in range(8)]

    a[0] = torch.where(m(A_STARTED), d["started_a0"], a[0])
    a[1] = torch.where(m(A_STARTED), c(10), a[1])
    a[7] = torch.where(m(A_STARTED), c(-1), a[7])

    a[0] = torch.where(m(A_DSCHED), c(10), a[0])
    phase = torch.where(m(A_DSCHED), torch.ones_like(g.phase), g.phase)
    dsched = torch.where(m(A_DSCHED), eid, g.dsched)
    a[0] = torch.where(m(A_DSTART), dsched, a[0])
    phase = torch.where(m(A_DSTART), torch.full_like(phase, 2), phase)
    dstart = torch.where(m(A_DSTART), eid, g.dstart)
    a[0] = torch.where(m(A_DCOMPLETE), dsched, a[0])
    a[1] = torch.where(m(A_DCOMPLETE), dstart, a[1])
    phase = torch.where(m(A_DCOMPLETE), torch.zeros_like(phase), phase)

    # activities
    ins, _ = _first(~g.act_occ)
    ins = ins & m(A_ASCHED)[:, None]
    act_occ = g.act_occ | ins
    act_sched = torch.where(ins, eid[:, None], g.act_sched)
    act_started = g.act_started & ~ins
    act_count = g.act_count + m(A_ASCHED).to(I64)
    a[0] = torch.where(m(A_ASCHED), act_count, a[0])  # the interned key
    a[1] = torch.where(m(A_ASCHED), d["sched_to_start"], a[1])
    a[2] = torch.where(m(A_ASCHED), d["sched_to_close"], a[2])
    a[3] = torch.where(m(A_ASCHED), d["start_to_close"], a[3])

    sel, _ = _first(act_occ & ~act_started)
    sel = sel & m(A_ASTART)[:, None]
    a[0] = torch.where(m(A_ASTART), _take(sel, act_sched), a[0])
    act_started = act_started | sel

    sel, _ = _first(act_occ & act_started)
    sel = sel & m(A_ACLOSE)[:, None]
    a[0] = torch.where(m(A_ACLOSE), _take(sel, act_sched), a[0])
    act_occ = act_occ & ~sel
    act_started = act_started & ~sel

    # timers
    ins, _ = _first(~g.tmr_occ)
    ins = ins & m(A_TSTART)[:, None]
    tmr_count = g.tmr_count + m(A_TSTART).to(I64)
    tmr_occ = g.tmr_occ | ins
    tmr_key = torch.where(ins, tmr_count[:, None], g.tmr_key)
    a[0] = torch.where(m(A_TSTART), tmr_count, a[0])
    a[1] = torch.where(m(A_TSTART), d["timer_s"], a[1])

    sel, _ = _first(tmr_occ)
    sel = sel & m(A_TFIRE)[:, None]
    a[0] = torch.where(m(A_TFIRE), _take(sel, tmr_key), a[0])
    tmr_occ = tmr_occ & ~sel

    # children
    ins, _ = _first(~g.ch_occ)
    ins = ins & m(A_CINIT)[:, None]
    ch_occ = g.ch_occ | ins
    ch_init = torch.where(ins, eid[:, None], g.ch_init)
    ch_started = g.ch_started & ~ins

    sel, _ = _first(ch_occ & ~ch_started)
    sel = sel & m(A_CSTART)[:, None]
    a[0] = torch.where(m(A_CSTART), _take(sel, ch_init), a[0])
    ch_started = ch_started | sel

    sel, _ = _first(ch_occ & ch_started)
    sel = sel & m(A_CCLOSE)[:, None]
    a[0] = torch.where(m(A_CCLOSE), _take(sel, ch_init), a[0])
    ch_occ = ch_occ & ~sel
    ch_started = ch_started & ~sel

    # -- the lanes: one event per batch; version, branch, parent and flags 0
    lanes = torch.zeros((W, NUM_LANES), dtype=I64, device=dev)
    lanes[:, LANE_EVENT_ID] = eid
    lanes[:, LANE_EVENT_TYPE] = torch.tensor(_CODE_TO_TYPE, dtype=I64, device=dev)[code]
    lanes[:, LANE_TIMESTAMP] = ts
    lanes[:, LANE_TASK_ID] = eid + 1000
    lanes[:, LANE_BATCH_FIRST] = eid
    lanes[:, LANE_BATCH_LAST] = 1
    for i in range(8):
        lanes[:, LANE_A0 + i] = a[i]

    return GenState(ts=ts, phase=phase, dsched=dsched, dstart=dstart, act_occ=act_occ,
                    act_sched=act_sched, act_started=act_started, act_count=act_count,
                    tmr_occ=tmr_occ, tmr_key=tmr_key, tmr_count=tmr_count, ch_occ=ch_occ,
                    ch_init=ch_init, ch_started=ch_started), lanes


# ---------------------------------------------------------------------------
# Kernel A's generator reader: the draws made ahead of the stepping threads
# ---------------------------------------------------------------------------

#: csrc/replay_gen.cu: workflows (stepping threads) a block, and the steps
#: of a tile whose draws the block makes before they are stepped
GEN_WF, GEN_TILE = 32, 16

#: genkernel.cuh pack_dice: each draw's (hash salt, modulus, added, low bit,
#: bits) in the 56-bit word. ts_ms is die(r3, 5000) + 1, stored as it is
#: used; the others are stored as die(r, n) and the step adds `added`.
DICE_FIELDS = {
    "ts_ms": (4, 5000, 1, 0, 13),
    "die1": (1, 16, 0, 13, 4),
    "die2": (2, 8, 0, 17, 3),
    "sched_to_start": (3, 115, 5, 20, 7),
    "sched_to_close": (3, 570, 30, 27, 10),
    "timer_s": (3, 600, 1, 37, 10),
    "start_to_close": (4, 290, 10, 47, 9),
}


def pack_dice_plain(seed: int, first_index: int, num_workflows: int, e0: int, steps: int,
                    device="cpu") -> torch.Tensor:
    """Plain version of one tile of kernel A's generator reader's draws:
    [steps, W] int64 words, word [s, i] the packed draws of workflow
    first_index + i at scan step e0 + s (step-major, as the block lays them
    out in shared memory)."""
    w = _indices(num_workflows, first_index, resolve_device(device))
    out = torch.empty((steps, num_workflows), dtype=I64, device=w.device)
    for s in range(steps):
        r = {salt: _mix(seed, w, e0 + s, salt) for salt in (1, 2, 3, 4)}
        word = torch.zeros_like(w)
        for name, (salt, n, added, lo, _bits) in DICE_FIELDS.items():
            word |= (_die(r[salt], n) + (added if name == "ts_ms" else 0)) << lo
        out[s] = word
    return out


def unpack_dice(words: torch.Tensor) -> dict:
    """The values a step takes from packed words (PackedDice): ts_ms,
    die1 and die2 as stored, the attribute draws with their offsets."""
    return {name: ((words >> lo) & ((1 << bits) - 1)) + (0 if name == "ts_ms" else added)
            for name, (_salt, _n, added, lo, bits) in DICE_FIELDS.items()}


# ---------------------------------------------------------------------------
# Kernel I: the lanes materialised
# ---------------------------------------------------------------------------


def generate_lanes_plain(seed: int, first_index: int, num_workflows: int, total_events: int,
                         device="cpu") -> torch.Tensor:
    """Plain version of kernel I: [W, E, 18] int64 lanes, step by step."""
    g = init_gen_state(num_workflows, seed, first_index, device)
    out = torch.empty((num_workflows, total_events, NUM_LANES), dtype=I64, device=g.ts.device)
    for e in range(total_events):
        g, out[:, e] = gen_step(g, seed, first_index, e, total_events)
    return out


#: csrc/genkernel.cu: workflows a block (its stepping warp) and the steps
#: of a tile, whose draws are made and whose lanes are stored by the block's
#: other warps
LANES_WF, LANES_TILE = 32, 4


def generate_lanes_tiled_plain(seed: int, first_index: int, num_workflows: int,
                               total_events: int, device="cpu") -> torch.Tensor:
    """Plain version of kernel I's tiling: blocks of LANES_WF workflows, each
    walking the steps in tiles of LANES_TILE; a tile's draws made first as
    packed words (pack_dice_plain, unpacked as the stepping thread reads
    them, with step 0's started_a0 made once a workflow), its steps run on
    them into the tile, and the tile's lanes then written to each
    workflow's span of the output. Equal to generate_lanes_plain."""
    dev = resolve_device(device)
    W, E = num_workflows, total_events
    out = torch.empty((W, E, NUM_LANES), dtype=I64, device=dev)
    for w0 in range(0, W, LANES_WF):
        nw = min(LANES_WF, W - w0)
        wf0 = first_index + w0
        g = init_gen_state(nw, seed, wf0, dev)
        started = 600 + _die(_mix(seed, _indices(nw, wf0, dev), 0, 3), 6600)
        for e0 in range(0, E, LANES_TILE):
            n = min(LANES_TILE, E - e0)
            words = pack_dice_plain(seed, wf0, nw, e0, n, dev)
            tile = torch.empty((nw, n, NUM_LANES), dtype=I64, device=dev)
            for s in range(n):
                d = unpack_dice(words[s])
                d["started_a0"] = started
                g, tile[:, s] = gen_step(g, seed, wf0, e0 + s, E, dice=d)
            out[w0:w0 + nw, e0:e0 + n] = tile
    return out


def generate_lanes(seed: int, first_index: int, num_workflows: int, total_events: int,
                   device=None) -> torch.Tensor:
    """[W, E, 18] int64 lanes of workflows first_index .. first_index + W -
    1: for samples, tests and the oracle's cross-checks, identical to what
    the fused path replays. Kernel I on the card, the plain version on the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return generate_lanes_plain(seed, first_index, num_workflows, total_events, dev)
    launch, out = generate_lanes_launch(seed, first_index, num_workflows, total_events, dev)
    launch()
    return out


def generate_lanes_launch(seed: int, first_index: int, num_workflows: int, total_events: int,
                          device=None):
    """Kernel I's launch and the [W, E, 18] int64 output it writes."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"generate_lanes: kernel I runs on a CUDA device, not {dev}")
    out = torch.empty((num_workflows, total_events, NUM_LANES), dtype=I64, device=dev)
    return _build.launcher("gen_lanes", _build.load().cadence_gen_lanes, _wrap(seed), first_index,
                           num_workflows, total_events, out, _build.stream_of(out)), out


# ---------------------------------------------------------------------------
# Kernel A's generator reader: the fused generate-and-replay loop
# ---------------------------------------------------------------------------


def gen_scan_plain(s0: ReplayState, seed: int, first_index: int,
                   total_events: int) -> ReplayState:
    """Plain version of kernel A's generator reader (the JAX package's
    `_fused_scan`): per step, gen_step then ops/transitions.step, from a
    fresh generator state and the replay state `s0`, which is not
    modified. No lanes tensor is made."""
    g = init_gen_state(s0.state.shape[0], seed, first_index, s0.state.device)
    s = s0
    for e in range(total_events):
        g, lanes = gen_step(g, seed, first_index, e, total_events)
        s = replay_step(s, lanes)
    return s


def gen_scan(s: ReplayState, seed: int, first_index: int, total_events: int) -> ReplayState:
    """Generate and replay `total_events` events of workflows first_index
    .. first_index + W - 1 on state `s`, IN PLACE, and return `s`: kernel
    A's generator reader on the card; on the CPU the plain version, whose
    result is copied back into `s`."""
    dev = s.state.device
    if dev.type == "cpu":
        return _copy_into(s, gen_scan_plain(s, seed, first_index, total_events))
    if dev.type != "cuda":
        raise ValueError(f"generate_and_replay: unsupported device {dev}")
    gen_launch(s, seed, first_index, total_events)()
    return s


#: the largest activity, timer and child capacity kernel A's generator
#: reader takes (each table's occupancy is one 64-bit mask in registers)
GEN_MAX_SLOTS = 64


def gen_launch(s: ReplayState, seed: int, first_index: int, total_events: int):
    """Check what kernel A's generator reader takes and return its launch,
    a call that runs it on `s` in place (see _build.launcher)."""
    lay = layout_of(s)
    W = s.state.shape[0]
    if max(lay.max_activities, lay.max_timers, lay.max_children) > GEN_MAX_SLOTS:
        raise ValueError(f"generate_and_replay: kernel A's generator reader takes at most "
                         f"{GEN_MAX_SLOTS} activity, timer and child slots, not {lay}")
    return _build.launcher(
        "replay_gen", _build.load().cadence_replay_gen, _build.state_pointer_table(s),
        _wrap(seed), first_index, W, total_events, _build.caps(lay), lay.max_branches,
        lay.max_version_history_items, 0,  # threads a workflow: the launch chooses
        _build.stream_of(s.state))


def generate_and_replay_state(seed: int, first_index: int, num_workflows: int,
                              total_events: int, layout: PayloadLayout = DEFAULT_LAYOUT,
                              device=None) -> ReplayState:
    """The fused loop from a fresh state; returns the final state."""
    dev = resolve_device(device)
    return gen_scan(init_state(num_workflows, layout, dev), seed, first_index, total_events)


def generate_and_replay(seed: int, first_index: int, num_workflows: int, total_events: int,
                        layout: PayloadLayout = DEFAULT_LAYOUT,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused north-star step: each event is generated and applied to
    the replay state in the same loop iteration. Returns (payload rows
    [W, width], errors [W])."""
    s = generate_and_replay_state(seed, first_index, num_workflows, total_events, layout, device)
    return payload_rows(s, layout), s.error


def generate_and_replay_crc(seed: int, first_index: int, num_workflows: int, total_events: int,
                            layout: PayloadLayout = DEFAULT_LAYOUT,
                            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused step reduced to (crc32 [W] int64 holding the unsigned
    value, errors [W]): generation, replay, payload and CRC on the device,
    4 bytes a workflow for the host to pull."""
    rows, errors = generate_and_replay(seed, first_index, num_workflows, total_events, layout,
                                       device)
    return crc32_rows(rows), errors


# ---------------------------------------------------------------------------
# The sharded forms over a parallel/mesh.Mesh
# ---------------------------------------------------------------------------


def _sharded(fn, seed: int, first_index: int, num_workflows: int, total_events: int, mesh,
             layout: PayloadLayout):
    from ..parallel.mesh import gather, on_device

    n = mesh.size
    if num_workflows % n:
        raise ValueError(f"workflows {num_workflows} not divisible by mesh size {n}")
    local = num_workflows // n
    outs = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            outs.append(fn(seed, first_index + i * local, local, total_events, layout, dev))
    return tuple(gather(mesh, ts) for ts in zip(*outs))


def generate_and_replay_sharded(seed: int, first_index: int, num_workflows: int,
                                total_events: int, mesh,
                                layout: PayloadLayout = DEFAULT_LAYOUT):
    """The fused step over a device mesh: shard i runs workflows first_index
    + i * W/n onward on its own device (each workflow's stream depends only
    on (seed, index), so the shards are independent), and the (rows,
    errors) are gathered on the mesh's first device, equal to the one-device
    path's. W must be a multiple of the mesh size."""
    return _sharded(generate_and_replay, seed, first_index, num_workflows, total_events, mesh,
                    layout)


def generate_and_replay_sharded_crc(seed: int, first_index: int, num_workflows: int,
                                    total_events: int, mesh,
                                    layout: PayloadLayout = DEFAULT_LAYOUT):
    """The sharded fused step reduced on the devices to (crc32 [W], errors
    [W])."""
    return _sharded(generate_and_replay_crc, seed, first_index, num_workflows, total_events,
                    mesh, layout)
