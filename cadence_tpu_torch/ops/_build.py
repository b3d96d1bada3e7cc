"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc -c` for sm_90a, all of them
started together (so the build takes about as long as the largest
source, not the sum), and the objects are linked into one shared library
with a plain C interface, loaded with ctypes. The library's name carries a hash
of every source, so an edited kernel is rebuilt once and an unchanged tree
is never recompiled; the build goes to csrc/_build/ (git-ignored) at first
use. Nothing here runs at import time: the CPU tests import every module
and never build.

There is no fallback. A failed build, a missing `nvcc` or a kernel that
returns a CUDA error raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import glob
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "_build")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: seconds the last build took in this process (0.0 when the library was
#: already built for these sources)
build_seconds = 0.0
#: the compiler's output of that build (ptxas registers, spills)
build_log = ""
#: seconds each source's nvcc took in that build (they run side by side,
#: so build_seconds is about the largest, not the sum)
compile_seconds: dict = {}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources() + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from ..device import nvcc_path

    found = nvcc_path()
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> str:
    return os.path.join(_BUILD_DIR, f"libcadence_kernels_{_digest()}.so")


def _run(cmd):
    """(output, seconds) of one compiler call; raises when it fails."""
    t0 = time.perf_counter()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{p.stdout}")
    return p.stdout, time.perf_counter() - t0


def build() -> str:
    """Compile every csrc/*.cu, one nvcc each, all started together, and
    link the shared library, unless it is already built for these sources.
    Returns its path."""
    global build_seconds, build_log, compile_seconds
    so = library_path()
    if os.path.exists(so):
        return so
    t0 = time.perf_counter()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    srcs = _sources()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in srcs]
        with ThreadPoolExecutor(len(srcs)) as pool:
            done = list(pool.map(_run, ([nvcc, _ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                                         "-Xptxas", "-v", "-c", "-o", obj, src]
                                        for src, obj in zip(srcs, objs))))
        _run([nvcc, _ARCH, "-shared", "-o", os.path.join(tmp, "lib.so")] + objs)
        os.replace(os.path.join(tmp, "lib.so"), so)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(out for out, _ in done)
    compile_seconds = {os.path.basename(src): secs for src, (_, secs) in zip(srcs, done)}
    return so


def _configure(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cadence_replay.restype = I
    # state pointer table, events, W, E, lanes-is-wire32, K[5], B, Kv, stream
    lib.cadence_replay.argtypes = [P, P, L, L, I, P, I, I, P]
    lib.cadence_replay_tasks.restype = I
    # state pointer table, task-log pointer table, events, W, E, lanes-is-wire32, K[5], B, Kv,
    # Tt, Tm, retention nanos, stream
    lib.cadence_replay_tasks.argtypes = [P, P, P, L, L, I, P, I, I, L, L, L, P]
    lib.cadence_replay_wirec.restype = I
    # state pointer table, slab, bases, n_events, W, E, B, K, profile table, K[5], B, Kv, stream
    lib.cadence_replay_wirec.argtypes = [P, P, P, P, L, L, I, I, P, P, I, I, P]
    # the same three on kernel A's global route (ops/replay.py replay_route)
    for name in ("cadence_replay", "cadence_replay_tasks", "cadence_replay_wirec"):
        getattr(lib, name + "_global").restype = I
        getattr(lib, name + "_global").argtypes = getattr(lib, name).argtypes
    lib.cadence_decode_wirec.restype = I
    # slab, bases, n_events, out, W, E, B, K, profile table, stream
    lib.cadence_decode_wirec.argtypes = [P, P, P, P, L, L, I, I, P, P]
    lib.cadence_payload.restype = I
    # state pointer table, rows, overflow, W, K[5], B, Kv, out caps[5], out Kv, width, out B,
    # fit, counts, counts scratch (the last three null when not asked for), stream
    lib.cadence_payload.argtypes = [P, P, P, L, P, I, I, P, I, I, I, P, P, P, P]
    lib.cadence_crc32.restype = I
    lib.cadence_crc32.argtypes = [P, P, L, I, P]  # rows, out, W, width, stream
    lib.cadence_verify_rows.restype = I
    # rows, expected, branch, expected_branch, out, W, width, stream
    lib.cadence_verify_rows.argtypes = [P, P, P, P, P, L, I, P]
    lib.cadence_stats.restype = I
    lib.cadence_stats.argtypes = [P, P, P, L, P]  # error, close_status, out, W, stream
    lib.cadence_rehome.restype = I
    # src pointer table, K_in[5], B_in, Kv_in, dst pointer table, K_out[5], B_out, Kv_out,
    # src_rows, dst_rows, n, field init values, field element sizes, stream
    lib.cadence_rehome.argtypes = [P, P, I, I, P, P, I, I, P, P, L, P, P, P]
    lib.cadence_narrow_ok.restype = I
    # state pointer table, K_in[5], B_in, Kv_in, K_out[5], B_out, Kv_out, out, W, stream
    lib.cadence_narrow_ok.argtypes = [P, P, I, I, P, I, I, P, L, P]
    lib.cadence_gen_lanes.restype = I
    lib.cadence_gen_lanes.argtypes = [L, L, L, L, P, P]  # seed, first index, W, E, out, stream
    lib.cadence_replay_gen.restype = I
    # state pointer table, seed, first index, W, E, K[5], B, Kv, threads a workflow, stream
    lib.cadence_replay_gen.argtypes = [P, L, L, L, L, P, I, I, I, P]
    lib.cadence_vis_mask.restype = I
    # host ValuePlan, valid, N, count, bitmap (or null), scratch, stream
    lib.cadence_vis_mask.argtypes = [P, P, L, P, P, P, P]
    lib.cadence_vis_mask_table.restype = I
    # decoded plan table, entries, instructions, valid, N, count, bitmap (or null), scratch, stream
    lib.cadence_vis_mask_table.argtypes = [P, I, I, P, L, P, P, P, P]
    lib.cadence_vis_topk.restype = I
    # host ValuePlan, valid, start, N, k, scratch, ids, count, stream
    lib.cadence_vis_topk.argtypes = [P, P, P, L, L, P, P, P, P]
    lib.cadence_vis_topk_table.restype = I
    # decoded plan table, entries, instructions, valid, start, N, k, scratch, ids, count, stream
    lib.cadence_vis_topk_table.argtypes = [P, I, I, P, P, L, L, P, P, P, P]
    lib.cadence_vis_topk_scratch.restype = L
    lib.cadence_vis_topk_scratch.argtypes = [L, L]  # N, k
    lib.cadence_vis_apply.restype = I
    # pointer table (columns, element sizes, value offsets), C, packed delta, B, N, stream
    lib.cadence_vis_apply.argtypes = [P, I, P, L, L, P]


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _configure(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {rc}")


#: launches of each kernel, counted by its wrapper where it launches and
#: nowhere else (the plain versions never count)
#: (kernel A's global route counts under its own names: replay_global,
#: replay_tasks_global, replay_wirec_global; kernels J's and K's table
#: route as vis_mask_table and vis_topk_table; kernel B's launches that run
#: its fit or counts epilogue count also as payload_fit, payload_counts)
launches = {"replay": 0, "replay_tasks": 0, "replay_wirec": 0, "replay_global": 0,
            "replay_tasks_global": 0, "replay_wirec_global": 0, "payload": 0,
            "payload_fit": 0, "payload_counts": 0, "crc32": 0,
            "verify_rows": 0, "decode_wirec": 0, "stats": 0, "rehome": 0, "narrow_ok": 0,
            "gen_lanes": 0, "replay_gen": 0, "vis_mask": 0, "vis_mask_table": 0, "vis_topk": 0,
            "vis_topk_table": 0, "vis_apply": 0}


#: launches by (kernel, the shape of its first tensor argument), counted
#: beside `launches`
launch_shapes = collections.Counter()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    launch_shapes.clear()


def caps(layout):
    """A layout's five table capacities, in the kernels' order."""
    return (ctypes.c_int * 5)(layout.max_activities, layout.max_timers, layout.max_children,
                              layout.max_request_cancels, layout.max_signals)


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, dtype, shape, what: str, device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (and on `device`, when given): what the kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def aligned(t, align: int = 16):
    """`t`, or a copy of it on its device where its data does not start on
    an `align`-byte boundary (kernels C and D read rows in 16-byte units
    from the base on). Every fresh allocation is aligned; a slice may not
    be."""
    return t.clone() if t.data_ptr() % align else t


#: the state tensors in the order csrc/state.cuh indexes them
STATE_FIELDS = (
    "state", "close_status", "cancel_requested", "last_first_event_id", "next_event_id",
    "last_processed_event", "signal_count", "decision_version", "decision_schedule_id",
    "decision_started_id", "decision_attempt", "decision_timeout", "decision_scheduled_ts",
    "decision_started_ts", "decision_original_scheduled_ts", "workflow_timeout",
    "decision_sts_timeout", "start_timestamp", "completion_event_batch_id",
    "last_event_task_id", "workflow_attempt", "expiration_time", "has_parent",
    "current_version", "vh_event_ids", "vh_versions", "vh_count", "current_branch",
    "activities.occ", "activities.schedule_id", "activities.started_id", "activities.version",
    "activities.activity_key", "activities.scheduled_time", "activities.started_time",
    "activities.last_heartbeat", "activities.sched_to_start", "activities.sched_to_close",
    "activities.start_to_close", "activities.heartbeat", "activities.cancel_requested",
    "activities.cancel_request_id", "activities.attempt", "activities.timer_status",
    "activities.has_retry", "activities.batch_id",
    "timers.occ", "timers.timer_key", "timers.started_id", "timers.expiry_time",
    "timers.task_status", "timers.version",
    "children.occ", "children.initiated_id", "children.started_id", "children.version",
    "children.batch_id",
    "cancels.occ", "cancels.initiated_id", "cancels.version", "cancels.batch_id",
    "signals.occ", "signals.initiated_id", "signals.version", "signals.batch_id",
    "error",
)


@functools.lru_cache(maxsize=None)
def _state_reference(layout) -> tuple:
    """(name, dtype, shape after W) of every state tensor at `layout`, in
    csrc/state.cuh order: what the kernels take, made once per layout."""
    from .state import init_state, leaves

    ref = tuple((name, t.dtype, tuple(t.shape[1:]))
                for name, t in leaves(init_state(1, layout, "meta")))
    if tuple(name for name, _, _ in ref) != STATE_FIELDS:
        raise AssertionError("the state's field order is not the kernels' order")
    return ref


def state_pointer_table(s: ReplayState):
    """The kernels' view of a state: one device pointer per tensor, in
    csrc/state.cuh order, after checking device, dtype, shape and
    contiguity against the layout's reference."""
    from .state import layout_of, leaves

    W = s.state.shape[0]
    dev = s.state.device
    ptrs = []
    for (name, dtype, shape), (_, t) in zip(_state_reference(layout_of(s)), leaves(s)):
        require(t, dtype, (W,) + shape, f"state.{name}", dev)
        ptrs.append(t.data_ptr())
    return (ctypes.c_uint64 * len(ptrs))(*ptrs)


def launcher(name: str, fn, *args, also=()):
    """A call that launches kernel `name`: it runs the C entry point `fn`
    on `args` (tensors are passed as their device pointers, None as a null
    pointer), raises on the cudaError_t it returns, and counts the launch,
    under `name` and under each of `also` (the epilogues it runs). The
    wrappers make every check and the argument list before this, once, so
    a timer can hold the launch alone."""
    import torch

    c_args = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args)
    shape = next((tuple(a.shape) for a in args if isinstance(a, torch.Tensor)), ())
    names = (name,) + tuple(also)

    def launch():
        check(fn(*c_args), name)
        for counted in names:
            launches[counted] += 1
            launch_shapes[(counted, shape)] += 1

    launch.args = args  # the tensors the pointers point into live as long as the launch
    launch.name = name
    return launch
