"""Shared helpers of the tests/test_torch_*.py files: the same numpy inputs
go through the JAX package and through cadence_tpu_torch on the CPU, and
the results are compared exactly (every value is an integer, so the
tolerance is 0)."""
import random

import numpy as np

from cadence_tpu_torch.ops.state import leaves

#: every replay in these tests pads to this many events, so the JAX
#: package compiles each (W, E) shape once
E_PAD = 130


def jax_state_to_numpy(js) -> dict:
    """Flatten a JAX ReplayState (NamedTuple of tables) to
    {dotted field path: numpy array}, the form ops/convert.py takes."""
    out = {}

    def walk(prefix, x):
        if hasattr(x, "_fields"):
            for f in x._fields:
                walk(f"{prefix}.{f}" if prefix else f, getattr(x, f))
        else:
            out[prefix] = np.asarray(x)

    walk("", js)
    return out


def jax_state_from_numpy(mapping, layout):
    """A JAX ReplayState at `layout` (the JAX package's PayloadLayout) from
    {dotted field path: array}, the form jax_state_to_numpy gives."""
    import jax.numpy as jnp

    from cadence_tpu.ops.state import init_state

    def build(prefix, x):
        if hasattr(x, "_fields"):
            return type(x)(**{f: build(f"{prefix}.{f}" if prefix else f, getattr(x, f))
                              for f in x._fields})
        return jnp.asarray(np.asarray(mapping[prefix]), dtype=x.dtype)

    return build("", init_state(len(mapping["state"]), layout))


def assert_states_equal(port_state, jax_state) -> None:
    """Every one of the 66 state tensors equal, in value and dtype."""
    want = jax_state_to_numpy(jax_state)
    got = {name: t.cpu().numpy() for name, t in leaves(port_state)}
    assert sorted(got) == sorted(want)
    assert len(got) == 66
    bad = [name for name in want
           if got[name].dtype != want[name].dtype
           or got[name].shape != want[name].shape
           or not np.array_equal(got[name], want[name])]
    assert not bad, f"fields differ from the JAX package: {bad}"


def pad_events(ev: np.ndarray, num_events: int = E_PAD, num_workflows: int = 0) -> np.ndarray:
    """Pad a [W, E, 18] corpus with no-op rows (id 0, type -1) to
    [max(W, num_workflows), num_events, 18]."""
    W, E, L = ev.shape
    assert E <= num_events, (E, num_events)
    out = np.zeros((max(W, num_workflows), num_events, L), dtype=ev.dtype)
    out[:, :, 1] = -1
    out[:W, :E] = ev
    return out


#: the corpora the wirec tests pack: the five suites, the overflow suite,
#: the lane-level random corpus (no-op rows between real ones), the
#: adversarial values of tests/test_wirec.py and all-padding workflows
WIREC_KINDS = ("basic", "echo_signal", "timer_retry", "concurrent_child", "ndc", "overflow",
               "lanes", "adversarial", "empty")


def wirec_corpus(kind: str, num_workflows: int = 16) -> np.ndarray:
    """[W, E, 18] int64 lanes of one WIREC_KINDS corpus, made from a seed."""
    from cadence_tpu.gen.corpus import generate_corpus
    from cadence_tpu.ops.encode import NUM_LANES, encode_corpus
    from cadence_tpu_torch.gen.lanes import random_lanes

    if kind == "lanes":
        return random_lanes(num_workflows, 64, 23)
    if kind == "adversarial":  # wide random values, negatives, 64-bit magnitudes
        rng = np.random.default_rng(3)
        W, E = 8, 32
        ev = np.zeros((W, E, NUM_LANES), dtype=np.int64)
        n = rng.integers(5, E, size=W)
        for w in range(W):
            ev[w, :n[w], 0] = np.arange(1, n[w] + 1)
            ev[w, :n[w], 1] = rng.integers(0, 40, n[w])
            ev[w, :n[w], 3] = rng.integers(-2**62, 2**62, n[w])
            ev[w, :n[w], 7] = rng.integers(-2**31, 2**31, n[w])
            ev[w, n[w]:, 1] = -1
        return ev
    if kind == "empty":  # all-padding rows beside one short workflow
        ev = np.zeros((4, 16, NUM_LANES), dtype=np.int64)
        ev[:, :, 1] = -1
        ev[0, :3, 0] = [1, 2, 3]
        ev[0, :3, 1] = [0, 2, 3]
        return ev
    return encode_corpus(generate_corpus(kind, num_workflows, seed=9, target_events=80))


def assert_corpora_equal(got, want) -> None:
    """Two WirecCorpus values hold the same profile and the same bytes."""
    assert tuple(got.profile) == tuple(want.profile)
    for name in ("slab", "bases", "n_events"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), name


#: the two packages the engine tests build stores for
PACKAGES = ("cadence_tpu", "cadence_tpu_torch")


def package(pkg: str, module: str):
    """`pkg.module` (for example package("cadence_tpu_torch", "gen.corpus"))."""
    import importlib

    return importlib.import_module(f"{pkg}.{module}")


def stores_with(hists, pkg: str):
    """(Stores of package `pkg`, keys): each history appended to the history
    store and, as its live state, the same package's oracle MutableState
    of it upserted into the execution store."""
    stores = package(pkg, "engine.persistence").Stores()
    builder = package(pkg, "oracle.state_builder").StateBuilder
    keys = []
    for h in hists:
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(builder().replay_history(h))
        keys.append(key)
    return stores, keys


def reset_port_tiers() -> None:
    """Stop every serving drain thread and free every resident slab of the
    port (what tests/conftest.py does for the JAX package's tiers), so no
    thread or pinned slab leaks across the tests of an xdist worker."""
    from cadence_tpu_torch.engine import resident, serving

    serving.reset_all()
    resident.reset_all()


def reset_port_globals() -> None:
    """Everything tests/conftest.py resets for the JAX package, for the
    port: the default registry and tracer, the circuit breakers, the wire
    chaos injector, the armed crashpoint, the quota limiters, the telemetry
    plane, and every serving drain thread, resident slab and visibility
    view."""
    from cadence_tpu_torch.engine import crashpoints, visibility_device
    from cadence_tpu_torch.rpc import chaos
    from cadence_tpu_torch.utils import (circuitbreaker, flightrecorder, hostprof, metrics,
                                         quotas, timeseries, tracing)

    metrics.DEFAULT_REGISTRY.reset()
    tracing.DEFAULT_TRACER.reset()
    circuitbreaker.DEFAULT_BREAKERS.reset()
    chaos.uninstall()
    crashpoints.uninstall()
    quotas.reset_all()
    flightrecorder.reset_all()
    timeseries.reset_all()
    hostprof.reset_all()
    reset_port_tiers()
    visibility_device.reset_all()


def overflow_chain(pkg):
    """tests/test_resident.py's three-stage history in package pkg: the
    prefix pins 12 activities; append 1 schedules 10 more (22 at once:
    TABLE_OVERFLOW at base K) and completes the 8 oldest; append 2
    completes the 6 in the widened slots (narrowable again)."""
    gen = package(pkg, "gen.corpus")
    ET = package(pkg, "core.enums").EventType
    w = gen.HistoryWriter(workflow_id="ovf")
    gen._start(w, random.Random(0))
    cyc = gen._run_decision(w, 2)
    gen._begin_decision_completed_batch(w, cyc)

    def schedule(prefix, n):
        return [w.add(ET.ActivityTaskScheduled, activity_id=f"{prefix}{i}", task_list="res-tl",
                      schedule_to_start_timeout_seconds=60,
                      schedule_to_close_timeout_seconds=120,
                      start_to_close_timeout_seconds=60, heartbeat_timeout_seconds=0)
                for i in range(n)]

    prefix_acts = schedule("p", 12)
    sched = gen._schedule_decision(w, in_batch=True)
    w.end_batch()
    prefix = list(w.batches)

    def complete(act_ev):
        started = w.single(ET.ActivityTaskStarted, scheduled_event_id=act_ev.id,
                           request_id=f"poll-{act_ev.id}")
        w.begin_batch()
        w.add(ET.ActivityTaskCompleted, scheduled_event_id=act_ev.id, started_event_id=started.id)
        w.end_batch()

    cyc = gen._run_decision(w, sched)
    gen._begin_decision_completed_batch(w, cyc)
    flood_acts = schedule("f", 10)
    gen._schedule_decision(w, in_batch=True)
    w.end_batch()
    for ev in prefix_acts[:8]:
        complete(ev)
    append1 = list(w.batches)
    for ev in flood_acts[4:]:
        complete(ev)
    return prefix, append1, list(w.batches)


def reference_native() -> None:
    """Load the JAX package's native libraries for a test that compares
    with them. Its build writes each library through one fixed temporary
    name, so test workers that collect at the same moment on a fresh
    checkout can race on it, and a worker that lost the race remembers the
    failure for the rest of its life. By the time a test runs, collection
    is over and the winner's library is in place: forget the failures and
    load again."""
    from cadence_tpu.native import build as jb

    jb._load_failed.clear()
    for load in (jb.load, jb.load_wirec, jb.load_generator):
        assert load() is not None, f"the JAX package's {load.__name__} found no library"


#: A stand-in for the CUDA runtime, enough for a csrc/ kernel's device code
#: to compile as host C++: the qualifiers empty, blockIdx and threadIdx
#: (thread-local) globals that a host loop sets, CUDA's vector types, and
#: the intrinsics the kernels use as the compiler's builtins, plain loads
#: and stores, or their bit arithmetic (one thread at a time: atomics are
#: plain updates). cp.async (cuda_pipeline.h's primitives) queues each
#: thread's copies in groups and makes them at __pipeline_wait_prior, so a
#: stage read before its wait holds the old bytes, as on the card.
#: __shfl_xor_sync and __shfl_up_sync work over a simulated warp:
#: host_warp(fn) runs fn(lane) for 32 lanes as threads that meet at each
#: shuffle and at each __syncwarp (the lanes find their cp.async queues
#: under a lock). A ballot has no stand-in: a harness makes a warp's ballot
#: itself.
HOST_CUDA_RUNTIME = r"""
#pragma once
#include <atomic>
#include <cstdint>
#include <cstring>
#include <climits>
#include <map>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(x) __attribute__((aligned(x)))
#define __grid_constant__
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 blockIdx, threadIdx;
inline uint3 blockDim;
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct longlong2 { long long x, y; };
inline longlong2 make_longlong2(long long a, long long b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline void __syncthreads() {}
template <class T> inline void __stcs(T* p, T v) { *p = v; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long old = *p;
  *p += v;
  return old;
}
inline unsigned long long atomicExch(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p = v;
  return old;
}
inline void __threadfence() {}
inline double __longlong_as_double(long long x) { double d; std::memcpy(&d, &x, 8); return d; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (static_cast<unsigned long long>(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
struct HostCopy { void* dst; const void* src; size_t n, zfill; };
struct HostPipe { std::vector<HostCopy> open; std::vector<std::vector<HostCopy>> groups; };
inline std::map<std::pair<unsigned, unsigned>, HostPipe> host_pipes;  // by (block, thread)
inline std::mutex host_pipes_mutex;  // a warp's lanes, run as threads, find their pipes at once
inline HostPipe& host_pipe() {
  std::lock_guard<std::mutex> lock(host_pipes_mutex);
  return host_pipes[{blockIdx.x, threadIdx.x}];
}
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  host_pipe().open.push_back({dst, src, size, zfill});
}
inline void __pipeline_commit() {
  HostPipe& p = host_pipe();
  p.groups.push_back(std::move(p.open));
  p.open.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
  HostPipe& p = host_pipe();
  while (p.groups.size() > prior) {
    for (const HostCopy& c : p.groups.front()) {
      std::memcpy(c.dst, c.src, c.n - c.zfill);
      std::memset(static_cast<char*>(c.dst) + c.n - c.zfill, 0, c.zfill);
    }
    p.groups.erase(p.groups.begin());
  }
}
// The warp's barrier: the 32nd lane to arrive opens the next generation;
// the others yield until it has (a condition variable's wake of 31
// threads costs a kernel's host test tens of seconds).
struct HostWarp {
  std::atomic<int> arrived{0};
  std::atomic<unsigned long long> generation{0};
  unsigned long long value[32];
};
inline HostWarp* host_warp_now = nullptr;
inline thread_local int host_lane = 0;
inline void host_warp_meet() {
  HostWarp& w = *host_warp_now;
  const unsigned long long g = w.generation.load(std::memory_order_acquire);
  if (w.arrived.fetch_add(1, std::memory_order_acq_rel) == 31) {
    w.arrived.store(0, std::memory_order_relaxed);
    w.generation.store(g + 1, std::memory_order_release);
  } else {
    while (w.generation.load(std::memory_order_acquire) == g) std::this_thread::yield();
  }
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int lane_mask, int = 32) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  std::memcpy(&host_warp_now->value[host_lane], &v, sizeof(T));
  host_warp_meet();
  T r;
  std::memcpy(&r, &host_warp_now->value[host_lane ^ lane_mask], sizeof(T));
  host_warp_meet();
  return r;
}
// A lane takes lane - delta's value, and keeps its own below delta.
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned delta, int = 32) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  std::memcpy(&host_warp_now->value[host_lane], &v, sizeof(T));
  host_warp_meet();
  T r = v;
  if (host_lane >= static_cast<int>(delta))
    std::memcpy(&r, &host_warp_now->value[host_lane - delta], sizeof(T));
  host_warp_meet();
  return r;
}
// Every lane waits for the warp; what a lane wrote before is seen after.
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { host_warp_meet(); }
template <class F> inline void host_warp(F fn) {
  HostWarp w;
  host_warp_now = &w;
  const uint3 b = blockIdx;
  std::vector<std::thread> lanes;
  for (int l = 0; l < 32; ++l)
    lanes.emplace_back([&, l] {
      blockIdx = b;
      host_lane = l;
      fn(l);
    });
  for (std::thread& t : lanes) t.join();
  host_warp_now = nullptr;
}
"""


def host_kernel(tmp_dir, source: str, cut: str, harness: str, close: str = ""):
    """A ctypes library of cadence_tpu_torch/csrc/`source` compiled as host
    C++ against HOST_CUDA_RUNTIME: the file cut before the first `cut` (its
    launchers, which only nvcc compiles), then `close` and `harness` (C++
    that runs the kernel's blocks and threads in a host loop). Skips the
    test when the machine has no C++ compiler."""
    import ctypes
    import pathlib
    import shutil
    import subprocess

    import pytest

    import cadence_tpu_torch

    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    csrc = pathlib.Path(cadence_tpu_torch.__file__).parent / "csrc"
    text = (csrc / source).read_text()
    assert cut in text, f"{source} no longer has {cut!r}"
    tmp = pathlib.Path(tmp_dir)
    (tmp / "cuda_runtime.h").write_text(HOST_CUDA_RUNTIME)
    (tmp / "cuda_pipeline.h").write_text("#pragma once\n#include <cuda_runtime.h>\n")
    src, lib = tmp / (source + ".cpp"), tmp / (source + ".so")
    src.write_text(text[:text.index(cut)] + close + harness)
    done = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(tmp), "-I",
                           str(csrc), "-include", str(tmp / "cuda_runtime.h"), "-o", str(lib),
                           str(src)], capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, f"{source} as host C++:\n{done.stderr[-4000:]}"
    return ctypes.CDLL(str(lib))


#: the port's entry points besides Onebox that take a `device` (None: the
#: card), which ported_reference calls with `device="cpu"`: the wire
#: cluster's launchers hand it to every process they spawn, the scenarios
#: to their clusters, boxes and closing verifies, and replay_to_payload and
#: replay_corpus are the kernel replays a test holds a history to
ON_CPU = ("ReplicatedClusters", "recover_stores", "seed_workload", "CrashSim", "launch",
          "launch_group", "overload_scenario", "serving_scenario", "cluster_serving_scenario",
          "region_failover_scenario", "mixed_scenario", "visibility_scenario",
          "cluster_campaign_scenario", "run_campaign", "live_campaign_predicate",
          "interleave_scenario", "replication_interleave_scenario", "replay_to_payload",
          "replay_corpus")

#: the names the reference's tests give the CLI's `main` (which takes a
#: `device` too): `cli_main` and `cli.main`, and `main` where the file
#: imports it from the CLI under that name
CLI_MAIN = ("cli_main", "cli.main")


def _on_cpu(fn):
    """`fn` with `device="cpu"` unless the call names a device."""
    import functools

    return functools.partial(fn, device="cpu")


def ported_reference(filename: str, classes=None, tag: str = "", leave_out=()) -> dict:
    """The reference's own test module tests/`filename` pointed at the port:
    every `cadence_tpu` name rewritten to `cadence_tpu_torch`, each Onebox
    built on the CPU (`device="cpu"`), imports of modules the port does not
    have dropped, and only the test classes in `classes` kept (all when
    None), less the methods named "Class.method" in `leave_out` (those of a
    module the port does not have yet). Its module-level fixtures are
    renamed `<name>_<tag>` throughout the file and its kept classes
    `Test<Tag><Name>`, so that several ported files can share one test
    module's namespace. What is left out becomes blank lines, so each line
    keeps its number in tracebacks. The other entry points that reach a
    device (ON_CPU, and the CLI's main by its CLI_MAIN names) are called
    with `device="cpu"` too, and the file's own module marks
    (`pytestmark`, e.g. slow) go with its kept classes.
    Returns the names to put in that namespace: the kept classes and the
    renamed fixtures."""
    import ast
    import os
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), filename)
    src = open(path).read()
    lines = src.splitlines()
    tree = ast.parse(src)
    fixtures = [n.name for n in tree.body if isinstance(n, ast.FunctionDef) and any(
        "fixture" in ast.get_source_segment(src, d) for d in n.decorator_list)]

    def blank(node):
        first = min([d.lineno for d in getattr(node, "decorator_list", ())] + [node.lineno])
        lines[first - 1:node.end_lineno] = [""] * (node.end_lineno - first + 1)

    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            seg = re.sub(r"\bcadence_tpu\b", "cadence_tpu_torch",
                         ast.get_source_segment(src, node))
            try:
                exec(seg, {})
            except ImportError:
                blank(node)  # a module the port does not have
        elif isinstance(node, ast.ClassDef):
            if classes is not None and node.name not in classes:
                blank(node)
                continue
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and f"{node.name}.{item.name}" in leave_out:
                    blank(item)
    body = "\n".join(lines)
    body = re.sub(r"\bcadence_tpu\b", "cadence_tpu_torch", body)
    body = re.sub(r"\bOnebox\((\)?)", lambda mt: 'Onebox(device="cpu")' if mt.group(1)
                  else 'Onebox(device="cpu", ', body)
    body = re.sub(rf"(?<![\w.])(?<!def )((?:\w+\.)*(?:{'|'.join(ON_CPU)}))\(", r"_on_cpu(\1)(",
                  body)
    cli_names = CLI_MAIN + (("main",) if re.search(r"from cadence_tpu\.cli import main\b(?! as)", src)
                            else ())
    body = re.sub(rf"(?<![\w.])(?<!def )({'|'.join(map(re.escape, cli_names))})\(", r"_on_cpu(\1)(",
                  body)
    for name in fixtures:
        # (a keyword argument of the same name, `name=value`, stays)
        body = re.sub(rf"(?<![.\w]){name}\b(?!=[^=])", f"{name}_{tag}", body)
    namespace = {"__name__": f"tests.ported_{tag}", "__file__": path, "_on_cpu": _on_cpu}
    exec(compile(body, path, "exec"), namespace)
    out = {f"{name}_{tag}": namespace[f"{name}_{tag}"] for name in fixtures}
    module_marks = namespace.get("pytestmark", [])
    module_marks = module_marks if isinstance(module_marks, list) else [module_marks]
    for name, obj in namespace.items():
        if (isinstance(obj, type) and name.startswith("Test")
                and obj.__module__ == namespace["__name__"]):
            kept = f"Test{tag.capitalize()}{name[4:]}"
            cls = type(kept, (obj,), {})
            for mark in module_marks:  # the file's own marks (slow, ...) go with it
                cls = mark(cls)
            out[kept] = cls
    return out
