"""The port's wire layer (cadence_tpu_torch/rpc/{wire,chaos,client,
storeserver,server,cluster}.py) held to the JAX package's.

Three kinds of test:
- the reference's own classes run against the port (tests/torch_parity.py
  ported_reference): every wire cluster they launch runs its store server
  and service hosts as `cadence_tpu_torch.rpc.*` processes on the CPU
  (`launch(..., device="cpu")`);
- guard tests of the port's seams: every process a launcher spawns is the
  port's and sets no JAX variable, a serving host asked for the card on a
  box without one fails at boot (and `launch` raises), the admin ops that
  return device-tier reports return no torch tensor, a host's kernel
  launches ride its admin_metrics snapshot, and `native.build.wirec_cached`
  agrees with the JAX package's;
- a drift test: each copied module's text equals the JAX module's once
  `cadence_tpu` reads `cadence_tpu_torch`, except the port's own hunks,
  which tests/torch_hunks/<package>_<module>.diff holds as a unified diff
  (the device each process and entry point takes, the library load and
  build, the launch counts, and comments reworded where the JAX text
  speaks of compiles the port does not make).

The reference's wire classes run in other port files too: the rpc methods
of tests/test_resilience.py's TestCircuitBreaker and TestDeadline, and
tests/test_canary.py's wire class, in tests/test_torch_admin.py; its
TestRetryPolicy and tests/test_observability.py's TestTracing in
tests/test_torch_cluster_modules.py; tests/test_chaos_soak.py and
tests/test_telemetry.py's wire classes in tests/test_torch_rpc_fleet.py."""
import os
import subprocess
import sys

import pytest
import torch

from tests.torch_parity import ported_reference, reset_port_globals
from tests.torch_port_drift import assert_port_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


# -- the reference's own classes against the port ----------------------------

globals().update(ported_reference("test_multiprocess.py", tag="multiprocess"))
globals().update(ported_reference("test_resilience.py",
                                  classes=("TestStaleConnections", "TestWireChaos"),
                                  tag="resilience"))
globals().update(ported_reference("test_observability.py", classes=("TestCrossProcessTraces",),
                                  tag="observability"))
globals().update(ported_reference("test_resident.py", classes=("TestMetricsSurface",),
                                  tag="resident"))


# -- guard tests of the port's seams --------------------------------------------


class _Spawned:
    """A stand-in for subprocess.Popen that records each command and
    environment and never starts a process."""

    calls = []

    def __init__(self, cmd, env=None, **_kw):
        self.cmd, self.env, self.returncode = list(cmd), env, None
        _Spawned.calls.append(self)

    def poll(self):
        return self.returncode

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode

    send_signal = kill


@pytest.fixture
def spawned(monkeypatch):
    """Every process rpc/cluster.py spawns, recorded and never started;
    each pings back with every host name the launch has spawned."""
    from cadence_tpu_torch.rpc import cluster

    _Spawned.calls = []

    def names():
        return [c.cmd[c.cmd.index("--name") + 1] for c in _Spawned.calls if "--name" in c.cmd]

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(cluster.subprocess, "Popen", _Spawned)
    monkeypatch.setattr(cluster, "_wait_listening", lambda port, proc, timeout=30.0: None)
    monkeypatch.setattr(cluster, "call", lambda address, req, timeout=None:
                        ("pong", "", [], names()))
    return _Spawned.calls


def _assert_port_processes(calls, device):
    assert calls
    for c in calls:
        assert c.cmd[:2] == [sys.executable, "-m"], c.cmd
        assert c.cmd[2] in ("cadence_tpu_torch.rpc.server", "cadence_tpu_torch.rpc.storeserver")
        assert c.cmd[c.cmd.index("--device") + 1] == device, c.cmd
        assert "JAX_PLATFORMS" not in c.env
        assert c.env["PYTHONPATH"].split(os.pathsep)[0] == ROOT


@pytest.mark.parametrize("device", ("cpu", None))
def test_launch_spawns_the_ports_processes(spawned, monkeypatch, device):
    """launch, add_host, relaunch_store and launch_group spawn
    `cadence_tpu_torch.rpc.*` with the device named ("cuda" for None),
    and set no JAX variable; a serving launch on the card builds the
    kernel library once, before the first host."""
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.rpc.cluster import launch, launch_group

    builds = []
    monkeypatch.setattr(_build, "build", lambda: builds.append(len(spawned)))
    c = launch(num_hosts=2, num_shards=4, wal="/nonexistent/w.jsonl",
               env_extra={"CADENCE_TPU_SERVING": "1"}, device=device)
    c.add_host()
    c.kill_store()
    c.relaunch_store()
    g = launch_group(num_hosts=1, num_shards=4, device=device)
    want = "cuda" if device is None else device
    _assert_port_processes(spawned, want)
    assert len(spawned) == 3 + 1 + 1 + 4
    # a serving launch on the card built once, before anything spawned
    assert builds == ([0] if device is None else [])
    c.stop()
    g.stop()


def test_no_port_source_names_the_jax_package_or_its_platform():
    """The spawn strings the import walk cannot see: every `-m` module a
    port source names is the port's, and none sets JAX_PLATFORMS."""
    import re

    pkg = os.path.join(ROOT, "cadence_tpu_torch")
    seen = 0
    for dirpath, _dirs, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, name)).read()
            assert "JAX_PLATFORMS" not in text, name
            for module in re.findall(r'"-m",\s*"([\w.]+)"', text):
                assert module.startswith("cadence_tpu_torch."), (name, module)
                seen += 1
    assert seen >= 3  # the store server, the service host, the recovery store


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a box without a card")
def test_serving_host_without_a_card_fails_at_boot(monkeypatch):
    """A service host asked for the card (the default) on a box without
    one exits non-zero at boot, and launch raises rather than hand out a
    cluster that serves from the CPU, leaving no process it spawned
    running."""
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.rpc import cluster as cluster_mod
    from cadence_tpu_torch.rpc.cluster import free_port, launch, process_env

    env = dict(process_env(), CADENCE_TPU_SERVING="1")
    done = subprocess.run([sys.executable, "-m", "cadence_tpu_torch.rpc.server", "--name",
                           "h-0", "--port", str(free_port()), "--store", "127.0.0.1:1"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr
    monkeypatch.setattr(_build, "build", lambda: None)  # no nvcc on this box either
    started = []
    real_popen = cluster_mod.subprocess.Popen

    def popen(*args, **kwargs):
        started.append(real_popen(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(cluster_mod.subprocess, "Popen", popen)
    with pytest.raises(RuntimeError, match="exited"):
        launch(num_hosts=2, num_shards=2, env_extra={"CADENCE_TPU_SERVING": "1"})
    # and the launch stopped the store server and every host it had spawned
    assert len(started) == 3
    assert all(p.poll() is not None for p in started)


def _tensors_in(value, path="result"):
    """Paths of every torch tensor inside `value` (dicts, lists, tuples,
    sets and dataclass-like objects walked)."""
    if isinstance(value, torch.Tensor):
        return [path]
    if isinstance(value, dict):
        return [p for k, v in value.items() for p in _tensors_in(k, f"{path}.key")
                + _tensors_in(v, f"{path}[{k!r}]")]
    if isinstance(value, (list, tuple, set, frozenset)):
        return [p for i, v in enumerate(value) for p in _tensors_in(v, f"{path}[{i}]")]
    if hasattr(value, "__dict__") and not isinstance(value, type):
        return _tensors_in(vars(value), path)
    return []


def test_admin_reports_carry_no_tensors():
    """What crosses the wire from a serving host's device tier (the
    cluster doc with each resident row's checksum, a drain's and a
    prehydration's migration report) is ints, strings, tuples and numpy,
    never a torch tensor; the host's launch counts and its snapshot
    writes into the store server ride admin_metrics."""
    import time

    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.rpc.cluster import launch
    from cadence_tpu_torch.rpc.server import SCOPE_LAUNCHES

    c = launch(num_hosts=1, num_shards=4, device="cpu",
               env_extra={"CADENCE_TPU_SERVING": "1", "CADENCE_TPU_SERVING_WARM": "0",
                          "CADENCE_TPU_SNAPSHOT_MIN_EVENTS": "1",
                          "CADENCE_TPU_SNAPSHOT_EVERY_EVENTS": "1"})
    try:
        fe = c.frontend(0)
        fe.register_domain("nt")
        for i in range(3):
            fe.start_workflow_execution("nt", f"nt-{i}", "t", "nt-tl", execution_timeout=3600)
        done, deadline = 0, time.monotonic() + 30
        while done < 3 and time.monotonic() < deadline:
            resp = fe.poll_for_decision_task("nt", "nt-tl", wait_seconds=0.3)
            if resp is not None and resp.token is not None:
                fe.respond_decision_task_completed(resp.token, [])
                done += 1
        for i in range(3):
            fe.signal_workflow_execution("nt", f"nt-{i}", "s", request_id=f"nt-r-{i}")
        host = sorted(c.hosts)[0]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            doc = c.admin(host, "admin_cluster", True)
            if doc["resident_rows"] and doc["serving"]["queue_depth"] == 0:
                break
            time.sleep(0.2)
        # the serving flushes write snapshots into the store server and
        # publish its size (a gauge the JAX package's len() cannot read over
        # the wire)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            snap = c.admin(host, "admin_metrics")["snapshot"]
            if snap["tpu.snapshot"]["snapshot-entries"] >= 3:
                break
            time.sleep(0.2)
        assert snap["tpu.snapshot"]["writes"] >= 3
        assert snap["tpu.snapshot"]["snapshot-entries"] >= 3
        # the plain versions run on the CPU and count nothing
        assert snap[SCOPE_LAUNCHES] == {name: 0.0 for name in _build.launches}
        assert doc["launch_shapes"] == []
        assert doc["device"] == "cpu"
        assert doc["resident_rows"], doc
        for result in (doc, c.admin(host, "admin_drain"), c.admin(host, "admin_prehydrate")):
            assert not _tensors_in(result), _tensors_in(result)
        for key, (crc, branch, addr) in doc["resident_rows"].items():
            assert type(crc) is int and type(branch) is int
            assert all(type(x) is int for x in addr)
    finally:
        c.stop()


def test_wirec_cached_agrees_with_jax(tmp_path, monkeypatch):
    """The build-cache probe: true in both packages once each has built
    its wirec library, false in both with an empty build directory."""
    from cadence_tpu.native import build as jax_build
    from cadence_tpu_torch.native import build as port_build
    from tests.torch_parity import reference_native

    if not port_build.available():
        pytest.skip("no g++")
    reference_native()
    assert port_build.load_wirec() is not None
    assert port_build.wirec_cached() is jax_build.wirec_cached() is True
    monkeypatch.setattr(port_build, "_BUILD_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_build, "_BUILD_DIR", str(tmp_path / "jax"))
    assert port_build.wirec_cached() is jax_build.wirec_cached() is False


# -- drift: the copied modules are the JAX package's ---------------------------

COPIED = ("rpc/__init__", "rpc/wire", "rpc/chaos", "rpc/client", "rpc/storeserver",
          "rpc/server", "rpc/cluster")


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_one(module):
    assert_port_text(module)
