"""The port's write-ahead log and crash recovery (cadence_tpu_torch/engine/
{durability,walcheck,crashsim}.py) held to the JAX package's.

Three kinds of test:
- the reference's own classes of tests/test_durability.py and
  tests/test_crashsim.py run against the port (tests/torch_parity.py
  ported_reference: each Onebox, ReplicatedClusters, recover_stores,
  seed_workload and CrashSim on the CPU);
- WAL parity: one seeded Onebox workload (the same run, domain and request
  ids, the same manual clock) on a JSONL WAL in each package, with device
  snapshots swept into it, gives byte-equal files; and each package
  recovers the other's file to the same per-run checksums and the same
  RecoveryReport counts (the port on device="cpu"; tolerance 0);
- the device rule: recover_stores with no device named means the card.

tests/test_crashsim.py's TestFsck drives the port's CLI (`wal clean`, `wal
fsck`) on the CPU. Its TestSigkillAtCrashpoint runs a wire cluster's store
server on the CPU (`launch(..., device="cpu")`)."""
import dataclasses

import pytest
import torch

from tests.taskpoller import TaskPoller
from tests.test_torch_onebox import seeded_ids
from tests.torch_parity import PACKAGES, package, ported_reference, reset_port_globals

PORT = "cadence_tpu_torch"


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


# -- the reference's own classes against the port ----------------------------

#: methods of tests/test_crashsim.py that wait for cli.py: none since the
#: port has it (TestFsck's two CLI methods run on the CPU)
WAITS_FOR_CLI = ()

globals().update(ported_reference("test_durability.py", tag="durability"))
globals().update(ported_reference("test_crashsim.py", tag="crashsim", leave_out=WAITS_FOR_CLI))


# -- WAL parity: the same seeded workload writes the same bytes ---------------

DOMAIN = "wal-domain"
TL = "wal-tl"
SEED = 20261018


def seeded_wal(pkg: str, path: str) -> None:
    """A mixed workload on a durable Onebox of `pkg` at `path`: echo runs
    driven to completion, signal runs left open with their signal pending,
    a timer run parked on its timer, then a bulk verify and a forced
    snapshot sweep (the open runs' device rows as "snap" records). The box
    is dropped without closing, as a crash leaves it."""
    onebox = package(pkg, "engine.onebox")
    durability = package(pkg, "engine.durability")
    deciders = package(pkg, "models.deciders")
    kw = {"device": "cpu"} if pkg == PORT else {}
    with seeded_ids(SEED):
        box = onebox.Onebox(num_hosts=1, num_shards=4,
                            stores=durability.open_durable_stores(path), **kw)
        box.frontend.register_domain(DOMAIN)
        workers = {}
        for i in range(6):
            wid = f"echo-{i}"
            workers[wid] = deciders.EchoDecider(TL)
            box.frontend.start_workflow_execution(DOMAIN, wid, "echo", TL)
        for i in range(4):
            wid = f"signal-{i}"
            workers[wid] = deciders.SignalDecider(expected_signals=2)
            box.frontend.start_workflow_execution(DOMAIN, wid, "signal", TL)
        workers["timer-0"] = deciders.TimerDecider(fire_seconds=600)
        box.frontend.start_workflow_execution(DOMAIN, "timer-0", "timer", TL)
        TaskPoller(box, DOMAIN, TL, workers).drain()
        for i in range(2):
            box.frontend.signal_workflow_execution(DOMAIN, f"signal-{i}", "go",
                                                   request_id=f"rid-{i}")
        TaskPoller(box, DOMAIN, TL, workers).drain()
        box.tpu.verify_all()
        box.tpu.snapshot_sweep(force=True)
    del box


def wal_records(path: str):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def both_wals(tmp_path_factory):
    """{package: JSONL WAL path} of seeded_wal in each package."""
    from tests.torch_parity import reset_port_tiers

    out = {}
    for pkg in PACKAGES:
        path = str(tmp_path_factory.mktemp(f"wal-{pkg}") / "wal.jsonl")
        seeded_wal(pkg, path)
        out[pkg] = path
    reset_port_tiers()
    return out


def test_wals_are_byte_equal(both_wals):
    import json

    jax_bytes, port_bytes = (wal_records(both_wals[p]) for p in PACKAGES)
    kinds = [json.loads(line)["t"] for line in port_bytes.splitlines()]
    assert kinds.count("snap") >= 4, kinds  # the open runs' device rows
    assert {"ver", "d", "s", "h", "cur"} <= set(kinds)
    assert port_bytes == jax_bytes


def recovered(pkg: str, path: str):
    """(per-run checksums, report counts) of `pkg`'s recover_stores over
    a copy of `path` (recovery appends to the log it reads)."""
    import shutil

    copy = path + f".{pkg}.jsonl"
    shutil.copyfile(path, copy)
    durability = package(pkg, "engine.durability")
    Checksum = package(pkg, "core.checksum").Checksum
    kw = {"device": "cpu"} if pkg == PORT else {}
    stores, report = durability.recover_stores(copy, **kw)
    sums = {key: Checksum.of(stores.execution.get_workflow(*key)).value
            for key in stores.execution.list_executions()}
    counts = dataclasses.asdict(report)
    counts["divergent"] = sorted(counts["divergent"])
    counts["quarantined"] = sorted(counts["quarantined"])
    stores.wal.close()
    return sums, counts


@pytest.mark.parametrize("writer", PACKAGES)
def test_each_package_recovers_the_others_wal(both_wals, writer):
    from tests.torch_parity import reset_port_tiers

    jax_sums, jax_counts = recovered("cadence_tpu", both_wals[writer])
    port_sums, port_counts = recovered(PORT, both_wals[writer])
    reset_port_tiers()
    assert len(port_sums) == 11
    assert port_sums == jax_sums
    assert port_counts == jax_counts
    assert port_counts["snapshot_hydrated"] >= 4
    assert port_counts["open_workflows"] == 5
    assert not port_counts["divergent"]


def test_no_device_named_means_the_card(tmp_path, monkeypatch):
    from cadence_tpu_torch.engine import durability

    path = str(tmp_path / "wal.jsonl")
    durability.open_durable_stores(path).wal.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        durability.recover_stores(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        durability.recover_stores(path, rebuild_on_device=False)
    # the pure-host oracle path names no device
    stores, report = durability.recover_stores(path, verify_on_device=False,
                                               rebuild_on_device=False)
    assert report.ok and report.executions_rebuilt == 0
    stores.wal.close()
