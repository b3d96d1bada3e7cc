"""The leaves and the wiring of the port's host control plane
(cadence_tpu_torch/engine/{admin,batcher,shadower,redirection,domainrepl,
canary}.py, utils/{circuitbreaker,deadline}.py), the modules of the
write-ahead log and of multi-region, and graft_entry.py, held to the JAX
package's.

Three kinds of test:
- the reference's own classes run against the port (tests/torch_parity.py
  ported_reference, each Onebox on the CPU);
- a drift test: each copied module's text equals the JAX module's once
  `cadence_tpu` reads `cadence_tpu_torch`, except the port's own hunks
  (the device each entry point takes, and the comments that cite the JAX
  package's review history, reworded), kept as unified diffs in
  tests/torch_hunks/ (tests/torch_port_drift.py);
- graft_entry.py's replay step against the JAX package's, and its dry run
  on a mesh of CPU slices.

tests/test_canary.py's TestCanaryAgainstWireCluster and the rpc methods of
tests/test_resilience.py's TestCircuitBreaker and TestDeadline launch their
wire clusters on the CPU (`launch(..., device="cpu")`); its TestRetryPolicy
runs in tests/test_torch_cluster_modules.py, and its TestStaleConnections
and TestWireChaos in tests/test_torch_rpc.py.

Left out:
- of tests/test_visibility_device.py's TestRoutingAndOps,
  test_kill_switch_routes_host: it builds a bare VisibilityStore (its
  device is the card; tests/test_torch_visibility_device.py holds it on
  the CPU);
- tests/test_admin_cli.py's TestCLI, TestOpsVerbs and TestProfileVerb,
  the CLI's classes, which run in tests/test_torch_cli.py."""
import numpy as np
import pytest

from tests.torch_parity import ported_reference, reset_port_globals
from tests.torch_port_drift import assert_port_text


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


# -- the reference's own classes against the port ----------------------------

#: the method of TestRoutingAndOps that builds no Onebox
BARE_VISIBILITY_STORE = ("TestRoutingAndOps.test_kill_switch_routes_host",)

globals().update(ported_reference("test_shadower.py", tag="shadower"))
globals().update(ported_reference("test_canary.py", tag="canary"))
globals().update(ported_reference("test_resilience.py", classes=("TestCircuitBreaker", "TestDeadline"),
                                  tag="resilience"))
globals().update(ported_reference("test_visibility_device.py", classes=("TestRoutingAndOps",),
                                  tag="visibility", leave_out=BARE_VISIBILITY_STORE))
globals().update(ported_reference("test_admin_cli.py", classes=("TestAdminHandler",), tag="admin"))
globals().update(ported_reference("test_batch_log_authz.py", tag="batch"))
globals().update(ported_reference("test_resident.py", classes=("TestAdminResident",),
                                  tag="resident"))
globals().update(ported_reference("test_telemetry.py", classes=("TestAdminTelemetry",),
                                  tag="telemetry"))


def test_admin_verify_runs_on_the_box_device():
    """AdminHandler.verify is the box's bulk verify on the box's device,
    with the JAX package's result on the same workflows."""
    import torch

    from cadence_tpu.engine.admin import AdminHandler as JaxAdmin
    from cadence_tpu.engine.onebox import Onebox as JaxOnebox
    from cadence_tpu_torch.engine.admin import AdminHandler
    from cadence_tpu_torch.engine.onebox import Onebox
    from tests.test_torch_onebox import seeded_ids

    results = []
    for make, admin in ((JaxOnebox, JaxAdmin), (lambda **kw: Onebox(device="cpu", **kw),
                                                AdminHandler)):
        with seeded_ids(5):
            box = make(num_hosts=1, num_shards=4)
            box.frontend.register_domain("adm")
            for i in range(3):
                box.frontend.start_workflow_execution("adm", f"wf-{i}", "t", "tl")
            box.pump_once()
            result = admin(box).verify()
        results.append((result.ok, result.verified_on_device, sorted(result.divergent)))
        if admin is AdminHandler:
            assert box.tpu.device == torch.device("cpu")
    assert results[0] == results[1]
    assert results[1][:2] == (True, 3)


# -- drift: the copied modules are the JAX package's ---------------------------

COPIED = ("utils/circuitbreaker", "utils/deadline", "engine/batcher", "engine/shadower",
          "engine/redirection", "engine/domainrepl", "engine/admin", "engine/durability",
          "engine/walcheck", "engine/crashsim", "engine/multicluster",
          "engine/failovermanager", "engine/canary")


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_one(module):
    assert_port_text(module)


# -- graft_entry.py -------------------------------------------------------------


def test_entry_step_equals_jax():
    import jax.numpy as jnp

    import __graft_entry__
    from cadence_tpu.ops.replay import replay_to_payload
    from cadence_tpu_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    rows, errors = fn(*args)
    want_rows, want_errors = replay_to_payload(jnp.asarray(__graft_entry__._tiny_events(8)))
    assert args[0].shape[0] == 8
    assert np.array_equal(args[0].numpy(), __graft_entry__._tiny_events(8))
    assert np.array_equal(rows.numpy(), np.asarray(want_rows))
    assert np.array_equal(errors.numpy(), np.asarray(want_errors))


@pytest.mark.parametrize("n", (1, 2, 4))
def test_dryrun_on_cpu_slices(n, capsys):
    import json

    from cadence_tpu_torch.graft_entry import dryrun_multichip

    line = dryrun_multichip(n, devices=["cpu"] * n, min_workflows=160)
    assert line["devices"] == n and line["workflows"] >= 160
    assert line["workflows"] % n == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"sharded_scaling": line}


def test_entry_without_a_card_raises(monkeypatch):
    import torch

    from cadence_tpu_torch import graft_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
