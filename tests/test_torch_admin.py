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
  (the device each entry point takes) and the comments that cite the JAX
  package's review history, reworded; both are listed here;
- graft_entry.py's replay step against the JAX package's, and its dry run
  on a mesh of CPU slices.

Left out, each waiting for a module the port has not taken yet:
- tests/test_canary.py's TestCanaryAgainstWireCluster (rpc/cluster.py);
- of tests/test_resilience.py's TestCircuitBreaker, the three
  `*_not_charged_to_breaker` methods and test_pool_sheds_when_breaker_open,
  and of its TestDeadline, test_expired_budget_fails_before_dialing,
  test_server_rejects_expired_envelope and test_budget_rides_the_wire (all
  rpc/: the store server, the client pool and the wire); its
  TestRetryPolicy runs in tests/test_torch_cluster_modules.py, and its
  TestStaleConnections and TestWireChaos are rpc/ throughout;
- of tests/test_visibility_device.py's TestRoutingAndOps, every method but
  test_onebox_frontend_and_admin_rollup: the others build a bare
  VisibilityStore (its device is the card; tests/test_torch_visibility_
  device.py holds them on the CPU) or wait for loadgen/;
- tests/test_admin_cli.py's TestCLI, TestOpsVerbs and TestProfileVerb
  (cli.py)."""
import re
from pathlib import Path

import numpy as np
import pytest

from tests.torch_parity import ported_reference, reset_port_globals


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


# -- the reference's own classes against the port ----------------------------

#: methods of the kept classes that wait for rpc/
WAITS_FOR_RPC = (
    "TestCircuitBreaker.test_relayed_connection_error_not_charged_to_breaker",
    "TestCircuitBreaker.test_local_encode_failure_not_charged_to_breaker",
    "TestCircuitBreaker.test_budget_exhausted_timeout_not_charged_to_breaker",
    "TestCircuitBreaker.test_pool_sheds_when_breaker_open",
    "TestDeadline.test_expired_budget_fails_before_dialing",
    "TestDeadline.test_server_rejects_expired_envelope",
    "TestDeadline.test_budget_rides_the_wire")
#: methods of TestRoutingAndOps that build no Onebox
BARE_VISIBILITY_STORE = ("TestRoutingAndOps.test_kill_switch_routes_host",
                         "TestRoutingAndOps.test_query_heavy_loadgen_ops")

globals().update(ported_reference("test_shadower.py", tag="shadower"))
globals().update(ported_reference("test_canary.py", classes=("TestCanaryLoop",), tag="canary"))
globals().update(ported_reference("test_resilience.py", classes=("TestCircuitBreaker", "TestDeadline"),
                                  tag="resilience", leave_out=WAITS_FOR_RPC))
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

ROOT = Path(__file__).resolve().parent.parent
COPIED = ("utils/circuitbreaker", "utils/deadline", "engine/batcher", "engine/shadower",
          "engine/redirection", "engine/domainrepl", "engine/admin", "engine/durability",
          "engine/walcheck", "engine/crashsim", "engine/multicluster",
          "engine/failovermanager", "engine/canary")
#: the port's own hunks, as (the JAX text, the port's text): the device
#: each entry point that reaches one takes, and the docstrings that say so
PORT_HUNKS = {
    "engine/admin": (
        ("        the device-served/fallback path mix, parity counters and the\n"
         "        compile-cache hit/miss split (engine/visibility_device.py) —",
         "        the device-served/fallback path mix and parity counters\n"
         "        (engine/visibility_device.py; the port keeps no kernel-variant\n"
         "        cache, so the view has no compile-cache hit/miss split) —"),
    ),
    "engine/durability": (
        ("  available.\n\nDeliberate deviations",
         "  available.\n"
         "\n"
         "The device half of recovery (the batched rebuild and the bulk verify) runs\n"
         "on one device: `recover_stores(device=None)` means the card, and without\n"
         "one it raises rather than recovering through the oracle; the CPU is used\n"
         "only when the caller names it. `rebuild_on_device=False` with\n"
         "`verify_on_device=False` is the pure-host oracle path and names no device.\n"
         "\nDeliberate deviations"),
        ("from ..core.events import HistoryBatch\n",
         "from ..core.events import HistoryBatch\nfrom ..device import resolve_device\n"),
        ("History: v1 = round-2 record set;", "History: v1 = the first record set;"),
        ("                   layout=None, rebuild_on_device: bool = True\n",
         "                   layout=None, rebuild_on_device: bool = True, device=None\n"),
        ("    owner's) and runs the task refresher for open workflows.\n    \"\"\"\n",
         "    owner's) and runs the task refresher for open workflows.\n\n"
         "    Steps 2-3 run on `device` (None: the card, raising without one) unless\n"
         "    both `rebuild_on_device` and `verify_on_device` are off.\n    \"\"\"\n"
         "    if rebuild_on_device or verify_on_device:\n"
         "        device = resolve_device(device)\n"),
        ("referenced_runs, rebuild_on_device)", "referenced_runs, rebuild_on_device, device)"),
        ("rebuild_on_device: bool = True) -> RecoveryReport:",
         "rebuild_on_device: bool = True, device=None) -> RecoveryReport:"),
        ("DeviceRebuilder(layout)", "DeviceRebuilder(layout, device=device)"),
        ("TPUReplayEngine(stores, layout).verify_all()",
         "TPUReplayEngine(stores, layout, device=device).verify_all()"),
    ),
    "engine/walcheck": (
        ("rebuild_on_device: bool = False) -> FsckReport:",
         "rebuild_on_device: bool = False, device=None) -> FsckReport:"),
        ("rebuild_on_device=rebuild_on_device)",
         "rebuild_on_device=rebuild_on_device,\n"
         "                                      device=device)"),
    ),
    "engine/crashsim": (
        ("host work — the TPU bulk-verify path has its own parity suite.\n",
         "host work — the TPU bulk-verify path has its own parity suite.\n"
         "\n"
         "The Oneboxes built here (the seeded workload's, and the one each cut's\n"
         "refresh check wires over the recovered stores) take the `device` the\n"
         "caller names: None means the card, and without one construction raises.\n"),
        ("    def __init__(self, wal_path: str, workdir: Optional[str] = None) -> None:\n"
         "        self.wal_path = wal_path\n",
         "    def __init__(self, wal_path: str, workdir: Optional[str] = None,\n"
         "                 device=None) -> None:\n"
         "        self.wal_path = wal_path\n"
         "        #: the device of the refresh check's Onebox (None = the card)\n"
         "        self.device = device\n"),
        ("    @staticmethod\n    def _check_refresh(stores, result",
         "    def _check_refresh(self, stores, result"),
        ("Onebox(num_hosts=1, num_shards=4, stores=stores)",
         "Onebox(num_hosts=1, num_shards=4, stores=stores,\n"
         "                     device=self.device)"),
        ("num_workflows: int = 4) -> None:", "num_workflows: int = 4, device=None) -> None:"),
        ("stores=open_durable_stores(wal_path))",
         "stores=open_durable_stores(wal_path), device=device)"),
    ),
    "engine/multicluster": (
        ("transition in the reference).\n\"\"\"",
         "transition in the reference).\n"
         "\n"
         "Both clusters run their device tiers on one device, named at construction:\n"
         "None means the card, and without one construction raises.\n\"\"\""),
        ("standby_stores=None) -> None:", "standby_stores=None, device=None) -> None:"),
        ("stores=active_stores)", "stores=active_stores,\n                             device=device)"),
        ("stores=standby_stores)",
         "stores=standby_stores,\n                              device=device)"),
    ),
}
#: comments of the JAX modules that cite its review history, reworded in the
#: port's copies: (module, the JAX file's first and last line, the port's text)
REWORDED = (
    ("engine/admin", 34, 34, '    surface."""'),
    ("engine/durability", 12, 12, "  available."),
    ("engine/multicluster", 32, 32,
     '    """Warm promotion: hydrate the promoting box\'s serving'),
    ("engine/failovermanager", 11, 11, "Warm promotion: the graceful path drains in-flight"),
)


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_one(module):
    lines = (ROOT / "cadence_tpu" / f"{module}.py").read_text().split("\n")
    for m, first, last, port_text in REWORDED:
        if m == module:
            lines[first - 1:last] = port_text.split("\n")
    want = re.sub(r"\bcadence_tpu\b", "cadence_tpu_torch", "\n".join(lines))
    for jax_text, port_text in PORT_HUNKS.get(module, ()):
        assert want.count(jax_text) == 1, jax_text
        want = want.replace(jax_text, port_text)
    assert (ROOT / "cadence_tpu_torch" / f"{module}.py").read_text() == want


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
