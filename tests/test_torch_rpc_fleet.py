"""The port's wire cluster under fleet load, held to the JAX package's:
the reference's own classes of tests/test_chaos_soak.py (seeded wire
chaos and store faults in every process, zero divergence, the serving
tier's parity under chaos, a reproducible fault-free soak) and the wire
classes of tests/test_telemetry.py (the burn-rate evaluator of
loadgen/slo.py, and the fleet telemetry plane over live hosts) run
against the port, every cluster's processes on the CPU
(tests/torch_parity.py ported_reference), with the CLI's wire arm of
`admin top` against a live host."""
import pytest

from tests.torch_parity import ported_reference, reset_port_globals


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


#: methods of the kept classes that wait for cli.py: none since the port
#: has it (test_cli_admin_top_wire_arm runs its wire arm)
WAITS_FOR_CLI = ()

globals().update(ported_reference("test_chaos_soak.py", tag="soak"))
globals().update(ported_reference("test_telemetry.py",
                                  classes=("TestBurnRate", "TestFleetTelemetryWire"),
                                  tag="telemetry", leave_out=WAITS_FOR_CLI))
