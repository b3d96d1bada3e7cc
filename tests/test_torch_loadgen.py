"""The port's load harness (cadence_tpu_torch/loadgen/{mixes,generator,
slo,report,scenarios}.py) and its multi-cluster wire group held to the
JAX package's.

Two kinds of test:
- the reference's own classes of tests/test_loadgen.py (schedules, the
  open loop, SLOs, trajectories, the in-process box and the two-domain
  overload scenario over a wire cluster) and tests/test_multicluster_wire.py
  (two wire regions: replication, managed failover, cross-cluster
  children, SIGKILL during replication) run against the port, every box,
  cluster and closing verify on the CPU (tests/torch_parity.py
  ported_reference);
- a drift test: each copied module's text equals the JAX module's once
  `cadence_tpu` reads `cadence_tpu_torch`, except the port's own hunks
  (tests/torch_hunks/loadgen_scenarios.diff: the device each scenario
  hands its clusters, boxes and verifies, the recovery store's command,
  the kernel launches the multi-host scenario reports, and comments
  reworded where the JAX text speaks of compiles).

tests/test_cluster_serving.py (the multi-host serving scenario with a host
killed mid-traffic, and the planned rebalance) runs here too, slow as in
the reference; chip_smoke.py's cluster_path drives both on the card.
tests/test_visibility_device.py's loadgen shape (TestRoutingAndOps
.test_query_heavy_loadgen_ops) runs in tests/test_torch_admin.py."""
import pytest

from tests.torch_parity import ported_reference, reset_port_globals
from tests.torch_port_drift import assert_port_text


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


globals().update(ported_reference("test_loadgen.py", tag="loadgen"))
globals().update(ported_reference("test_multicluster_wire.py", tag="wire"))
globals().update(ported_reference("test_cluster_serving.py", tag="multihost"))


def test_schedule_and_digest_equal_jax():
    """The same plans and seed give the same open-loop schedule, op for
    op, and the same trace digest in both packages."""
    from cadence_tpu.loadgen import mixes as jax_mixes
    from cadence_tpu_torch.loadgen import mixes

    for name in sorted(jax_mixes.MIXES):
        def plans(m):
            return [m.DomainPlan("a", 12.0, mix=m.MIXES[name], pool_size=4),
                    m.DomainPlan("b", 5.0, mix=m.MIXES[name], pool_size=2)]

        got = mixes.build_schedule(plans(mixes), 3.0, 20260804)
        want = jax_mixes.build_schedule(plans(jax_mixes), 3.0, 20260804)
        assert [tuple(vars(op).values()) for op in got] == \
            [tuple(vars(op).values()) for op in want], name
        assert mixes.trace_digest(got) == jax_mixes.trace_digest(want)


def test_planned_rebalance_scenario_holds_its_gates():
    """The port's planned rebalance (the configuration chip_smoke.py's
    cluster_path drives on the card as rebalance-2h) on a CPU cluster:
    the gainer hydrates with zero divergence, every row it serves equals
    the oracle's at its content address, and each moved key keeps the
    loser's CRC."""
    from cadence_tpu_torch.loadgen.scenarios import planned_rebalance_scenario

    doc = planned_rebalance_scenario(device="cpu")
    assert doc["ok"], doc["gates"]
    assert doc["rows_equal_oracle"] == doc["rows_hydrated"] > 0
    assert doc["migration_in"]["parity_divergence"] == 0
    assert set(doc["hosts"]) == {"host-0", "host-1", doc["new_host"]}
    assert set(doc["walls_s"]) >= {"launch", "warm", "traffic", "quiesce", "add_host",
                                   "hydrate", "oracle_check", "total"}


def test_kill_window_latencies():
    """The kill window holds the ops due before the steal's end (the run's
    end when no steal ended) and not done before the SIGKILL."""
    from cadence_tpu_torch.loadgen.scenarios import _kill_window

    samples = [(0.5, "signal", 0.1),     # done before the kill
               (1.5, "signal", 0.9),     # in flight at the kill
               (2.5, "start", 0.2), (3.0, "signal", 0.3), (3.5, "signal", 0.05),
               (4.5, "signal", 0.02),    # due after the steal
               (6.0, "signal", 0.04)]
    doc = _kill_window(samples, {"kill": 102.0, "steal": 104.0}, 100.0)
    assert doc["kill_at_s"] == 2.0 and doc["steal_s"] == 2.0
    assert doc["ops"] == 4 and doc["signals"] == 3
    assert doc["signal_p50_ms"] == 300.0
    assert doc["signal_p99_ms"] == doc["signal_max_ms"] == 900.0
    assert doc["p99_ms"] == 900.0
    assert doc["signals_outside"] == 3 and doc["signal_p99_ms_outside"] == 100.0
    open_ended = _kill_window(samples, {"kill": 104.0}, 100.0)
    assert open_ended["steal_s"] is None and open_ended["ops"] == 2
    assert _kill_window(samples, {}, 100.0) == {"kill_at_s": None}


COPIED = ("loadgen/__init__", "loadgen/mixes", "loadgen/generator", "loadgen/slo",
          "loadgen/report", "loadgen/scenarios")


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_one(module):
    assert_port_text(module)
