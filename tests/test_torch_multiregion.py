"""The port's multi-region modules (cadence_tpu_torch/engine/{multicluster,
failovermanager,redirection,domainrepl}.py, with the cross-cluster path the
Onebox already had) held to the JAX package's: the reference's own classes
run against the port, each ReplicatedClusters built on the CPU
(tests/torch_parity.py ported_reference).

The files and what is left out of them:
- tests/test_replication.py, through its `clusters` fixture: every class
  but TestStreamingReplay, a replay_streamed parity case that
  tests/test_torch_streaming.py already holds against the JAX package;
- tests/test_multiregion.py, every class: TestWarmPromotion (the warm
  failover's prehydration through the migration tier),
  TestReplicationSeamFuzz (gen/interleave.py's replication profile) and
  TestRegionFailoverWire (loadgen/scenarios.py's region kill over two wire
  regions, slow as in the reference);
- tests/test_failovermanager.py, tests/test_redirection_domainrepl.py and
  tests/test_crosscluster.py, every class."""
import pytest

from tests.torch_parity import ported_reference, reset_port_globals


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


globals().update(ported_reference(
    "test_replication.py", classes=("TestReplication", "TestFailover", "TestDeviceStandbyApply",
                                    "TestSnapshotShipping", "TestDLQObservability",
                                    "TestDomainBackpressure"), tag="replication"))
globals().update(ported_reference("test_multiregion.py", tag="multiregion"))
globals().update(ported_reference("test_failovermanager.py", tag="failovermanager"))
globals().update(ported_reference("test_redirection_domainrepl.py", tag="redirection"))
globals().update(ported_reference("test_crosscluster.py", tag="crosscluster"))


def test_clusters_run_on_the_device_named():
    """ReplicatedClusters hands its device to both regions' Oneboxes, and
    with no device named and no card it raises."""
    import torch

    from cadence_tpu_torch.engine.multicluster import ReplicatedClusters

    c = ReplicatedClusters(num_hosts=1, num_shards=2, device="cpu")
    for box in (c.active, c.standby):
        assert box.device == torch.device("cpu")
        assert box.tpu.device == torch.device("cpu")
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReplicatedClusters(num_hosts=1, num_shards=2)
    finally:
        torch.cuda.is_available = real
