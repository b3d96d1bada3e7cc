"""The port's two chaos harnesses (cadence_tpu_torch/gen/{cluster_chaos,
interleave}.py) held to the JAX package's.

Two kinds of test:
- the reference's own classes run against the port (tests/torch_parity.py
  ported_reference): tests/test_cluster_chaos.py (the partition table,
  the campaign grammar and its shrinker, and two live campaigns over a
  wire cluster, each host's serving tier and the closing verify on the
  CPU) and tests/test_fuzz.py's TestInterleaving (the interleaving
  fuzzer's live schedules on a durable serving box on the CPU);
- a drift test: each copied module's text equals the JAX module's once
  `cadence_tpu` reads `cadence_tpu_torch`, except the port's own hunks
  (tests/torch_hunks/gen_*.diff: the device each campaign, driver and
  verify takes).

The interleaving fuzzer's replication profile runs in
tests/test_torch_multiregion.py (tests/test_multiregion.py's
TestReplicationSeamFuzz). The wide sweeps stay slow, as in the reference."""
import pytest

from tests.torch_parity import ported_reference, reset_port_globals
from tests.torch_port_drift import assert_port_text


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


globals().update(ported_reference("test_cluster_chaos.py", tag="chaos"))
globals().update(ported_reference("test_fuzz.py", classes=("TestInterleaving",), tag="fuzz"))


def test_schedules_equal_jax():
    """The same seeds give the same interleaving, replication and campaign
    schedules in both packages."""
    from cadence_tpu.gen import cluster_chaos as jax_chaos
    from cadence_tpu.gen import interleave as jax_ilv
    from cadence_tpu_torch.gen import cluster_chaos, interleave

    for seed in (3, 20260804):
        assert interleave.build_schedule(seed, 4, 50, 2) == jax_ilv.build_schedule(seed, 4, 50, 2)
        assert (interleave.build_replication_schedule(seed, 4, 30, 2)
                == jax_ilv.build_replication_schedule(seed, 4, 30, 2))
        for profile in cluster_chaos.PROFILES:
            got = cluster_chaos.build_campaign(seed, num_hosts=3, kills=1, store_kills=1,
                                               partitions=1, flaps=1, profile=profile)
            want = jax_chaos.build_campaign(seed, num_hosts=3, kills=1, store_kills=1,
                                            partitions=1, flaps=1, profile=profile)
            assert [op.as_dict() for op in got] == [op.as_dict() for op in want]


def test_interleave_wals_in_a_fresh_directory(monkeypatch):
    """Two scenarios of one seed (the JAX package's and the port's, in two
    test workers) never share a WAL: by default each scenario writes its
    two WALs into a directory of its own, and removes it at the end."""
    import os

    from cadence_tpu_torch.gen import interleave

    seen = []

    class Recorder:
        def __init__(self, wal_path, *_a, **_kw):
            seen.append(wal_path)
            with open(wal_path, "w"):
                pass

        def run(self, *_a, **_kw):
            raise RuntimeError("recorded")

    monkeypatch.setattr(interleave, "InterleaveDriver", Recorder)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="recorded"):
            interleave.interleave_scenario(seed=11, device="cpu")
    first, second = (os.path.dirname(p) for p in seen)
    assert first != second
    assert not os.path.exists(first) and not os.path.exists(second)


COPIED = ("gen/cluster_chaos", "gen/interleave")


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_one(module):
    assert_port_text(module)
