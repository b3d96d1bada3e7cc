"""The frozen reference against the port's plain versions, on the CPU."""
import numpy as np
import pytest
import torch

from perfbench.gen.basic import Histories
from perfbench.reference import replay_crc, replay_rows
from perfbench.reference.layout import DEFAULT_LAYOUT
from perfbench.reference.payload import crc32_of_rows


def _port_rows(lanes):
    from cadence_tpu_torch.ops.replay import replay_to_payload

    rows, err = replay_to_payload(lanes, device="cpu")
    return rows.numpy(), err.numpy()


def _histories(target, block=64):
    return Histories({"target_events": target, "read_from": 0.5, "cut_block": block},
                     torch.device("cpu"))


@pytest.mark.parametrize("target", [21, 100])
def test_basic_histories_replay_as_the_port_replays_them(target):
    lanes = _histories(target)(2**31 + 99, torch.arange(40))
    rows, err = replay_rows(lanes)
    want_rows, want_err = _port_rows(lanes)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(err, want_err)
    assert not err.any()


@pytest.mark.parametrize("seed", [3, 41])
def test_random_lanes_of_every_error_replay_as_the_port_replays_them(seed):
    from cadence_tpu_torch.gen.lanes import random_lanes

    lanes = torch.as_tensor(random_lanes(64, 48, seed))
    rows, err = replay_rows(lanes)
    want_rows, want_err = _port_rows(lanes)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(err, want_err)


def test_crc_is_the_ports_and_the_control_differs():
    from cadence_tpu_torch.core.checksum import crc32_of_rows as port_crc
    from cadence_tpu_torch.ops.crc import crc32_rows_plain

    lanes = _histories(100)(17, torch.arange(8))
    rows, _ = replay_rows(lanes, DEFAULT_LAYOUT)
    crc = crc32_of_rows(rows)
    np.testing.assert_array_equal(crc, port_crc(rows))
    np.testing.assert_array_equal(crc.astype(np.int64),
                                  crc32_rows_plain(torch.from_numpy(rows)).numpy())
    narrow, _ = replay_crc(lanes, word_bytes=4)
    assert (narrow != crc).all()


def test_the_answers_differ_from_workflow_to_workflow_and_seed_to_seed():
    """bench-basic's cut table: 34 cuts; 512 workflows of one block take
    nearly all of them, and another seed deals them out in another order."""
    histories = _histories(100, 4096)
    distinct = len(torch.unique(histories.cuts))
    rows = torch.arange(4096, 4096 + 512)
    crc_a, err_a = replay_crc(histories(2**40 + 1, rows))
    crc_b, _ = replay_crc(histories(2**40 + 2, rows))
    assert not err_a.any()
    assert len(np.unique(crc_a)) >= distinct - 2 >= 30
    assert (crc_a != crc_b).mean() > 0.9
