"""The generator: the port's basic histories, cut and timed from the seed alone."""
import numpy as np
import pytest
import torch

from perfbench.entries.wire32 import narrow32
from perfbench.gen.basic import Histories, cut_table, generate, lengths, template
from perfbench.reference.layout import (
    LANE_BATCH_LAST,
    LANE_EVENT_ID,
    LANE_EVENT_TYPE,
    LANE_TASK_ID,
    LANE_TIMESTAMP,
)

CPU = torch.device("cpu")


def _histories(target=100, block=64):
    return Histories({"target_events": target, "read_from": 0.5, "cut_block": block}, CPU)


@pytest.mark.parametrize("target", [21, 100, 1000])
def test_template_is_the_ports_basic_history(target):
    from cadence_tpu_torch.gen.corpus import generate_history
    from cadence_tpu_torch.ops.encode import encode_history, history_length

    h = generate_history("basic", 5, 9, target)
    np.testing.assert_array_equal(template(target), encode_history(h, history_length(h)))


def test_the_cuts_are_batch_ends_from_half_the_history_to_its_close():
    tmpl = torch.from_numpy(template(1000))
    cuts = cut_table(tmpl, 0.5, 4096)
    ends = set((torch.nonzero(tmpl[:, LANE_BATCH_LAST] == 1).flatten() + 1).tolist())
    assert set(cuts.tolist()) <= ends
    assert cuts.min() >= 501 and cuts.max() == tmpl.shape[0]
    assert len(torch.unique(cuts)) == len([e for e in ends if e >= 501])
    assert bool((cuts[1:] >= cuts[:-1]).all())


def test_every_block_holds_the_same_cuts_under_every_seed():
    h = _histories()
    for seed in (7, 2**31 + 5, 2**33 + 1):
        got = lengths(seed, torch.arange(256), h.cuts).view(4, 64)
        for block in got:
            assert torch.equal(torch.sort(block).values, h.cuts)
    a, b = lengths(7, torch.arange(256), h.cuts), lengths(8, torch.arange(256), h.cuts)
    assert (a != b).float().mean() > 0.5


def test_the_same_seed_gives_the_same_lanes_by_index():
    h = _histories()
    seed = 2**31 + 1234567
    whole = h(seed, torch.arange(0, 128))
    assert torch.equal(whole, h(seed, torch.arange(0, 128)))
    assert torch.equal(whole[17:90], h(seed, torch.arange(17, 90)))
    picked = torch.tensor([127, 2, 70])
    assert torch.equal(whole[picked], h(seed, picked))


def test_a_cut_history_is_the_template_then_padding():
    h = _histories()
    lanes = h(2**32 + 9, torch.arange(64))
    n = lengths(2**32 + 9, torch.arange(64), h.cuts)
    other = [i for i in range(lanes.shape[2]) if i not in (LANE_TIMESTAMP, LANE_TASK_ID)]
    for row, cut in zip(lanes, n.tolist()):
        assert torch.equal(row[:cut][:, other], h.template[:cut][:, other])
        assert bool((row[cut:, LANE_EVENT_ID] == 0).all())
        assert bool((row[cut:, LANE_EVENT_TYPE] == -1).all())
        assert int(row[cut:].abs().sum()) == row.shape[0] - cut
        assert bool((row[1:cut, LANE_TIMESTAMP] > row[:cut - 1, LANE_TIMESTAMP]).all())
        assert bool((row[1:cut, LANE_TASK_ID] > row[:cut - 1, LANE_TASK_ID]).all())
    assert not torch.equal(lanes[..., LANE_TIMESTAMP],
                           h(2**32 + 10, torch.arange(64))[..., LANE_TIMESTAMP])


def test_narrow32_is_the_ports_wire32():
    from cadence_tpu_torch.ops.encode import to_wire32

    ev = generate(2**33 + 5, torch.arange(16), torch.from_numpy(template(100)),
                  _histories().cuts)
    np.testing.assert_array_equal(narrow32(ev).numpy(), to_wire32(ev.numpy()))
    bad = ev.clone()
    bad[0, 0, LANE_TASK_ID] = 1 << 40
    with pytest.raises(OverflowError):
        narrow32(bad)
