"""Kernel G's and kernel H's plain versions (cadence_tpu_torch/ops/state.py
rehome_plain, narrow_ok_plain) and the CPU routes of widen_state,
narrow_state and narrow_ok, against the JAX package's widen_state,
narrow_state, narrow_ok and the resident pool's _stack_states and
_slice_row, on states replayed from random lanes and from the overflow
suite, at rungs 0-2, with init rows and a widen-then-narrow round trip.
Every value is an integer or a bool: compared exactly."""
import jax
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT
from cadence_tpu.engine import resident as jres
from cadence_tpu.gen.corpus import generate_corpus
from cadence_tpu.ops import replay as jr
from cadence_tpu.ops import state as js
from cadence_tpu.ops.encode import encode_corpus
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.ops import rehome as trh
from cadence_tpu_torch.ops import state as ts
from cadence_tpu_torch.ops.convert import state_from_numpy
from tests.torch_parity import assert_states_equal, jax_state_to_numpy, pad_events

W = 12


def _corpus(kind):
    if kind == "lanes":
        return pad_events(random_lanes(W, 64, 41), 64)
    return pad_events(encode_corpus(generate_corpus("overflow", W, seed=5, target_events=70)), 80)


@pytest.fixture(scope="module", params=["lanes", "overflow"])
def replayed(request):
    """{rung: (JAX state, port state)} of one corpus replayed at rungs 0-2."""
    ev = _corpus(request.param)
    out = {}
    for rung in range(3):
        lay = js.widen_layout(DEFAULT_LAYOUT, 2 ** rung)
        jst = jr.replay_events(ev, lay)
        out[rung] = (jst, state_from_numpy(jax_state_to_numpy(jst), device="cpu"))
    return out


def _layout(rung):
    return js.widen_layout(DEFAULT_LAYOUT, 2 ** rung)


@pytest.mark.parametrize("src,dst", [(0, 1), (0, 2), (1, 2), (2, 0), (1, 0), (2, 1), (1, 1)])
def test_widen_and_narrow_equal_jax(replayed, src, dst):
    jst, tst = replayed[src]
    lay = _layout(dst)
    fn_j = js.widen_state if dst >= src else js.narrow_state
    fn_t = ts.widen_state if dst >= src else ts.narrow_state
    assert_states_equal(fn_t(tst, lay), fn_j(jst, lay))
    assert_states_equal(ts.rehome_plain(tst, range(W), lay), fn_j(jst, lay))


@pytest.mark.parametrize("src,dst", [(1, 0), (2, 0), (2, 1), (0, 0), (1, 1)])
def test_narrow_ok_equals_jax(replayed, src, dst):
    jst, tst = replayed[src]
    want = np.asarray(js.narrow_ok(jst, _layout(dst)))
    assert np.array_equal(ts.narrow_ok(tst, _layout(dst)).numpy(), want)
    assert np.array_equal(trh.narrow_ok(tst, _layout(dst)).numpy(), want)


def test_widen_narrow_round_trip(replayed):
    """A base state widened to rung 2 and narrowed back is itself; a rung-1
    state narrowed where narrow_ok holds and widened again keeps its rows."""
    jst, tst = replayed[0]
    round_trip = ts.narrow_state(ts.widen_state(tst, _layout(2)), DEFAULT_LAYOUT)
    assert_states_equal(round_trip, jst)
    jw, tw = replayed[1]
    ok = ts.narrow_ok(tw, DEFAULT_LAYOUT).numpy()
    back = ts.widen_state(ts.narrow_state(tw, DEFAULT_LAYOUT), _layout(1))
    for (name, a), (_, b) in zip(ts.leaves(back), ts.leaves(tw)):
        assert torch.equal(a[ok], b[ok]), name


def test_stack_and_slice_equal_jax(replayed):
    """_slice_row of every third row, _stack_states of those W=1 rows with an
    init block: one rehome_plain gather with -1 rows for the init block."""
    jst, tst = replayed[1]
    picked = [0, 3, 6, 9]
    jrows = [jres._slice_row(jst, i) for i in picked]
    for i, jrow in zip(picked, jrows):
        assert_states_equal(ts.rehome_plain(tst, [i], _layout(1)), jrow)
    want = jres._stack_states(jrows + [js.init_state(4, _layout(1))])
    got = ts.rehome_plain(tst, picked + [-1] * 4, _layout(1))
    assert_states_equal(got, want)
    # the same rows re-homed at rung 2 with init rows between them
    want2 = js.widen_state(jres._stack_states([jrows[0], js.init_state(1, _layout(1)), jrows[2]]),
                           _layout(2))
    assert_states_equal(ts.rehome_plain(tst, [0, -1, 6], _layout(2)), want2)


def test_scatter_into_a_destination(replayed):
    """dst rows are written, every other row of dst is left as it was."""
    _, tst = replayed[0]
    dst = ts.init_state(20, DEFAULT_LAYOUT, "cpu")
    before = ts.rehome_plain(dst, range(20), DEFAULT_LAYOUT)
    out = trh.rehome(tst, [4, -1, 2], DEFAULT_LAYOUT, dst, [17, 3, 8])
    assert out is dst
    for (name, d), (_, b), (_, s) in zip(ts.leaves(dst), ts.leaves(before), ts.leaves(tst)):
        keep = [i for i in range(20) if i not in (17, 3, 8)]
        assert torch.equal(d[keep], b[keep]), name
        assert torch.equal(d[17], s[4]) and torch.equal(d[8], s[2]), name
        assert torch.equal(d[3], b[3]), name  # init row into an init state
    with pytest.raises(ValueError, match="appears twice"):
        trh.rehome(tst, [1, 2], DEFAULT_LAYOUT, dst, [5, 5])


@pytest.mark.parametrize("src_rows,dst_rows", [([W, 0], [0, 1]), ([-2, 0], [0, 1]),
                                               ([0, 1], [0, 20]), ([0, 1], [-1, 1])],
                         ids=["src_past_end", "src_below_init", "dst_past_end", "dst_negative"])
def test_rows_outside_the_states_are_refused(replayed, src_rows, dst_rows):
    """Host row indices outside [-1, source rows) and [0, destination rows)
    raise the same ValueError on the CPU route and before kernel G's
    launch (a meta state stands for the card: nothing is launched)."""
    _, tst = replayed[0]
    lay = ts.layout_of(tst)
    for src in (tst, ts.init_state(W, lay, "meta")):
        dst = ts.init_state(20, lay, src.state.device)
        with pytest.raises(ValueError, match="outside"):
            trh.rehome(src, src_rows, lay, dst, dst_rows) if src is tst else \
                trh.rehome_launch(src, src_rows, lay, dst, dst_rows)


def test_empty_source_gives_init_rows():
    src = ts.init_state(0, DEFAULT_LAYOUT, "cpu")
    got = ts.rehome_plain(src, [-1, -1], _layout(1))
    assert_states_equal(got, js.init_state(2, _layout(1)))


def test_field_table_matches_init_state():
    """The per-field init values and element sizes kernel G gets are the
    init_state values of every field, at every rung."""
    init, sizes = trh._field_table()
    for rung in range(3):
        for k, (name, t) in enumerate(ts.leaves(ts.init_state(1, _layout(rung), "cpu"))):
            assert sizes[k] == t.element_size(), name
            assert (t == init[k]).all(), name


def test_cuda_state_never_takes_the_plain_route(monkeypatch):
    """A state that is not on the CPU goes to the kernel or raises."""
    meta = ts.init_state(2, DEFAULT_LAYOUT, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trh.rehome(meta, [0, 1], DEFAULT_LAYOUT)
    with pytest.raises(ValueError, match="unsupported device"):
        trh.narrow_ok(meta, DEFAULT_LAYOUT)
    assert jax.devices()[0].platform == "cpu"
