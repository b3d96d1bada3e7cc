"""The entry points of cadence_tpu_torch.ops.replay on the CPU against the
JAX package's and the oracle: replay_corpus, replay_to_crc32, the
from-state reductions, verify_rows, the state carried across, and the
rule that an entry point asked for no device never runs on the CPU."""
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT, crc32_of_rows
from cadence_tpu.gen.corpus import SUITES, generate_corpus
from cadence_tpu.gen.fuzz import oracle_final_row
from cadence_tpu.ops import encode as j_encode
from cadence_tpu.ops import replay as jr
from cadence_tpu.ops.state import widen_layout
from cadence_tpu_torch.gen import corpus as t_corpus
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.ops import replay as tr
from cadence_tpu_torch.ops.convert import state_from_numpy, state_to_numpy
from cadence_tpu_torch.ops.state import init_state, leaves
from tests.torch_parity import E_PAD, jax_state_to_numpy, pad_events

W = 16


@pytest.mark.parametrize("suite", list(SUITES) + ["overflow"])
def test_replay_corpus(suite):
    hs = generate_corpus(suite, W, seed=17, target_events=100)
    want = jr.replay_corpus(hs, max_events=E_PAD)
    got = tr.replay_corpus(t_corpus.generate_corpus(suite, W, seed=17, target_events=100),
                           max_events=E_PAD, device="cpu")
    assert got[1].dtype == np.uint32
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    rows, crcs, errors = got
    for i, h in enumerate(hs):
        if errors[i] == 0:
            expected = oracle_final_row(h)
            assert np.array_equal(rows[i], expected)
            assert crcs[i] == crc32_of_rows(expected[None])[0]


@pytest.mark.parametrize("suite", ["timer_retry", "ndc"])
def test_replay_to_crc32(suite):
    ev = pad_events(j_encode.encode_corpus(generate_corpus(suite, W, seed=3, target_events=100)))
    w32 = j_encode.to_wire32(ev)
    assert np.array_equal(tr.widen_wire32(torch.from_numpy(w32)).numpy(), ev)
    crc, err = tr.replay_to_crc32(w32, device="cpu")
    jcrc, jerr = jr.replay_to_crc32(w32)
    assert np.array_equal(crc.numpy(), np.asarray(jcrc).astype(np.int64))
    assert np.array_equal(err.numpy(), np.asarray(jerr))
    rows, err64 = tr.replay_to_payload(ev, device="cpu")
    assert np.array_equal(crc.numpy(), crc32_of_rows(rows.numpy()).astype(np.int64))


def test_from_state_reductions():
    """replay_from_state_to_payload/_to_crc from a 2x-widened carried state,
    projected to the base width, equal the JAX package's."""
    wide = widen_layout(DEFAULT_LAYOUT, 2)
    ev = pad_events(random_lanes(64, 128, 31))
    half = ev.shape[1] // 2
    js0 = jr.replay_events(ev[:, :half], wide)
    s0 = state_from_numpy(jax_state_to_numpy(js0), device="cpu")
    j_s, j_rows, j_err, j_ovf = jr.replay_from_state_to_payload(ev[:, half:], js0)
    s, rows, err, ovf = tr.replay_from_state_to_payload(ev[:, half:], s0, device="cpu")
    assert np.array_equal(rows.numpy(), np.asarray(j_rows))
    assert np.array_equal(err.numpy(), np.asarray(j_err))
    assert np.array_equal(ovf.numpy(), np.asarray(j_ovf))
    crc, err2, ovf2 = tr.replay_from_state_to_crc(ev[:, half:], s0, device="cpu")
    jcrc, _, _ = jr.replay_from_state_to_crc(ev[:, half:], js0)
    assert np.array_equal(crc.numpy(), np.asarray(jcrc).astype(np.int64))
    assert np.array_equal(err2.numpy(), err.numpy()) and np.array_equal(ovf2.numpy(), ovf.numpy())


def test_verify_rows():
    rng = np.random.default_rng(5)
    ev = pad_events(j_encode.encode_corpus(generate_corpus("ndc", W, seed=8, target_events=100)))
    rows, _ = tr.replay_to_payload(ev, device="cpu")
    rows = rows.numpy()
    branch = rng.integers(0, 2, size=W).astype(np.int32)
    exp_rows = rows.copy()
    exp_rows[rng.random(W) < 0.3, rng.integers(0, rows.shape[1])] += 1
    exp_branch = branch.astype(np.int64)
    exp_branch[rng.random(W) < 0.2] ^= 1
    got = tr.verify_rows(rows, exp_rows, branch, exp_branch, device="cpu")
    want = np.asarray(jr.verify_rows(rows, exp_rows, branch, exp_branch))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_state_round_trip_is_identity():
    s = tr.replay_events(pad_events(random_lanes(32, 128, 2)), device="cpu")
    back = state_from_numpy(state_to_numpy(s), device="cpu")
    for (n1, a), (n2, b) in zip(leaves(s), leaves(back)):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b)
    mapping = state_to_numpy(init_state(3, device="cpu"))
    mapping.pop("timers.version")
    with pytest.raises(KeyError):
        state_from_numpy(mapping, device="cpu")


@pytest.mark.parametrize("call", ["replay_events", "replay_events32", "replay_corpus",
                                  "verify_rows", "replay_from_state"])
def test_no_device_means_the_card(call, monkeypatch):
    """Asked for no device, an entry point goes to CUDA; with no CUDA it
    raises and never takes the plain CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(tr, "replay_scan_plain", lambda *a, **k: ran.append(1))
    monkeypatch.setattr(tr, "verify_rows_plain", lambda *a, **k: ran.append(1))
    ev = pad_events(j_encode.encode_corpus(generate_corpus("basic", 2, seed=1, target_events=20)))
    args = {
        "replay_events": (ev,),
        "replay_events32": (j_encode.to_wire32(ev),),
        "replay_corpus": (t_corpus.generate_corpus("basic", 2, seed=1, target_events=20),),
        "verify_rows": (np.zeros((2, 3), np.int64), np.zeros((2, 3), np.int64),
                        np.zeros(2, np.int32), np.zeros(2, np.int32)),
        "replay_from_state": (ev, init_state(2, device="cpu")),
    }[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tr, call)(*args)
    assert not ran


def test_kernel_field_order_matches_the_state():
    """csrc/state.cuh indexes the state tensors in the order of
    `leaves()`; ops/_build.py's STATE_FIELDS names that order."""
    import os
    import re

    from cadence_tpu_torch.ops import _build

    src = open(os.path.join(os.path.dirname(_build.__file__), "..", "csrc", "state.cuh")).read()
    enum = src[src.index("enum Field"):src.index("NUM_FIELDS")]
    prefixes = {"ACT": "activities", "TMR": "timers", "CH": "children", "RC": "cancels",
                "SG": "signals"}
    names = []
    for f in re.findall(r"\bF_([A-Z_]+)", enum):
        head, _, rest = f.partition("_")
        names.append(f"{prefixes[head]}.{rest.lower()}" if head in prefixes else f.lower())
    assert names == list(_build.STATE_FIELDS)
    assert names == [n for n, _ in leaves(init_state(1, device="cpu"))]


def test_replay_scan_updates_the_state_in_place():
    """replay_scan takes one rule on every device: it updates the state it
    is given and returns it. The plain version leaves its input alone."""
    ev = torch.from_numpy(pad_events(random_lanes(W, 64, 5)))
    s0 = init_state(W, device="cpu")
    want = tr.replay_scan_plain(s0, ev)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(s0), leaves(init_state(W, device="cpu"))))
    s = init_state(W, device="cpu")
    assert tr.replay_scan(s, ev) is s
    for (name, x), (_, y) in zip(leaves(s), leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("factor", [1, 2])
def test_kernel_state_checks(factor):
    """The kernels' per-layout reference names every state tensor's dtype
    and shape, and a state on the CPU is refused, never launched."""
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.ops.state import widen_layout as t_widen

    layout = t_widen(DEFAULT_LAYOUT, factor)
    s = init_state(3, layout, "cpu")
    ref = _build._state_reference(layout)
    assert ref is _build._state_reference(layout)
    assert [(n, t.dtype, tuple(t.shape[1:])) for n, t in leaves(s)] == list(ref)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _build.state_pointer_table(s)
