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


# ---------------------------------------------------------------------------
# Kernel A's trap states and its route by size (csrc/replay_tables.cuh)
# ---------------------------------------------------------------------------


def _trap(factor, W=36, E=24, seed=900):
    """trap_corpus at the factor-widened layout: (numpy state, lanes, JAX
    layout)."""
    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as T_LAYOUT
    from cadence_tpu_torch.gen.lanes import trap_corpus
    from cadence_tpu_torch.ops.state import widen_layout as t_widen

    st, ln = trap_corpus(W, E, seed + factor, t_widen(T_LAYOUT, factor))
    return st, ln, widen_layout(DEFAULT_LAYOUT, factor)


@pytest.mark.parametrize("factor", [1, 4])
def test_plain_replay_on_trap_states(factor):
    """From trap_corpus's carried states (full tables, duplicate keys, a run
    reset mid-stream, forks, sticky errors, a history at Kv), the plain
    version of kernel A equals the JAX package's replay_from_state on all 66
    tensors, at the base layout and at rung 2 (K = 64, B = 8); each trap
    fires as built."""
    from cadence_tpu_torch.gen.lanes import TRAP_KINDS
    from tests.torch_parity import assert_states_equal, jax_state_from_numpy

    st, ln, jl = _trap(factor)
    js = jr.replay_from_state(ln, jax_state_from_numpy(st, jl))
    s = tr.replay_scan_plain(state_from_numpy(st, device="cpu"), torch.from_numpy(ln))
    assert_states_equal(s, js)
    err = s.error.numpy()
    kind = np.arange(len(err)) % len(TRAP_KINDS)
    at = {k: err[kind == i] for i, k in enumerate(TRAP_KINDS)}
    assert (at["full_tables"] == 10).all()        # TABLE_OVERFLOW
    assert (at["duplicate_keys"] == 0).all()      # every lookup matched both slots
    assert (at["history_at_kv"] == 3).all()       # VERSION_HISTORY_OVERFLOW
    assert (at["sticky_error"] == st["error"][kind == TRAP_KINDS.index("sticky_error")]).all()
    forks = kind == TRAP_KINDS.index("fork")  # a second branch inherited a history
    assert ((st["vh_count"][forks] > 0).sum(1) == 1).all()
    assert ((s.vh_count.numpy()[forks] > 0).sum(1) == 2).any()


def test_plain_tasks_on_trap_states():
    """Kernel A's TASKS variant's plain version from the trap states equals
    the JAX package's step then step_tasks, state and all 12 task-log
    tensors."""
    import jax
    import jax.numpy as jnp

    from cadence_tpu.ops.taskgen import init_task_log as j_log
    from cadence_tpu.ops.taskgen import step_tasks as j_step_tasks
    from cadence_tpu.ops.transitions import step as j_step
    from cadence_tpu_torch.ops.convert import task_log_to_numpy
    from cadence_tpu_torch.ops.taskgen import init_task_log
    from tests.torch_parity import assert_states_equal, jax_state_from_numpy

    st, ln, jl = _trap(1)

    def body(carry, ev):
        s, log = carry
        s = j_step(s, ev)
        return j_step_tasks(s, ev, log, 1), None

    (js, jlog), _ = jax.lax.scan(body, (jax_state_from_numpy(st, jl), j_log(len(ln), 16, 16)),
                                 jnp.swapaxes(jnp.asarray(ln), 0, 1))
    s, log = tr.replay_tasks_scan_plain(state_from_numpy(st, device="cpu"),
                                        init_task_log(len(ln), 16, 16, "cpu"),
                                        torch.from_numpy(ln))
    assert_states_equal(s, js)
    got = task_log_to_numpy(log)
    for name in jlog._fields:
        assert np.array_equal(got[name], np.asarray(getattr(jlog, name))), name
    assert got["tr_count"].any() and got["tm_count"].any()


def _t_layout(factor=1, **caps):
    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as T_LAYOUT
    from cadence_tpu_torch.ops.state import widen_layout as t_widen

    lay = t_widen(T_LAYOUT, factor)
    return lay if not caps else type(lay)(**{**lay.__dict__, **caps})


@pytest.mark.parametrize("factor,route", [(1, "staged"), (2, "staged"), (4, "staged"),
                                          (8, "global"), (16, "global")])
def test_replay_route_by_layout(factor, route):
    """The ladder's rungs 0-2 (every capacity at most 64) take kernel A's
    staged route, rung 3 (x8) and up the global one, by the layout alone,
    each under its own launch names."""
    from cadence_tpu_torch.ops import _build

    lay = _t_layout(factor)
    assert tr.replay_route(lay) == route
    for name in ("replay", "replay_tasks", "replay_wirec"):
        got = tr.launch_name(name, lay)
        assert got == (name if route == "staged" else name + "_global")
        assert got in _build.launches


@pytest.mark.parametrize("caps,route", [
    ({"max_activities": 64}, "staged"), ({"max_activities": 65}, "global"),
    ({"max_timers": 64, "max_signals": 64}, "staged"), ({"max_signals": 65}, "global"),
    ({"max_branches": 64, "max_version_history_items": 1024}, "staged")])
def test_replay_route_at_the_mask_edge(caps, route):
    """A table of 64 slots fits the occupancy mask, one of 65 does not; the
    version history's depth never decides the route."""
    assert tr.replay_route(_t_layout(**caps)) == route


def test_staged_shared_memory_fits_every_staged_layout():
    """Every layout the staged route takes (the ladder's rungs 0-2, and
    capacities up to 64 with up to 64 branches) gets a block of 32
    workflows whose shared memory is under the card's 227 KB; the base
    layout's block takes 18,432 bytes, rung 2's 78,848."""
    assert tr.staged_block(_t_layout()) == (32, 32 * 576)
    assert tr.staged_block(_t_layout(4)) == (32, 32 * (8 * 288 + 20 * 8))
    layouts = [_t_layout(f) for f in (1, 2, 4)] + [
        _t_layout(max_activities=k, max_timers=k, max_children=k, max_request_cancels=k,
                  max_signals=k, max_branches=b)
        for k in (1, 7, 16, 33, 64) for b in (1, 2, 3, 16, 64)]
    for lay in layouts:
        nw, smem = tr.staged_block(lay)
        assert tr.replay_route(lay) == "staged"
        assert nw == tr.STAGED_WF and 0 < smem <= 227 * 1024


def test_staged_constants_are_the_kernels():
    """CHIP_MAX_K, the staged block's width and REG_BRANCHES are
    csrc/replay_tables.cuh's, the shared-memory limit state.cuh's, and
    staged_block sizes a workflow as staged_bytes_per_workflow does."""
    import os
    import re

    from cadence_tpu_torch.ops import _build

    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    src = "".join(open(os.path.join(csrc, name)).read()
                  for name in ("replay_tables.cuh", "state.cuh"))
    consts = {name: eval(value, {}) for name, value in  # noqa: S307 (integer literals)
              re.findall(r"constexpr int (\w+) = ([\d *]+);", src)}
    for name in ("CHIP_MAX_K", "STAGED_WF", "SMEM_LIMIT", "REG_BRANCHES"):
        assert consts[name] == getattr(tr, name), name
    per = re.search(r"return (\d+) \* chip_key_slots\(c\) \+ \(c\.b > REG_BRANCHES \? "
                    r"(\d+) \* c\.b : 0\);", src)
    keys = re.search(r"return (\d+) \* c\.ka \+ c\.kt \+ c\.kc \+ c\.kr \+ c\.ks;", src)
    lay = _t_layout(max_branches=5)
    slots = int(keys.group(1)) * lay.max_activities + 16 + 8 + 8 + 8
    assert tr.staged_block(lay)[1] == tr.staged_block(lay)[0] * (
        int(per.group(1)) * slots + int(per.group(2)) * 5)
