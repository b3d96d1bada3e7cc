"""The wirec slice of cadence_tpu_torch on the CPU against the JAX package:
the host packer and gather give the same bytes; the plain decode equals
JAX's decode_wirec; the wirec replays (fresh and from a carried state)
equal JAX's on all 66 state tensors, the CRCs, the errors and the
narrow-overflow flags. Every value is an integer: the tolerance is 0."""
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT
from cadence_tpu.ops import replay as jr
from cadence_tpu.ops import wirec as jw
from cadence_tpu.ops.encode import to_wire32
from cadence_tpu.ops.state import widen_layout
from cadence_tpu_torch.ops import replay as tr
from cadence_tpu_torch.ops import wirec as tw
from cadence_tpu_torch.ops.convert import state_from_numpy
from tests.torch_parity import (
    WIREC_KINDS,
    assert_corpora_equal,
    assert_states_equal,
    jax_state_to_numpy,
    wirec_corpus,
)

REPLAY_KINDS = ("basic", "echo_signal", "timer_retry", "concurrent_child", "ndc", "overflow",
                "lanes")


def _tensors(c):
    return torch.from_numpy(c.slab), torch.from_numpy(c.bases), torch.from_numpy(c.n_events)


@pytest.mark.parametrize("kind", WIREC_KINDS)
def test_pack_wirec_same_bytes(kind):
    ev = wirec_corpus(kind)
    assert_corpora_equal(tw.pack_wirec(ev), jw.pack_wirec(ev))


def test_pack_wirec_threaded_same_bytes():
    """The row-block parallel path (W >= 512) packs the serial bytes."""
    ev = np.concatenate([wirec_corpus("ndc", 16)] * 40)
    want = jw.pack_wirec(ev, num_threads=1)
    assert_corpora_equal(tw.pack_wirec(ev, num_threads=4), want)


@pytest.mark.parametrize("pad", [(0, 0), (32, 128)], ids=["trimmed", "padded"])
@pytest.mark.parametrize("kind", ["overflow", "lanes"])
def test_gather_corpus_same_bytes(kind, pad):
    ev = wirec_corpus(kind)
    idx = [0, 3, 5, 11]
    got = tw.gather_corpus(tw.pack_wirec(ev), idx, *pad)
    want = jw.gather_corpus(jw.pack_wirec(ev), idx, *pad)
    assert_corpora_equal(got, want)
    assert got.slab.shape[0] == max(len(idx), pad[0])


@pytest.mark.parametrize("kind", WIREC_KINDS)
def test_decode_wirec_plain_equals_jax(kind):
    c = jw.pack_wirec(wirec_corpus(kind))
    want = np.asarray(jw.decode_wirec(c.slab, c.bases, c.n_events, c.profile))
    got = tw.decode_wirec(c.slab, c.bases, c.n_events, c.profile, device="cpu")
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["ndc", "lanes", "adversarial"])
def test_decode_step_walks_to_the_full_decode(kind):
    """Column by column, the fused decode's carry gives exactly the full
    decode, padding rows included (the JAX decode_step's contract)."""
    c = tw.pack_wirec(wirec_corpus(kind))
    slab, bases, n = _tensors(c)
    full = tw.decode_wirec_plain(slab, bases, n, c.profile)
    prev = bases[:, list(tw.delta_base_columns(c.profile))]
    for e in range(slab.shape[1]):
        ev, prev = tw.decode_step_plain(slab[:, e], prev, bases, n, e, c.profile)
        assert torch.equal(ev, full[:, e])


def test_read_le_sign_extends_the_top_byte():
    slab = torch.tensor([[0x34, 0x12, 0xFF, 0x80, 0, 0, 0, 0x80]], dtype=torch.uint8)
    assert tw._read_le(slab, 0, 2).item() == 0x1234
    assert tw._read_le(slab, 2, 1).item() == -1
    assert tw._read_le(slab, 2, 2).item() == -0x7F01
    assert tw._read_le(slab, 0, 8).item() == -(1 << 63) + 0x80FF1234


@pytest.mark.parametrize("kind", REPLAY_KINDS)
def test_replay_wirec_equals_jax(kind):
    ev = wirec_corpus(kind)
    c = jw.pack_wirec(ev)
    js = jr.replay_wirec(c.slab, c.bases, c.n_events, c.profile)
    s = tr.replay_wirec(c.slab, c.bases, c.n_events, c.profile, device="cpu")
    assert_states_equal(s, js)
    jcrc, jerr = jr.replay_wirec_to_crc(c.slab, c.bases, c.n_events, c.profile)
    crc, err = tr.replay_wirec_to_crc(c.slab, c.bases, c.n_events, c.profile, device="cpu")
    assert np.array_equal(crc.numpy(), np.asarray(jcrc).astype(np.int64))
    assert np.array_equal(err.numpy(), np.asarray(jerr))
    if kind != "lanes":  # random lanes hold no-op rows between real ones, which
        # pack_wirec does not keep: there the decode is JAX's, not the lanes
        dense_crc, dense_err = tr.replay_to_crc32(to_wire32(ev), device="cpu")
        assert torch.equal(crc, dense_crc) and torch.equal(err, dense_err)


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("kind", ["ndc", "lanes"])
def test_replay_wirec_from_state_equals_jax(kind, factor):
    """A prefix replayed densely (at the base or a 2x layout), carried
    across; the suffix packs as a corpus of its own."""
    ev = wirec_corpus(kind)
    half = ev.shape[1] // 2
    js0 = jr.replay_events(ev[:, :half], widen_layout(DEFAULT_LAYOUT, factor))
    s0 = state_from_numpy(jax_state_to_numpy(js0), device="cpu")
    c = jw.pack_wirec(ev[:, half:])
    args = (c.slab, c.bases, c.n_events, c.profile)
    j_s, j_rows, j_err, j_ovf = jr.replay_wirec_from_state_to_payload(*args, js0)
    s, rows, err, ovf = tr.replay_wirec_from_state_to_payload(*args, s0, device="cpu")
    assert_states_equal(s, j_s)
    assert np.array_equal(rows.numpy(), np.asarray(j_rows))
    assert np.array_equal(err.numpy(), np.asarray(j_err))
    assert np.array_equal(ovf.numpy(), np.asarray(j_ovf))
    jcrc, _, _ = jr.replay_wirec_from_state_to_crc(*args, js0)
    crc, err2, ovf2 = tr.replay_wirec_from_state_to_crc(*args, s0, device="cpu")
    assert np.array_equal(crc.numpy(), np.asarray(jcrc).astype(np.int64))
    assert torch.equal(err2, err) and torch.equal(ovf2, ovf)
    # s0 was carried, not consumed
    assert_states_equal(s0, js0)


def test_pinned_profile_packs_identically():
    ev = wirec_corpus("basic")
    c = tw.pack_wirec(ev)
    assert_corpora_equal(tw.pack_wirec(ev, profile=c.profile), c)
    assert_corpora_equal(tw.pack_wirec(ev, profile=c.profile),
                         jw.pack_wirec(ev, profile=jw.pack_wirec(ev).profile))


@pytest.mark.parametrize("lane,delta", [(3, 7), (4, 1 << 20), (7, 1 << 40)],
                         ids=["ts-jitter", "task-width", "attr-width"])
def test_profile_misfit_where_the_reference_raises(lane, delta):
    ev = wirec_corpus("basic")
    profile = tw.pack_wirec(ev).profile
    wild = ev.copy()
    wild[:, 1::2, lane] += delta
    raised = []
    for pack, misfit, prof in ((tw.pack_wirec, tw.ProfileMisfit, profile),
                               (jw.pack_wirec, jw.ProfileMisfit, jw.pack_wirec(ev).profile)):
        try:
            pack(wild, profile=prof)
            raised.append(None)
        except misfit as exc:
            raised.append(str(exc))
    assert raised[0] == raised[1]
    assert raised[0] is not None


@pytest.mark.parametrize("call", ["replay_wirec", "replay_wirec_to_crc", "replay_wirec_from_state",
                                  "decode_wirec"])
def test_no_device_means_the_card(call, monkeypatch):
    """Asked for no device, a wirec entry point goes to CUDA; with no CUDA
    it raises and never takes the plain CPU path."""
    from cadence_tpu_torch.ops.state import init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(tr, "wirec_scan_plain", lambda *a, **k: ran.append(1))
    monkeypatch.setattr(tw, "decode_wirec_plain", lambda *a, **k: ran.append(1))
    c = tw.pack_wirec(wirec_corpus("empty"))
    args = (c.slab, c.bases, c.n_events, c.profile)
    if call == "replay_wirec_from_state":
        args += (init_state(4, device="cpu"),)
    mod = tw if call == "decode_wirec" else tr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(mod, call)(*args)
    assert not ran


@pytest.mark.parametrize("launch", ["wirec_launch", "decode_launch"])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    from cadence_tpu_torch.ops.state import init_state

    c = tw.pack_wirec(wirec_corpus("ndc"))
    slab, bases, n = _tensors(c)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        if launch == "wirec_launch":
            tr.wirec_launch(init_state(slab.shape[0], device="cpu"), slab, bases, n, c.profile)
        else:
            tw.decode_launch(slab, bases, n, c.profile)


@pytest.mark.parametrize("fault", ["short", "order", "bytes", "base"])
def test_check_profile_refuses_what_the_kernels_cannot_read(fault):
    c = tw.pack_wirec(wirec_corpus("ndc"))
    prof = list(c.profile)
    B, K = c.slab.shape[2], c.bases.shape[1]
    if fault == "short":
        prof = prof[:-1]
    elif fault == "order":
        prof[0], prof[1] = prof[1], prof[0]
    elif fault == "bytes":
        i = next(i for i, e in enumerate(prof) if e.width)
        prof[i] = prof[i]._replace(offset=B)
    else:
        i = next(i for i, e in enumerate(prof) if e.base_index >= 0)
        prof[i] = prof[i]._replace(base_index=K)
    tw.check_profile(c.profile, B, K)
    with pytest.raises(ValueError):
        tw.check_profile(tuple(prof), B, K)


def test_profile_table_is_the_c_layout():
    c = tw.pack_wirec(wirec_corpus("timer_retry"))
    t = list(tw.profile_table(c.profile))
    assert len(t) == 6 * 18
    for i, e in enumerate(c.profile):
        assert t[6 * i:6 * i + 6] == [e.kind, e.offset, e.width, e.base_index, e.scale, e.const]
