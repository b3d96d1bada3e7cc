"""The port's native blob packers (cadence_tpu_torch/native/packing.py and
native/wirec.py pack_serialized_wirec) against the JAX package's: the same
serialized histories give the same bytes and the same errors. The libraries
are built inside the tests (g++ is on this machine), never at import.
Also the declared 64-bit ABI of every entry point of the port's library."""
import ctypes

import numpy as np
import pytest

from cadence_tpu.core.codec import serialize_corpus as j_serialize
from cadence_tpu.gen.corpus import SUITES, generate_corpus
from cadence_tpu.native import packing as jp
from cadence_tpu.native import wirec as jnw
from cadence_tpu.ops import wirec as jw
from cadence_tpu.ops.encode import encode_corpus, history_length
from cadence_tpu_torch.core.codec import serialize_corpus
from cadence_tpu_torch.native import build as nbuild
from cadence_tpu_torch.native import packing as tp
from cadence_tpu_torch.native import wirec as tnw
from cadence_tpu_torch.ops.wirec import ProfileMisfit
from tests.torch_parity import assert_corpora_equal, reference_native


@pytest.fixture(scope="module", autouse=True)
def _reference_libraries():
    reference_native()


def _hists(suite, n=6, seed=31, target=90):
    return generate_corpus(suite, num_workflows=n, seed=seed, target_events=target)


@pytest.fixture(scope="module")
def blobs():
    """Each suite's histories, serialized by the port's codec (the same
    bytes as the JAX package's), and their longest history."""
    out = {}
    for suite in SUITES:
        hs = _hists(suite)
        b = serialize_corpus(hs)
        assert b == j_serialize(hs)
        out[suite] = (b, max(history_length(h) for h in hs))
    return out


@pytest.mark.parametrize("suite", SUITES)
def test_pack_serialized_same_bytes(suite, blobs):
    b, E = blobs[suite]
    got = tp.pack_serialized(b, E)
    want = jp.pack_serialized(b, E)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("suite", SUITES)
def test_pack_serialized32_same_bytes(suite, blobs):
    b, E = blobs[suite]
    got = tp.pack_serialized32(b, E)
    want = jp.pack_serialized32(b, E)
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_pack_serialized_into_a_reused_buffer(blobs):
    b, E = blobs["timer_retry"]
    out = np.full((len(b), E + 3, 18), 77, dtype=np.int64)
    assert tp.pack_serialized(b, E + 3, out=out) is out
    assert np.array_equal(out, jp.pack_serialized(b, E + 3))
    with pytest.raises(ValueError, match="out buffer"):
        tp.pack_serialized(b, E, out=out)


@pytest.mark.parametrize("suite", ["basic", "ndc"])
def test_encode_corpus_native_equal(suite):
    hs = _hists(suite)
    got = tp.encode_corpus_native(hs)
    assert np.array_equal(got, jp.encode_corpus_native(hs))
    assert np.array_equal(got, encode_corpus(hs, got.shape[1]))


def test_encode_corpus_native_refuses_chains():
    from cadence_tpu_torch.gen.corpus import generate_corpus as t_generate

    hs = t_generate("basic", 2, seed=3, target_events=20)
    hs[0][-1].new_run_events = list(hs[1][0].events)
    with pytest.raises(ValueError, match="new_run_events"):
        tp.encode_corpus_native(hs)


def _same_error(fn_port, fn_jax, *args):
    with pytest.raises(ValueError) as got:
        fn_port(*args)
    with pytest.raises(ValueError) as want:
        fn_jax(*args)
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_truncated_blob_same_error():
    b = serialize_corpus(_hists("basic", 2, seed=1, target=40))
    b[1] = b[1][:len(b[1]) // 2]
    msg = _same_error(tp.pack_serialized, jp.pack_serialized, b, 64)
    assert "workflow 1" in msg and "code 1" in msg


def test_overlong_history_same_error():
    b = serialize_corpus(_hists("basic", 1, seed=1, target=60))
    assert "code 3" in _same_error(tp.pack_serialized, jp.pack_serialized, b, 8)


def test_wire32_lane_overflow_same_error():
    hs = _hists("basic", 3, seed=1, target=30)
    hs[2][0].events[0].task_id = 1 << 40  # beyond int32
    b = serialize_corpus(hs)
    msg = _same_error(tp.pack_serialized32, jp.pack_serialized32, b, 64)
    assert "workflow 2" in msg and "code 4" in msg and "int64 path" in msg


@pytest.mark.parametrize("suite", SUITES)
def test_pack_serialized_wirec_first_chunk_same_bytes(suite, blobs):
    b, E = blobs[suite]
    got, n = tnw.pack_serialized_wirec(b, E, out=tnw.WirecBuffers(len(b), E))
    want, n_j = jnw.pack_serialized_wirec(b, E)
    assert_corpora_equal(got, want)
    assert n == n_j == int(want.n_events.sum())


def test_pack_serialized_wirec_pinned_streaming_chunks():
    """Chunk 0 measures; later chunks go through the fused call under the
    pin into ONE reused slot: every chunk the JAX package's bytes."""
    hs = _hists("basic", n=24, seed=41, target=60)
    E = max(history_length(h) for h in hs)
    b = serialize_corpus(hs)
    buf = tnw.WirecBuffers(8, E)
    pinned = None
    for lo in range(0, len(b), 8):
        chunk = b[lo:lo + 8]
        got, n = tnw.pack_serialized_wirec(chunk, E, profile=pinned, out=buf)
        want, n_j = jnw.pack_serialized_wirec(chunk, E, profile=pinned)
        assert_corpora_equal(got, want)
        assert n == n_j
        assert got.slab is buf.slab  # written into the ring slot
        pinned = pinned or got.profile


def test_pack_serialized_wirec_misfit_raises_and_leaves_the_lanes():
    narrow = serialize_corpus(_hists("basic", 8, seed=3, target=30))
    wide = serialize_corpus(_hists("timer_retry", 8, seed=3, target=30))
    E = 64
    pin = tnw.pack_serialized_wirec(narrow, E)[0].profile
    with pytest.raises(jw.ProfileMisfit):
        jnw.pack_serialized_wirec(wide, E, profile=pin)
    buf = tnw.WirecBuffers(8, E)
    with pytest.raises(ProfileMisfit, match="native"):
        tnw.pack_serialized_wirec(wide, E, profile=pin, out=buf)
    # the refit measures from the lanes the fused call left in the slot
    assert np.array_equal(buf.lanes, jp.pack_serialized(wide, E))
    assert_corpora_equal(tnw.pack_wirec_native(buf.lanes, out=buf), jw.pack_wirec(buf.lanes))


def test_wirec_buffers_resize_only_on_a_new_width():
    buf = tnw.WirecBuffers(4, 10)
    c = jw.pack_wirec(encode_corpus(_hists("basic", 4, seed=2, target=8), 10))
    slab = buf.for_profile(c.profile)[0]
    assert buf.for_profile(c.profile)[0] is slab
    with pytest.raises(ValueError, match="slot"):
        tnw.pack_serialized_wirec([b"\x00\x00\x00\x00"] * 3, 10, out=buf)


@pytest.mark.parametrize("name,args,restype", [
    ("cadence_pack_corpus", [ctypes.c_char_p] + ["i64p"] + ["i64"] * 3 + ["i64p", "i64"], "i64"),
    ("cadence_pack_corpus32", [ctypes.c_char_p] + ["i64p"] + ["i64"] * 3 + ["i32p", "i64"], "i64"),
    ("cadence_wirec_pack_fused",
     [ctypes.c_char_p, "i64p", "i64", "i64", "i64", "i64p"] + ["i64p"] * 7
     + ["i64", "i64", "i64", "u8p", "i64p", "i32p", "i64p", "i64"], "i64"),
    ("cadence_wirec_measure", ["i64p", "i64", "i64", "i64"] + ["i64p"] * 4 + ["i64"], "i64"),
    ("cadence_wirec_emit", ["i64p", "i64", "i64", "i64"] + ["i64p"] * 7
     + ["i64", "i64", "i64", "u8p", "i64p", "i32p", "i64"], "i64"),
])
def test_entry_points_declare_the_64_bit_abi(name, args, restype):
    """Every exported entry point carries its 64-bit argument and return
    types: ctypes' default int would cut an offset, a count or a return
    past 2**31 to 32 bits."""
    types = {"i64": ctypes.c_int64, "i64p": ctypes.POINTER(ctypes.c_int64),
             "i32p": ctypes.POINTER(ctypes.c_int32), "u8p": ctypes.POINTER(ctypes.c_uint8)}
    fn = getattr(nbuild.load_wirec(), name)
    assert fn.restype is types[restype]
    assert list(fn.argtypes) == [types.get(a, a) for a in args]


def test_pack_return_is_not_cut_to_32_bits():
    """A real call through the declared types returns the packed-event
    count whole."""
    b = serialize_corpus(_hists("basic", 3, seed=5, target=40))
    lib = nbuild.load_wirec()
    blob, offsets = tp.blob_offsets(b)
    out = np.empty((3, 64, 18), dtype=np.int64)
    rc = lib.cadence_pack_corpus(blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                 3, 64, 18, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 1)
    assert isinstance(rc, int) and rc == int((out[:, :, 0] > 0).sum())
