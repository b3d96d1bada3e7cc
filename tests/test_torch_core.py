"""The modules cadence_tpu_torch copies from the JAX package (core/, oracle/,
gen/corpus.py, ops/encode.py) give the JAX package's outputs: the same
histories, the same lane arrays, the same oracle payload rows and CRCs."""
import numpy as np
import pytest

from cadence_tpu.core import checksum as j_checksum
from cadence_tpu.gen import corpus as j_corpus
from cadence_tpu.gen.fuzz import history_digest
from cadence_tpu.ops import encode as j_encode
from cadence_tpu.oracle.state_builder import StateBuilder as JStateBuilder
from cadence_tpu_torch.core import checksum as t_checksum
from cadence_tpu_torch.gen import corpus as t_corpus
from cadence_tpu_torch.ops import encode as t_encode
from cadence_tpu_torch.oracle.state_builder import StateBuilder as TStateBuilder

SUITES = list(j_corpus.SUITES) + ["overflow"]
N = 12


def _both(suite, n=N, seed=7, target_events=90):
    return (j_corpus.generate_corpus(suite, n, seed=seed, target_events=target_events),
            t_corpus.generate_corpus(suite, n, seed=seed, target_events=target_events))


def test_suites_are_the_same():
    assert tuple(t_corpus.SUITES) == tuple(j_corpus.SUITES)


@pytest.mark.parametrize("suite", SUITES)
def test_histories_identical(suite):
    jh, th = _both(suite)
    assert [history_digest(h) for h in th] == [history_digest(h) for h in jh]


@pytest.mark.parametrize("suite", SUITES)
def test_encoders_identical(suite):
    jh, th = _both(suite)
    jev, tev = j_encode.encode_corpus(jh), t_encode.encode_corpus(th)
    assert tev.dtype == jev.dtype and np.array_equal(tev, jev)
    assert np.array_equal(t_encode.to_wire32(tev), j_encode.to_wire32(jev))
    # a chain of every history's batches, and a two-segment branch tree
    jchain = j_encode.encode_chain([h for h in jh[:3]], 400)
    tchain = t_encode.encode_chain([h for h in th[:3]], 400)
    assert np.array_equal(tchain, jchain)
    jseg = j_encode.encode_segments([(jh[0][:2], 0, 0, False), (jh[0][2:4], 1, 0, True)], 200)
    tseg = t_encode.encode_segments([(th[0][:2], 0, 0, False), (th[0][2:4], 1, 0, True)], 200)
    assert np.array_equal(tseg, jseg)


@pytest.mark.parametrize("suite", SUITES)
def test_oracle_rows_and_crcs_identical(suite):
    jh, th = _both(suite)
    for j, t in zip(jh, th):
        try:
            jrow = j_checksum.payload_row(JStateBuilder().replay_history(j))
        except OverflowError:
            with pytest.raises(OverflowError):
                t_checksum.payload_row(TStateBuilder().replay_history(t))
            continue
        trow = t_checksum.payload_row(TStateBuilder().replay_history(t))
        assert np.array_equal(trow, jrow)
        assert np.array_equal(t_checksum.crc32_of_rows(trow[None]),
                              j_checksum.crc32_of_rows(jrow[None]))
