"""The port's native wirec encoder (cadence_tpu_torch/native) against the
JAX package's numpy pack_wirec: the same profile and the same bytes, with
a free and with a pinned profile; pack_wirec_auto's count of which
encoder served; and a build that several processes may start at once.
The library is built inside the tests, never at import or collection;
g++ is on this machine, so a build that fails fails the test."""
import os
import subprocess
import sys

import numpy as np
import pytest

from cadence_tpu.ops import wirec as jw
from cadence_tpu_torch.native import build as nbuild
from cadence_tpu_torch.native import wirec as nw
from cadence_tpu_torch.ops import wirec as tw
from cadence_tpu_torch.utils import metrics as m
from tests.torch_parity import WIREC_KINDS, assert_corpora_equal, wirec_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("pinned", [False, True], ids=["free", "pinned"])
@pytest.mark.parametrize("kind", WIREC_KINDS)
def test_native_pack_same_bytes(kind, pinned):
    ev = wirec_corpus(kind)
    want = jw.pack_wirec(ev)
    got = nw.pack_wirec_native(ev, profile=tw.pack_wirec(ev).profile if pinned else None)
    assert_corpora_equal(got, want)
    if not pinned:
        assert nw.measure_profile_native(ev) == tuple(tw.pack_wirec(ev).profile)


@pytest.mark.parametrize("threads", [1, 3])
def test_native_pack_threads_same_bytes(threads):
    ev = np.concatenate([wirec_corpus("timer_retry")] * 8)
    assert_corpora_equal(nw.pack_wirec_native(ev, num_threads=threads), jw.pack_wirec(ev))


def test_native_misfit_raises():
    ev = wirec_corpus("basic")
    profile = jw.pack_wirec(ev).profile
    wild = ev.copy()
    wild[:, 1::2, 3] += 7  # breaks the timestamp lane's delta scale
    with pytest.raises(jw.ProfileMisfit):
        jw.pack_wirec(wild, profile=profile)
    with pytest.raises(tw.ProfileMisfit, match="native"):
        nw.pack_wirec_native(wild, profile=profile)


@pytest.mark.parametrize("env,served", [("", m.M_NATIVE_PACKS), ("0", m.M_NATIVE_PY_PACKS)],
                         ids=["native", "numpy"])
def test_pack_wirec_auto_counts_the_encoder(env, served, monkeypatch):
    monkeypatch.setenv(nw.NATIVE_WIREC_ENV, env)
    reg = m.MetricsRegistry()
    ev = wirec_corpus("ndc")
    assert_corpora_equal(nw.pack_wirec_auto(ev, registry=reg), jw.pack_wirec(ev))
    other = ({m.M_NATIVE_PACKS, m.M_NATIVE_PY_PACKS} - {served}).pop()
    assert reg.counter(m.SCOPE_TPU_NATIVE, served) == 1
    assert reg.counter(m.SCOPE_TPU_NATIVE, other) == 0
    assert reg.gauge_value(m.SCOPE_TPU_NATIVE, m.M_NATIVE_AVAILABLE) == 1.0


def test_concurrent_builds_do_not_race(tmp_path):
    """Four processes build into one empty directory at once: each
    compiles to a temporary file of its own and renames it into place, so
    all four load a whole library and no temporary file is left."""
    code = (
        "import sys\n"
        "from cadence_tpu_torch.native import build as b\n"
        "b._BUILD_DIR = sys.argv[1]\n"
        "import ctypes; ctypes.CDLL(b.build()).cadence_wirec_emit\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert all(out.strip() == "ok" for out, _ in outs)
    names = sorted(os.listdir(tmp_path))
    assert names == [os.path.basename(nbuild.library_path())]


def test_stage_corpus_on_the_cpu_keeps_the_bytes():
    c = tw.pack_wirec(wirec_corpus("echo_signal"))
    slab, bases, n = nw.stage_corpus(c, device="cpu")
    assert np.array_equal(slab.numpy(), c.slab) and np.array_equal(bases.numpy(), c.bases)
    assert np.array_equal(n.numpy(), c.n_events)
