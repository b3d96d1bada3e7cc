"""The port's serving scheduler (cadence_tpu_torch/engine/serving.py) on the
CPU beside the JAX package's: tests/test_serving.py's scheduler-seam cases
(not the Onebox ones), each driven through `submit` on both schedulers
over the same seeded histories (each package generating its own), with
the drain thread disabled and every flush driven by hand. The
ServingResult fields (ok, parity_ok, checksum, path, escalated, error)
and the tpu.serving counters must be equal, ServiceBusyError must come at
the same queue bound, and warm() must count the same shapes."""
import numpy as np
import pytest

from cadence_tpu.core.checksum import DEFAULT_LAYOUT, STICKY_ROW_INDEX
from cadence_tpu_torch.parallel.mesh import Mesh
from cadence_tpu_torch.utils import metrics as m
from tests.torch_parity import PACKAGES, overflow_chain, package, reset_port_tiers

LAYOUT = DEFAULT_LAYOUT
FIELDS = ("ok", "parity_ok", "checksum", "path", "escalated", "error")
COUNTERS = (m.M_SERVING_TXNS, m.M_SERVING_LAUNCHES, m.M_SERVING_COALESCED,
            m.M_SERVING_DIVERGENCE, m.M_SERVING_EXACT, m.M_SERVING_SUFFIX, m.M_SERVING_COLD,
            m.M_SERVING_BYPASSED, m.M_SERVING_REQUEUED, m.M_SERVING_REJECTED)


@pytest.fixture(autouse=True)
def _isolated():
    yield
    reset_port_tiers()


class Harness:
    """One package's scheduler over injected histories; flushes by hand."""

    def __init__(self, pkg, workflows=3, target_events=24, hists=None, **kw):
        self.pkg = pkg
        gen = package(pkg, "gen.corpus")
        self.hists = hists(pkg) if hists else gen.generate_corpus(
            "basic", num_workflows=workflows, seed=11, target_events=target_events)
        self.keys = [("t", f"wf-{i}", "r") for i in range(len(self.hists))]
        self.counts = {k: len(h) for k, h in zip(self.keys, self.hists)}
        self.by_key = dict(zip(self.keys, self.hists))
        stores = package(pkg, "engine.persistence").Stores()
        engine = package(pkg, "engine.tpu_engine").TPUReplayEngine
        if pkg == "cadence_tpu":
            self.tpu = engine(stores, LAYOUT)
        else:
            self.tpu = engine(stores, LAYOUT, mesh=Mesh(["cpu"]))
        self.tpu.metrics = package(pkg, "utils.metrics").MetricsRegistry()
        self.sched = package(pkg, "engine.serving").ServingScheduler(
            self.tpu, read_batches=self.read_batches, read_live_row=self.read_live_row, **kw)
        self.sched._ensure_thread = lambda: None
        self.batch_crc = package(pkg, "engine.cache").batch_crc

    def read_batches(self, key):
        return self.by_key[key][:self.counts[key]]

    def read_live_row(self, key):
        ms = package(self.pkg, "oracle.state_builder").StateBuilder().replay_history(
            self.read_batches(key))
        row = package(self.pkg, "core.checksum").payload_row(ms, LAYOUT)
        row[STICKY_ROW_INDEX] = 0
        return row, int(ms.version_histories.current_index), int(ms.execution_info.next_event_id)

    def oracle(self, key):
        row, br, _ = self.read_live_row(key)
        return row, br

    def submit(self, key, row=None, branch=None, tail_crc=None, batch=None):
        if row is None:
            row, branch = self.oracle(key)
        if tail_crc is None:
            tail_crc = self.batch_crc(self.read_batches(key)[-1])
        return self.sched.submit(key, row, branch, tail_crc, batch=batch)

    def flush(self):
        with self.sched._cv:
            batch = list(self.sched._pending.values())
            self.sched._pending.clear()
        if batch:
            self.sched._flush(batch)

    def counters(self):
        scope = package(self.pkg, "utils.metrics").SCOPE_TPU_SERVING
        return {name: self.sched.metrics.counter(scope, name) for name in COUNTERS}


def outcome(t):
    r = t.result(timeout=1)
    return tuple(getattr(r, f) for f in FIELDS)


def both(scenario, **kw):
    """Run scenario(harness) -> [ServingResult tuples] on both packages;
    the results and the counters must be equal. Returns the port's."""
    out = []
    for pkg in PACKAGES:
        h = Harness(pkg, **kw)
        out.append((scenario(h), h.counters(), h))
    (want, want_c, _), (got, got_c, h) = out
    assert got == want
    assert got_c == want_c
    return got, h


def cold_then_suffix(h):
    k = h.keys[0]
    h.counts[k] = len(h.by_key[k]) - 1
    t_cold = h.submit(k)
    h.flush()
    h.counts[k] += 1
    t_sfx = h.submit(k)
    h.flush()
    return [outcome(t_cold), outcome(t_sfx)]


def coalesce(h):
    k = h.keys[0]
    h.counts[k] = len(h.by_key[k]) - 2
    seeded = h.submit(k)
    h.flush()
    tickets = []
    for _ in range(2):
        h.counts[k] += 1
        tickets.append(h.submit(k))
    assert len(h.sched._pending) == 1
    h.flush()
    assert tickets[1].result(timeout=1).coalesced
    return [outcome(seeded)] + [outcome(t) for t in tickets]


def exact_serve(h):
    k = h.keys[0]
    first = h.submit(k)
    h.flush()
    again = h.submit(k)
    h.flush()
    return [outcome(first), outcome(again)]


def divergence(h):
    k = h.keys[0]
    first = h.submit(k)
    h.flush()
    wrong = h.oracle(k)[0].copy()
    wrong[0] += 1
    t = h.submit(k, row=wrong, branch=h.oracle(k)[1])
    h.flush()
    assert h.tpu.resident.lookup(k, h.read_batches(k)) is None
    return [outcome(first), outcome(t)]


def tail_moved(h):
    k = h.keys[0]
    h.counts[k] = len(h.by_key[k]) - 1
    first = h.submit(k)
    h.flush()
    stale_tail = h.batch_crc(h.read_batches(k)[-1])
    row, br = h.oracle(k)
    h.counts[k] += 1
    t = h.sched.submit(k, row, br, stale_tail)
    h.flush()
    return [outcome(first), outcome(t)]


def multi_branch(h):
    k = h.keys[0]
    first = h.submit(k)
    h.flush()
    h.sched._read_batches = lambda key: None
    t = h.sched.submit(k, np.zeros(LAYOUT.width, np.int64), 0, 1)
    h.flush()
    return [outcome(first), outcome(t)]


def chained_zero_read(h):
    k = h.keys[0]
    h.counts[k] = len(h.by_key[k]) - 2
    out = [h.submit(k)]
    h.flush()
    armed = {"on": False}
    real = h.read_batches

    def guarded(key):
        assert not armed["on"], "the chain path read the store"
        return real(key)

    h.sched._read_batches = guarded
    for _ in range(2):
        h.counts[k] += 1
        batch = h.by_key[k][h.counts[k] - 1]
        out.append(h.submit(k, tail_crc=h.batch_crc(batch), batch=batch))
        armed["on"] = True
        h.flush()
        armed["on"] = False
    return [outcome(t) for t in out]


def overflow_suffix(h):
    """The overflow chain's first append overflows inside the scheduler:
    escalate_resident widens the pinned state; its second drains it."""
    k = h.keys[0]
    prefix, append1, _ = overflow_chain(h.pkg)
    out = []
    for n in (len(prefix), len(append1), len(h.by_key[k])):
        h.counts[k] = n
        out.append(h.submit(k))
        h.flush()
    return [outcome(t) for t in out]


SCENARIOS = [cold_then_suffix, coalesce, exact_serve, divergence, tail_moved, multi_branch,
             chained_zero_read]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equals_jax(scenario):
    got, h = both(scenario, workflows=2)
    assert all(r[0] for r in got[:1])


def test_cold_then_suffix_checksums_match_the_oracle():
    got, h = both(cold_then_suffix, workflows=2)
    from cadence_tpu_torch.core.checksum import crc32_of_row

    assert [r[3] for r in got] == ["cold", "suffix"]
    assert got[1][2] == int(crc32_of_row(h.oracle(h.keys[0])[0]))
    assert h.counters()[m.M_SERVING_DIVERGENCE] == 0


def test_overflowing_suffix_escalates_inside_the_scheduler():
    chain = lambda pkg: [overflow_chain(pkg)[2]]  # noqa: E731
    got, h = both(overflow_suffix, hists=chain)
    assert [(r[0], r[3], r[4]) for r in got] == [(True, "cold", False), (True, "suffix", True),
                                                 (True, "suffix", False)]
    entry = h.tpu.resident.entry_for(h.keys[0])
    assert entry is not None and entry.rung == 0


def test_bounded_queue_sheds_typed_service_busy():
    rejected = []
    for pkg in PACKAGES:
        h = Harness(pkg, workflows=3, max_queue=2)
        busy = package(pkg, "utils.quotas").ServiceBusyError
        h.submit(h.keys[0])
        h.submit(h.keys[1])
        with pytest.raises(busy) as exc:
            h.submit(h.keys[2])
        assert exc.value.retry_after_s > 0
        h.submit(h.keys[0])  # a same-key submit still folds
        rejected.append(h.counters())
    assert rejected[0] == rejected[1]
    assert rejected[1][m.M_SERVING_REJECTED] == 1 and rejected[1][m.M_SERVING_COALESCED] == 1


def test_stop_resolves_pending_not_ok():
    got = []
    for pkg in PACKAGES:
        h = Harness(pkg, workflows=1)
        t = h.submit(h.keys[0])
        h.sched.stop()
        got.append(outcome(t))
    assert got[0] == got[1] and got[1][-1] == "stopped"


def test_drain_thread_end_to_end():
    """The port's real drain loop (lazy thread start, adaptive window,
    drain() settling) gives the results of the JAX package's scheduler
    flushed by hand."""
    j = Harness("cadence_tpu", workflows=2)
    jt = [j.submit(k) for k in j.keys]
    j.flush()
    h = Harness("cadence_tpu_torch", workflows=2, max_wait_us=1000)
    del h.sched._ensure_thread
    tickets = [h.submit(k) for k in h.keys]
    assert h.sched.drain(timeout=60.0)
    assert [outcome(t) for t in tickets] == [outcome(t) for t in jt]
    assert h.sched.stats()["parity_divergence"] == 0
    h.sched.stop()


def test_warm_counts_the_jax_shapes():
    counts = []
    for pkg in PACKAGES:
        h = Harness(pkg, workflows=1)
        counts.append(h.sched.warm(e_shapes=(16,), width=8))
    assert counts == [1, 1]
    h = Harness("cadence_tpu_torch", workflows=1)
    assert h.sched.warm(e_shapes=(16, 32), width=16) == 4


def test_module_knobs_equal_jax(monkeypatch):
    from cadence_tpu.engine import serving as js
    from cadence_tpu_torch.engine import serving as ts

    for value in ("", "8,64", "bad"):
        monkeypatch.setenv("CADENCE_TPU_SERVING_WARM_EVENTS", value)
        assert ts.warm_event_shapes() == js.warm_event_shapes()
    for value in ("0", "1", "off"):
        monkeypatch.setenv("CADENCE_TPU_SERVING", value)
        monkeypatch.setenv("CADENCE_TPU_SERVING_WARM", value)
        assert (ts.enabled(), ts.warm_on_boot()) == (js.enabled(), js.warm_on_boot())
