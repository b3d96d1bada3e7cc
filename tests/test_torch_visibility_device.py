"""The port's device visibility view (cadence_tpu_torch/engine/
visibility_device.py, columns on the CPU, where kernels J, K and L run
their plain versions) side by side with the JAX package's, on the same
records and queries, in the shapes of tests/test_visibility_device.py:
fuzzed queries, incremental appends, staleness, pagination and the kill
switch. Ids (in order), counts, pages, tokens and the stats counters must
be equal, and parity divergence 0 on both."""
import random

import numpy as np
import pytest
import torch

from cadence_tpu.engine import persistence as jp
from cadence_tpu.engine import visibility_device as jvd
from cadence_tpu_torch.engine import persistence as tp
from cadence_tpu_torch.engine import visibility_device as tvd
from cadence_tpu_torch.ops import scan as ts
from cadence_tpu_torch.utils import metrics as tm

DOMAIN = "d-test"


@pytest.fixture
def vis_env(monkeypatch):
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY", "1")
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY_PARITY", "1")
    # a window no test outlasts: drains happen only in the query path's
    # flush, at the same points in both packages
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY_WAIT_US", "600000000")
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY_BATCH", "1000000")
    tm.DEFAULT_REGISTRY.reset()
    yield
    tvd.reset_all()
    jvd.reset_all()


class Pair:
    """A JAX VisibilityStore and a port one (device "cpu") fed the same
    writes; `ask` runs one read on both and holds the answers equal."""

    def __init__(self):
        self.j = jp.VisibilityStore()
        self.t = tp.VisibilityStore()
        self.t.device = "cpu"

    def start(self, *fields, **kw):
        self.j.record_started(jp.VisibilityRecord(*fields, **kw))
        self.t.record_started(tp.VisibilityRecord(*fields, **kw))

    def write(self, method, *args):
        getattr(self.j, method)(*args)
        getattr(self.t, method)(*args)

    def query(self, q):
        return self._ask(lambda s: [(r.workflow_id, r.run_id) for r in s.query(DOMAIN, q)])

    def count(self, q=""):
        return self._ask(lambda s: s.count(DOMAIN, q))

    def page(self, q, size, token=None):
        return self._ask(lambda s: (lambda out: ([(r.workflow_id, r.run_id) for r in out[0]],
                                                 out[1]))(s.query_page(DOMAIN, q, size, token)))

    def walk(self, q, size):
        out, token, pages = [], None, 0
        while True:
            ids, token = self.page(q, size, token)
            out.extend(ids)
            pages += 1
            if token is None or pages > 100:
                return out, pages

    def _ask(self, fn):
        want, got = fn(self.j), fn(self.t)
        assert got == want
        return got

    def views(self):
        return self.j._device, self.t._device

    def check_stats(self):
        """Every stats() key of the port's view equal to the JAX view's
        (which alone has compile_cache_hits/misses), divergence 0."""
        jv, tv = self.views()
        js, ts_ = jv.stats(), tv.stats()
        assert set(js) - set(ts_) == {"compile_cache_hits", "compile_cache_misses"}
        assert ts_ == {k: v for k, v in js.items() if k in ts_}
        assert ts_["parity_divergence"] == 0
        return ts_


def _host_truth(store, query: str):
    from cadence_tpu_torch.engine.visibility_query import compile_query_with_hints

    pred, _ = compile_query_with_hints(query)
    with store._lock:
        return {(r.workflow_id, r.run_id) for r in store._records.values()
                if r.domain_id == DOMAIN and pred(r)}


def _seed(pair, rng, n, attr_pool):
    for i in range(n):
        attrs = {}
        for name, kind in attr_pool:
            r = rng.random()
            if r < 0.4:
                continue
            if kind == "num":
                attrs[name] = (rng.randrange(-5, 15) if rng.random() < 0.7
                               else round(rng.uniform(-2, 8), 2))
            elif kind == "str":
                attrs[name] = f"v{rng.randrange(6)}"
            else:
                attrs[name] = rng.randrange(4) if rng.random() < 0.5 else f"m{rng.randrange(3)}"
        pair.start(DOMAIN, f"wf-{i}", f"run-{i}", f"type-{rng.randrange(5)}",
                   rng.randrange(0, 50) * 1_000 + rng.randrange(3), search_attrs=attrs)
        if rng.random() < 0.45:
            pair.write("record_closed", DOMAIN, f"wf-{i}", f"run-{i}", rng.randrange(1, 10 ** 6),
                       rng.randrange(0, 6))


_FIELDS = ("WorkflowID", "WorkflowType", "RunID", "CloseStatus", "StartTime", "CloseTime",
           "Num", "Str", "Mixed", "Absent")
_OPS = ("=", "!=", "<", "<=", ">", ">=")


def _rand_value(rng, field):
    r = rng.random()
    if field == "WorkflowType" and r < 0.6:
        return f"'type-{rng.randrange(6)}'"
    if field in ("WorkflowID", "RunID") and r < 0.6:
        return f"'{'wf' if field == 'WorkflowID' else 'run'}-{rng.randrange(40)}'"
    if field == "CloseStatus" and r < 0.4:
        return rng.choice(["'Completed'", "'Failed'", "-1", "0", "5"])
    if field == "Str" and r < 0.7:
        return f"'v{rng.randrange(8)}'"
    if r < 0.25:
        return f"'s{rng.randrange(4)}'"
    if r < 0.5:
        return str(round(rng.uniform(-3, 12), 2))
    if r < 0.6:
        return str(rng.randrange(0, 50) * 1_000)
    return str(rng.randrange(-5, 15))


def _rand_query(rng, depth=2):
    if depth <= 0 or rng.random() < 0.45:
        field = rng.choice(_FIELDS)
        return f"{field} {rng.choice(_OPS)} {_rand_value(rng, field)}"
    q = f"{_rand_query(rng, depth - 1)} {'AND' if rng.random() < 0.5 else 'OR'} " \
        f"{_rand_query(rng, depth - 1)}"
    return f"({q})" if rng.random() < 0.3 else q


@pytest.mark.parametrize("seed", [11, 23])
def test_fuzz_parity(vis_env, seed):
    from cadence_tpu_torch.engine.visibility_query import parse_query

    rng = random.Random(seed)
    pair = Pair()
    _seed(pair, rng, 150, (("Num", "num"), ("Str", "str"), ("Mixed", "mixed")))
    queries = 0
    for _ in range(30):
        q = _rand_query(rng)
        try:
            parse_query(q)
        except Exception:
            continue
        ids = pair.query(q)
        assert set(ids) == _host_truth(pair.t, q), q
        assert pair.count(q) == len(ids)
        queries += 1
    assert queries >= 25
    stats = pair.check_stats()
    assert stats["device_served"] > 0 and stats["parity_checks"] > 0
    assert stats["device_served"] + stats["host_fallbacks"] >= 2 * queries


def test_string_ordering_falls_back_counted(vis_env):
    pair = Pair()
    _seed(pair, random.Random(5), 40, (("Num", "num"),))
    pair.query("WorkflowType > 'type-2'")
    pair.check_stats()
    assert tm.DEFAULT_REGISTRY.counter(tm.SCOPE_TPU_VISIBILITY, tm.M_VIS_FALLBACK_PREDICATE) == 1


def test_writes_visible_through_device_path(vis_env):
    pair = Pair()
    assert pair.query("") == []
    pair.start(DOMAIN, "wf-a", "r-1", "order", 100)
    assert pair.count("CloseStatus = -1") == 1
    pair.write("record_closed", DOMAIN, "wf-a", "r-1", 200, 0)
    assert pair.count("CloseStatus = -1") == 0
    assert pair.count("CloseStatus = 0") == 1
    pair.write("upsert_search_attributes", DOMAIN, "wf-a", "r-1", {"Priority": 7})
    assert pair.query("Priority >= 7") == [("wf-a", "r-1")]
    pair.write("delete_record", DOMAIN, "wf-a", "r-1")
    assert pair.count("") == 0
    pair.check_stats()


def test_nan_attr_value_poisons_column(vis_env):
    pair = Pair()
    pair.start(DOMAIN, "w0", "r0", "t", 1, search_attrs={"P": float("nan")})
    pair.start(DOMAIN, "w1", "r1", "t", 2, search_attrs={"P": 3.0})
    for q in ("P != 3", "P = 3", "P > 1"):
        assert set(pair.query(q)) == _host_truth(pair.t, q)
    stats = pair.check_stats()
    assert stats["host_fallbacks"] == 3 and not stats["quarantined"]


def test_deleted_rows_are_reused(vis_env):
    pair = Pair()
    for i in range(8):
        pair.start(DOMAIN, f"w{i}", f"r{i}", "t", i)
    assert pair.count("") == 8
    for i in range(4):
        pair.write("delete_record", DOMAIN, f"w{i}", f"r{i}")
    for i in range(8, 12):
        pair.start(DOMAIN, f"w{i}", f"r{i}", "t", i)
    assert pair.count("") == 8
    assert {w for w, _ in pair.query("")} == {f"w{i}" for i in range(4, 12)}
    assert pair.check_stats()["rows"] == 8  # reused, not appended


def test_capacity_growth_restages(vis_env, monkeypatch):
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY_CAPACITY", "64")
    pair = Pair()
    _seed(pair, random.Random(3), 300, (("Num", "num"),))
    assert pair.count("") == 300
    assert pair.count("CloseStatus = -1") == len(_host_truth(pair.t, "CloseStatus = -1"))
    assert pair.check_stats()["capacity"] == 512


def test_attr_named_like_builtin_never_aliases(vis_env):
    pair = Pair()
    for i in range(30):
        pair.start(DOMAIN, f"w{i}", f"r{i}", "t", 100 + i,
                   search_attrs={"domain": i, "start_time": f"s{i % 3}"})
    for q in ("domain > 15", "start_time = 's1'", "StartTime > 110",
              "domain > 15 AND StartTime > 110"):
        assert set(pair.query(q)) == _host_truth(pair.t, q), q
    pair.check_stats()


def test_attr_budget_lfu_replacement(vis_env, monkeypatch):
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY_ATTR_COLUMNS", "2")
    pair = Pair()
    for i in range(6):
        pair.start(DOMAIN, f"wf-{i}", f"r-{i}", "t", i,
                   search_attrs={"A": i, "B": i * 2, "C": f"c{i}"})
    assert pair.count("A >= 3") == 3
    assert pair.query("C = 'c2'") == [("wf-2", "r-2")]  # overflow: a counted fallback
    assert pair.query("C = 'c4'") == [("wf-4", "r-4")]  # the swap: served by the device
    pair.start(DOMAIN, "wf-9", "r-9", "t", 9, search_attrs={"C": "c9"})
    assert pair.query("C = 'c9'") == [("wf-9", "r-9")]
    assert pair.query("B = 4") == [("wf-2", "r-2")]
    jv, tv = pair.views()
    assert set(tv._attr_cols) == set(jv._attr_cols) == {"A", "C"}
    stats = pair.check_stats()
    assert stats["attr_overflow"] == ["B"] and stats["attr_overflow_demand"]["B"] >= 1
    assert tm.DEFAULT_REGISTRY.counter(tm.SCOPE_TPU_VISIBILITY, tm.M_VIS_ATTR_REPLACEMENTS) == 1


def test_bound_zero_flushes_before_serving(vis_env):
    pair = Pair()
    pair.start(DOMAIN, "w0", "r0", "t", 1)
    assert pair.count("") == 1
    for i in range(1, 9):
        pair.start(DOMAIN, f"w{i}", f"r{i}", "t", i)
    assert pair.count("") == 9
    assert pair.check_stats()["staleness_max"] == 8


def test_bounded_staleness_serves_stale_then_flushes(vis_env, monkeypatch):
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY_STALENESS", "100")
    pair = Pair()
    pair.start(DOMAIN, "w0", "r0", "t", 1)
    assert pair.count("") == 1
    pair.start(DOMAIN, "w1", "r1", "t", 2)
    assert pair.count("") == 1  # inside the bound: served stale, parity skipped
    for view in pair.views():
        view.flush()
    assert pair.count("") == 2
    assert pair.check_stats()["served_staleness_max"] == 1


def test_page_walk_identical_to_host(vis_env, monkeypatch):
    pair = Pair()
    _seed(pair, random.Random(9), 120, (("Num", "num"),))
    dev_walk, _ = pair.walk("CloseStatus = -1", 7)
    pair.check_stats()
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY", "0")
    assert pair.walk("CloseStatus = -1", 7)[0] == dev_walk


def test_start_time_ties_escalate_to_bitmap(vis_env, monkeypatch):
    pair = Pair()
    for i in range(200):
        pair.start(DOMAIN, f"wf-{i:03d}", f"r-{i:03d}", "t", 777)
    dev_walk, pages = pair.walk("", 10)
    assert pages >= 20
    assert pair.check_stats()["topk_escalations"] > 0
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY", "0")
    assert pair.walk("", 10)[0] == dev_walk


def test_topk_fast_path_serves_distinct_times(vis_env):
    pair = Pair()
    for i in range(300):
        pair.start(DOMAIN, f"wf-{i:03d}", f"r-{i:03d}", "t", 1000 + i)
    ids, token = pair.page("", 10)
    assert ids == [(f"wf-{i:03d}", f"r-{i:03d}") for i in range(299, 289, -1)]
    assert token == (1290, "wf-290", "r-290")
    assert pair.check_stats()["topk_serves"] == 1


def test_kill_switch_routes_host(vis_env, monkeypatch):
    pair = Pair()
    _seed(pair, random.Random(2), 30, ())
    assert pair.count("") == 30
    served = pair.check_stats()["device_served"]
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY", "0")
    assert pair.count("") == 30
    assert pair.check_stats()["device_served"] == served


def test_plan_past_the_stack_is_a_counted_fallback(vis_env, monkeypatch):
    """A plan whose program would pass kernel J's stack is served by the
    host and counted under fallback-predicate, never answered wrong."""
    monkeypatch.setattr(ts, "MAX_STACK", 2)
    store = tp.VisibilityStore()
    store.device = "cpu"
    for i in range(20):
        store.record_started(tp.VisibilityRecord(DOMAIN, f"w{i}", f"r{i}", "t", i))
    q = "(StartTime < 15 OR StartTime = 1) AND (StartTime > 3 OR StartTime = 1)"
    assert store.count(DOMAIN, q) == len(_host_truth(store, q)) == 12
    reg = tm.DEFAULT_REGISTRY
    assert reg.counter(tm.SCOPE_TPU_VISIBILITY, tm.M_VIS_FALLBACK_PREDICATE) == 1
    assert reg.counter(tm.SCOPE_TPU_VISIBILITY, tm.M_VIS_DEVICE_SERVED) == 0


@pytest.mark.parametrize("knob", ["1", "on", "yes"])
def test_no_device_named_means_the_card(monkeypatch, knob):
    """With the tier on and no device named, the view is on the card: on a
    machine without one a query raises rather than answering from the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the view would serve from it")
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY", knob)
    store = tp.VisibilityStore()
    store.record_started(tp.VisibilityRecord("d", "w", "r", "t", 5))
    for call in (lambda: store.query("d", ""), lambda: store.count("d"),
                 lambda: store.query_page("d", "", 10)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_stats_have_no_compile_cache_keys(vis_env):
    """A deliberate difference: no kernel-variant cache, so stats() drops
    compile_cache_hits/compile_cache_misses."""
    pair = Pair()
    pair.start(DOMAIN, "w", "r", "t", 5)
    assert pair.count("") == 1
    jv, tv = pair.views()
    assert {"compile_cache_hits", "compile_cache_misses"} <= set(jv.stats())
    assert not {"compile_cache_hits", "compile_cache_misses"} & set(tv.stats())
    assert isinstance(tv._dev_valid, torch.Tensor) and tv._dev_valid.device.type == "cpu"
    assert np.array_equal(tv._dev_valid.numpy(), tv._valid)


def _feed_key(view):
    """(pointer, element size) of the columns kernel L writes, in order."""
    cols = [view._dev_cols[name] for name in view._col_order()] + [view._dev_valid]
    return tuple((c.data_ptr(), c.element_size()) for c in cols)


def test_delta_feed_rebuilds_its_table_only_when_the_columns_change(vis_env, monkeypatch):
    """Kernel L's feed (ops/scan.py DeltaFeed) builds the columns' pointer
    table at the first delta and keeps it, and its host block, across
    drains; growth (a restage at twice the capacity) and a new attribute
    column make the next delta build it again, for the new columns. The
    answers stay the JAX view's."""
    monkeypatch.setenv("CADENCE_TPU_VISIBILITY_CAPACITY", "64")
    pair = Pair()
    for i in range(8):
        pair.start(DOMAIN, f"w{i}", f"r{i}", "t", i, search_attrs={"Num": i})
    assert pair.count("") == 8  # the bootstrap restage: no delta yet
    tv = pair.t._device
    assert tv._feed is None
    builds = []
    for i in range(3):  # one-row deltas: one table, one host block
        pair.write("record_closed", DOMAIN, f"w{i}", f"r{i}", 100 + i, 1)
        assert pair.count("CloseStatus = 1") == i + 1
        builds.append((tv._feed.table_builds, tv._feed._host.data_ptr()))
        assert tv._feed.table.key == _feed_key(tv)
    assert builds == [builds[0]] * 3 and builds[0][0] == 1
    for i in range(8, 100):  # growth: the drain restages at 128 rows
        pair.start(DOMAIN, f"w{i}", f"r{i}", "t", i, search_attrs={"Num": i})
    assert pair.count("") == 100 and tv.capacity == 128
    assert tv._feed.table_builds == 1
    pair.write("record_closed", DOMAIN, "w50", "r50", 150, 2)
    assert pair.count("CloseStatus = 2") == 1
    assert tv._feed.table_builds == 2 and tv._feed.table.key == _feed_key(tv)
    # a new attribute column restages; the next delta builds a third table
    pair.write("upsert_search_attributes", DOMAIN, "w60", "r60", {"Fresh": 1.5})
    assert pair.count("Fresh > 1") == 1
    pair.write("upsert_search_attributes", DOMAIN, "w61", "r61", {"Fresh": 2.5})
    assert pair.count("Fresh > 1") == 2
    assert tv._feed.table_builds == 3 and tv._feed.table.key == _feed_key(tv)
    # a delta of 90 rows (a 128-row bucket) grows the host block
    small = tv._feed._host.numel()
    for i in range(10, 100):
        pair.write("record_closed", DOMAIN, f"w{i}", f"r{i}", 300 + i, 3)
    assert pair.count("CloseStatus = 3") == 90
    assert tv._feed._host.numel() >= 2 * small and tv._feed.table_builds == 3
    pair.check_stats()
