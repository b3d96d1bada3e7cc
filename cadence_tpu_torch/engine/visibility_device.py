"""Device-side visibility: List/Scan/Count as a columnar scan on the card.

The reference needs an Elasticsearch cluster for advanced visibility
(PAPER §2.4: transfer tasks re-index executions into ES, and the esql
layer routes SQL-ish query strings at it). This repo's reframed
`VisibilityStore` (engine/persistence.py) replaced ES with host-side
dict/set indexes — which at the "millions of executions" scale the
serving tier now sustains becomes the next serving wall: every List/
Scan/Count walks Python objects record-by-record under one lock.

This module is the same move that built the rest of the repo: reframe
the index as a batched columnar kernel. `DeviceVisibilityView` mirrors
the host store into device-resident COLUMNS —

- interned string ids (domain, workflow id, run id, workflow type, and
  string-valued custom search attributes): int64, NULL_ID = absent;
- int64 time/status columns (start/close time, close status);
- float64 numeric search-attribute columns (IEEE NaN = absent);

— staged host→device through the wirec idiom (`native/wirec.stage_h2d`:
fresh page-locked copies on a side stream) at bootstrap and restage, and
each delta batch packed into one reused page-locked block and copied
once (ops/scan.py DeltaFeed),
and serves queries by compiling the parsed AST
(engine/visibility_query.py) into a plan that kernels J and K
(ops/scan.py, csrc/scan.cu) evaluate per row; kernel L scatters delta
batches into the columns in place. The kernels take the plan at run
time, so nothing compiles per query shape, and only matching row ids
come back off the device (a packed bitmap, a scalar count, or a top-K
page via a device sort over the start-time column).

The HOST STORE STAYS THE WRITE-SIDE AUTHORITY. Every mutation lands in
`VisibilityStore` first and enqueues a column delta here (sequence-
numbered under the store lock, so delta order equals mutation order); a
coalescing appender thread (mirroring engine/serving.py's drain window)
folds bursts into one scatter launch. A query observes the backlog as
its STALENESS (recorded gauge); when the backlog exceeds the query's
consistency bound (CADENCE_TPU_VISIBILITY_STALENESS, default 0 =
read-your-writes) the query flushes inline before scanning — which is
also what makes every device answer PARITY-GATEABLE: with parity on
(default), each query is re-evaluated on the host under the same lock
and a divergent device answer is counted, never served, and quarantines
the view. Queries the kernels cannot express (ordering on interned
string columns, attr columns past the intern budget or type-poisoned)
fall back to the host evaluator — counted, never silently divergent.

This is the JAX package's engine/visibility_device.py with its columns as
torch tensors on the view's device (None: the card; tests name the CPU,
where the plain versions of kernels J, K and L serve). Its one difference
is stats(): the JAX package's compile_cache_hits/compile_cache_misses
keys are gone with the kernel-variant cache they counted.
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import metrics as m

#: master switch + kill switch: unset/0/false/off = host path
VIS_ENV = "CADENCE_TPU_VISIBILITY"
#: per-query host parity gate (default ON — the acceptance bar; bench
#: turns it off to time the pure device path)
VIS_PARITY_ENV = "CADENCE_TPU_VISIBILITY_PARITY"
#: max pending deltas a query may serve over WITHOUT flushing (its
#: consistency bound); 0 = always flush = read-your-writes
VIS_STALENESS_ENV = "CADENCE_TPU_VISIBILITY_STALENESS"
#: appender coalescing window (microseconds) and max drain batch
VIS_WAIT_ENV = "CADENCE_TPU_VISIBILITY_WAIT_US"
VIS_BATCH_ENV = "CADENCE_TPU_VISIBILITY_BATCH"
#: custom search-attribute column budget (keys past it fall back)
VIS_ATTRS_ENV = "CADENCE_TPU_VISIBILITY_ATTR_COLUMNS"
#: initial row capacity (pow2; doubles on growth with a full restage)
VIS_CAP_ENV = "CADENCE_TPU_VISIBILITY_CAPACITY"

#: ints beyond 2^53 lose precision in a float64 attr column — the plan
#: refuses the comparison (host fallback) rather than round
_F64_EXACT = 1 << 53

#: staleness histogram buckets: pending-delta COUNTS, not seconds
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 1024.0, 4096.0)

#: builtin column order (attr columns append after these)
_BUILTINS = ("domain", "workflow_id", "run_id", "workflow_type",
             "close_status", "start_time", "close_time")
_BUILTIN_KINDS = {"domain": "id", "workflow_id": "id", "run_id": "id",
                  "workflow_type": "id", "close_status": "i64",
                  "start_time": "i64", "close_time": "i64"}

_VIEWS: "weakref.WeakSet" = weakref.WeakSet()


def _env_off(value: str) -> bool:
    return value.strip().lower() in ("0", "false", "off", "no")


def _reason_metric(exc) -> str:
    """Which fallback counter an UnsupportedPredicate lands on."""
    return (m.M_VIS_FALLBACK_COLUMN
            if getattr(exc, "reason", "") == "column"
            else m.M_VIS_FALLBACK_PREDICATE)


def enabled() -> bool:
    """The device tier's master/kill switch."""
    env = os.environ.get(VIS_ENV, "")
    return bool(env.strip()) and not _env_off(env)


def parity_enabled() -> bool:
    env = os.environ.get(VIS_PARITY_ENV, "")
    return not _env_off(env) if env.strip() else True


def register(view: "DeviceVisibilityView") -> None:
    _VIEWS.add(view)


def reset_all() -> None:
    """Stop every live view's appender thread (conftest hygiene — a
    leaked drain must never apply into the next test's registry). A
    stopped view restarts its thread on the next enqueue."""
    for view in list(_VIEWS):
        view.stop()


class _AttrCol:
    """One custom search-attribute column: 'id' (interned strings) or
    'f64' (numeric). A kind conflict (one key carrying strings on some
    rows, numbers on others, or any non-scalar value) POISONS the
    column: queries referencing it fall back to the host, where Python
    semantics handle the mix row by row."""

    __slots__ = ("name", "kind", "data", "poisoned")

    def __init__(self, name: str, kind: str, capacity: int) -> None:
        self.name = name
        self.kind = kind
        self.poisoned = False
        if kind == "id":
            self.data = np.full(capacity, -1, dtype=np.int64)
        else:
            self.data = np.full(capacity, np.nan, dtype=np.float64)


class DeviceVisibilityView:
    """The columnar device twin of one VisibilityStore (see module
    docstring). Thread model: writers enqueue under the STORE lock
    (delta order = mutation order); the appender thread and inline
    query flushes drain under this view's own lock; queries hold
    store-lock → view-lock, the same order writers do. `device` is where
    the columns live (None: the card, see device.resolve_device)."""

    def __init__(self, registry=None, device=None) -> None:
        self.metrics = registry if registry is not None \
            else m.DEFAULT_REGISTRY
        self.device = resolve_device(device)
        self.wait_us = int(os.environ.get(VIS_WAIT_ENV, "2000"))
        self.max_batch = max(1, int(os.environ.get(VIS_BATCH_ENV, "512")))
        self.staleness_bound = int(os.environ.get(VIS_STALENESS_ENV, "0"))
        self.attr_budget = int(os.environ.get(VIS_ATTRS_ENV, "16"))
        from ..ops.scan import pow2_bucket
        self.capacity = pow2_bucket(
            int(os.environ.get(VIS_CAP_ENV, "1024")), floor=64)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: deque = deque()
        self._applied_seq = 0
        self._quarantined = False
        #: worst backlog any query observed (the staleness high-water)
        self.staleness_max = 0
        #: worst backlog any query actually SERVED OVER (0 whenever the
        #: query flushed first) — the number the bound really governs
        self.served_staleness_max = 0

        # host mirror (the staging source of truth for the device copy)
        self._rows = 0
        self._key_to_row: Dict[Tuple[str, str, str], int] = {}
        self._row_keys: List[Tuple[str, str, str]] = []
        #: rows freed by deletes, reused by the next inserts — churn
        #: (retention deletes + new starts) must not grow the table
        self._free_rows: List[int] = []
        self._cols: Dict[str, np.ndarray] = {
            name: np.full(self.capacity, -1, dtype=np.int64)
            if _BUILTIN_KINDS[name] == "id"
            else np.zeros(self.capacity, dtype=np.int64)
            for name in _BUILTINS}
        self._valid = np.zeros(self.capacity, dtype=bool)
        self._attr_cols: Dict[str, _AttrCol] = {}
        self._overflow_attrs: set = set()
        #: LFU bookkeeping: per-column query references (retention
        #: value) and per-OVERFLOW-attr fallback-causing references
        #: (admission demand) — when an overflow attr out-demands the
        #: least-used column, they swap (see _maybe_replace_attr)
        self._attr_use: Dict[str, int] = {}
        self._attr_demand: Dict[str, int] = {}
        self._intern: Dict[str, int] = {}
        self._intern_rev: List[str] = []

        # device copy + sync bookkeeping
        self._dev_cols: Dict[str, torch.Tensor] = {}
        self._dev_valid = None
        self._need_restage = True
        self._changed_rows: set = set()
        #: kernel L's feed (ops/scan.py DeltaFeed), made at the first delta
        self._feed = None

        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- write side (called under the STORE lock) --------------------------

    def enqueue_upsert(self, seq: int, rec) -> None:
        """Snapshot the mutated record as a column delta (the record
        object stays mutable in the store — copy now, apply later)."""
        delta = (seq, "up", (rec.domain_id, rec.workflow_id, rec.run_id),
                 rec.workflow_type, int(rec.close_status),
                 int(rec.start_time), int(rec.close_time),
                 dict(rec.search_attrs))
        with self._cv:
            self._pending.append(delta)
            self._cv.notify()
        self._ensure_thread()

    def enqueue_delete(self, seq: int, key: Tuple[str, str, str]) -> None:
        with self._cv:
            self._pending.append((seq, "del", key))
            self._cv.notify()
        self._ensure_thread()

    # -- coalescing appender -----------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        t = threading.Thread(target=self._drain_loop, daemon=True,
                             name="visibility-appender")
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._pending and not self._stop.is_set():
                    self._cv.wait(timeout=0.2)
                if self._stop.is_set():
                    return
            # the coalescing window: let a burst accumulate so one
            # scatter launch serves many mutations (collapses when the
            # batch cap fills first, mirroring serving.py's window)
            deadline = time.monotonic() + self.wait_us / 1e6
            while (time.monotonic() < deadline
                   and len(self._pending) < self.max_batch
                   and not self._stop.is_set()):
                time.sleep(min(0.0005, self.wait_us / 1e6))
            with self._lock:
                self._drain_locked()

    def flush(self) -> int:
        """Drain everything pending right now (the query path's inline
        consistency flush); returns the backlog it drained."""
        with self._lock:
            n = len(self._pending)
            self._drain_locked()
            return n

    def _drain_locked(self) -> int:
        """Apply every pending delta to the host mirror, then sync the
        device copy (one scatter launch, or a full restage after
        growth / a new column / first touch). Held under self._lock."""
        n = 0
        while self._pending:
            delta = self._pending.popleft()
            seq = delta[0]
            if delta[1] == "up":
                self._apply_upsert(delta)
            else:
                self._apply_delete(delta[2])
            self._applied_seq = max(self._applied_seq, seq)
            n += 1
        # sync even with zero deltas: a fresh (or empty) view still
        # needs its first staging pass before a kernel can run
        self._sync_device_locked()
        if n == 0:
            return 0
        scope = self.metrics.scope(m.SCOPE_TPU_VISIBILITY)
        scope.inc(m.M_VIS_DELTAS, n)
        scope.inc(m.M_VIS_DRAINS)
        scope.gauge(m.M_VIS_ROWS, float(self._rows))
        scope.gauge(m.M_VIS_ATTR_COLUMNS, float(len(self._attr_cols)))
        scope.gauge(m.M_VIS_INTERNED, float(len(self._intern_rev)))
        return n

    # -- host mirror maintenance -------------------------------------------

    def _intern_id(self, s: str) -> int:
        i = self._intern.get(s)
        if i is None:
            i = len(self._intern_rev)
            self._intern[s] = i
            self._intern_rev.append(s)
        return i

    def _grow(self, need: int) -> None:
        cap = self.capacity
        while cap < need:
            cap <<= 1
        if cap == self.capacity:
            return
        for name, col in self._cols.items():
            grown = np.full(cap, -1, dtype=np.int64) \
                if _BUILTIN_KINDS[name] == "id" \
                else np.zeros(cap, dtype=np.int64)
            grown[:self.capacity] = col
            self._cols[name] = grown
        for ac in self._attr_cols.values():
            grown = (np.full(cap, -1, dtype=np.int64) if ac.kind == "id"
                     else np.full(cap, np.nan, dtype=np.float64))
            grown[:self.capacity] = ac.data
            ac.data = grown
        valid = np.zeros(cap, dtype=bool)
        valid[:self.capacity] = self._valid
        self._valid = valid
        self.capacity = cap
        self._need_restage = True

    def _attr_col(self, name: str, kind: str) -> Optional[_AttrCol]:
        ac = self._attr_cols.get(name)
        if ac is None:
            if name in self._overflow_attrs:
                return None
            if len(self._attr_cols) >= self.attr_budget:
                self._overflow_attrs.add(name)
                return None
            ac = _AttrCol(name, kind, self.capacity)
            self._attr_cols[name] = ac
            self._need_restage = True
        return ac

    @staticmethod
    def _classify_attr(value):
        """(kind, normalized value) for one search-attr value — the ONE
        typing lattice the delta-apply path and the LFU backfill share
        (None kind = unrepresentable: poisons the column)."""
        if isinstance(value, bytes):
            value = value.decode("utf-8", "replace")
        if isinstance(value, bool):
            # Python bool IS int (True == 1): store numerically so
            # device comparisons reproduce the host lattice
            return "f64", float(value)
        if isinstance(value, (int, float)):
            if isinstance(value, int) and abs(value) > _F64_EXACT:
                return None, 0.0  # unrepresentable exactly in float64
            if isinstance(value, float) and value != value:
                # a NaN VALUE would alias the column's null sentinel
                # (host: nan != 3 matches; device: the presence guard
                # would exclude the row)
                return None, 0.0
            return "f64", float(value)
        if isinstance(value, str):
            return "id", value
        return None, 0.0  # non-scalar: host semantics only

    def _apply_upsert(self, delta) -> None:
        _seq, _kind, key, wf_type, status, start, close, attrs = delta
        row = self._key_to_row.get(key)
        if row is None:
            if self._free_rows:
                row = self._free_rows.pop()
                self._row_keys[row] = key
            else:
                row = self._rows
                self._grow(row + 1)
                self._rows += 1
                self._row_keys.append(key)
            self._key_to_row[key] = row
        self._cols["domain"][row] = self._intern_id(key[0])
        self._cols["workflow_id"][row] = self._intern_id(key[1])
        self._cols["run_id"][row] = self._intern_id(key[2])
        self._cols["workflow_type"][row] = self._intern_id(wf_type)
        self._cols["close_status"][row] = status
        self._cols["start_time"][row] = start
        self._cols["close_time"][row] = close
        self._valid[row] = True
        # the snapshot carries the record's FULL attr dict: reset this
        # row in every attr column, then set the snapshot's keys — a
        # removed key must go back to null, exactly like the host
        for ac in self._attr_cols.values():
            ac.data[row] = -1 if ac.kind == "id" else np.nan
        for name, value in attrs.items():
            kind, norm = self._classify_attr(value)
            ac = self._attr_col(name, kind or "f64")
            if ac is None:
                continue
            if kind is None or (ac.kind != kind and not ac.poisoned):
                ac.poisoned = True
                continue
            if ac.poisoned:
                continue
            ac.data[row] = (self._intern_id(norm) if kind == "id"
                            else norm)
        self._changed_rows.add(row)

    def _apply_delete(self, key) -> None:
        row = self._key_to_row.pop(key, None)
        if row is not None:
            self._valid[row] = False
            self._changed_rows.add(row)
            self._free_rows.append(row)

    # -- device sync (the wirec staging idiom) -----------------------------

    def _col_order(self) -> List[str]:
        """Staging order: builtins bare, attr columns under an "attr:"
        prefix — a search attribute literally named "domain" or
        "start_time" must never alias the builtin column."""
        return list(_BUILTINS) + [f"attr:{n}"
                                  for n in sorted(self._attr_cols)]

    def _host_col(self, name: str) -> np.ndarray:
        if name.startswith("attr:"):
            return self._attr_cols[name[5:]].data
        return self._cols[name]

    def _stage(self, arrays: List[np.ndarray]) -> List[torch.Tensor]:
        """Fresh copies of host arrays on the view's device: page-locked
        and a side stream on the card (native/wirec.stage_h2d). The live
        mirror keeps mutating and must never alias device memory."""
        if self.device.type == "cpu":
            return [torch.from_numpy(np.array(a)) for a in arrays]
        from ..native.wirec import pinned, stage_h2d
        return list(stage_h2d([pinned(a) for a in arrays], self.device))

    def _sync_device_locked(self) -> None:
        if self._need_restage:
            # growth or a new column: restage every column whole
            order = self._col_order()
            staged = self._stage([self._host_col(name) for name in order]
                                 + [self._valid])
            self._dev_cols = dict(zip(order, staged))
            self._dev_valid = staged[-1]
            self._need_restage = False
            self._changed_rows.clear()
            return
        if not self._changed_rows:
            return
        from ..ops.scan import DeltaFeed, apply_layout, pack_delta, pow2_bucket
        rows = np.fromiter(self._changed_rows, dtype=np.int64,
                           count=len(self._changed_rows))
        self._changed_rows.clear()
        bucket = pow2_bucket(len(rows))
        order = self._col_order()
        host = [self._host_col(name) for name in order] + [self._valid]
        if self._feed is None:
            self._feed = DeltaFeed(self.device)
        # the delta packed into the feed's one page-locked block (indices
        # padded out of range, then each column's values), one copy to the
        # card, and kernel L writes the device columns in place
        _, nbytes = apply_layout([c.itemsize for c in host], bucket)
        pack_delta(self._feed.block(nbytes), rows, host, bucket,
                   pad=self.capacity)
        cols = [self._dev_cols[name] for name in order] + [self._dev_valid]
        self._feed.send(cols, bucket)

    # -- query plan binding ------------------------------------------------

    def _binder(self):
        view = self

        class _Binder:
            def leaf(self, field, op, value):
                return view._leaf(field, op, value)

        return _Binder()

    def _leaf(self, field: str, op: str, value):
        from ..ops import scan

        f = field.lower()
        if f == "__domain__":
            return (scan.COL_ID, scan.OP_EQ, "domain",
                    self._intern.get(value, -2), 0.0)
        name = {"workflowid": "workflow_id", "workflowtype":
                "workflow_type", "runid": "run_id"}.get(f)
        if name is not None:
            return self._id_leaf(name, op, value)
        if f in ("closestatus", "starttime", "closetime", "__start__"):
            name = {"closestatus": "close_status", "starttime":
                    "start_time", "closetime": "close_time",
                    "__start__": "start_time"}[f]
            code, p = scan.plan_leaf_int(op, value)
            return (scan.COL_I64, code, name, p, 0.0)
        # custom search attribute (case-sensitive, like the host)
        if field in self._overflow_attrs:
            with self._lock:
                self._attr_demand[field] = \
                    self._attr_demand.get(field, 0) + 1
            raise scan.UnsupportedPredicate(
                f"attr {field!r} past the column budget", reason="column")
        ac = self._attr_cols.get(field)
        if ac is None:
            # never written anywhere: the host sees None → never matches
            return (scan.COL_ID, scan.OP_FALSE, None, 0, 0.0)
        if ac.poisoned:
            raise scan.UnsupportedPredicate(
                f"attr {field!r} mixed-type", reason="column")
        with self._lock:
            self._attr_use[field] = self._attr_use.get(field, 0) + 1
        if ac.kind == "id":
            return self._id_leaf(f"attr:{field}", op, value, attr=ac)
        # numeric column
        if isinstance(value, str):
            code = scan.OP_PRESENT if op == "!=" else scan.OP_FALSE
            return (scan.COL_F64, code, f"attr:{field}", 0, 0.0)
        if isinstance(value, int) and not isinstance(value, bool) \
                and abs(value) > _F64_EXACT:
            raise scan.UnsupportedPredicate(
                f"int {value} not exact in float64", reason="column")
        code = {"=": scan.OP_EQ, "!=": scan.OP_NE, "<": scan.OP_LT,
                "<=": scan.OP_LE, ">": scan.OP_GT,
                ">=": scan.OP_GE}[op]
        return (scan.COL_F64, code, f"attr:{field}", 0, float(value))

    def _id_leaf(self, slot: str, op: str, value, attr=None):
        from ..ops import scan

        if isinstance(value, str):
            if op not in ("=", "!="):
                # interning does not preserve lexicographic order
                raise scan.UnsupportedPredicate(
                    f"string ordering on {slot!r}")
            vid = self._intern.get(value, -2)
            code = scan.OP_EQ if op == "=" else scan.OP_NE
            return (scan.COL_ID, code, slot, vid, 0.0)
        # numeric value vs string column: = is False, != is "present"
        # (present strings always differ), ordering TypeErrors → False
        code = scan.OP_PRESENT if op == "!=" else scan.OP_FALSE
        return (scan.COL_ID, code, slot, 0, 0.0)

    def _slot_array(self, slot: str):
        return self._dev_cols[slot]

    # -- query serving -----------------------------------------------------

    def _scoped(self, node, domain_id: str, token_start=None):
        """The synthetic AST the kernels actually run: the caller's
        query AND the domain partition (AND the page token's start-time
        prefilter) — partition pruning compiled into the same mask."""
        from .visibility_query import And, Cmp

        scoped = Cmp("__domain__", "=", domain_id)
        if token_start is not None:
            scoped = And(scoped, Cmp("__start__", "<=", int(token_start)))
        return And(scoped, node) if node is not None else scoped

    def _prepare_locked(self, store) -> bool:
        """Flush-or-accept-staleness; returns False when the device
        path must not serve (quarantined after a divergence)."""
        scope = self.metrics.scope(m.SCOPE_TPU_VISIBILITY)
        scope.inc(m.M_VIS_QUERIES)
        if self._quarantined:
            return False
        backlog = store._seq - self._applied_seq
        self.staleness_max = max(self.staleness_max, backlog)
        scope.gauge(m.M_VIS_STALENESS, float(backlog))
        self.metrics.observe(m.SCOPE_TPU_VISIBILITY, m.M_VIS_STALENESS,
                             float(backlog), buckets=STALENESS_BUCKETS)
        # the first routed query always drains (the bootstrap backlog is
        # initialization, not staleness); after that the bound governs
        if backlog > self.staleness_bound or self._dev_valid is None:
            with self._lock:
                self._drain_locked()
        else:
            self.served_staleness_max = max(self.served_staleness_max,
                                            backlog)
        self._maybe_replace_attr(store)
        return True

    def _maybe_replace_attr(self, store) -> None:
        """LFU attr-column replacement: when an over-budget attribute
        out-demands the least-queried resident column, they swap — the
        evicted column joins the overflow set (its use count becomes its
        comeback demand), the promoted attr backfills from the store's
        records under the caller-held STORE lock, and queries that used
        to permanently fall back start serving from the device. Counted
        under tpu.visibility/attr-column-replacements."""
        with self._lock:
            if not self._attr_demand:
                return
            cand = max(self._attr_demand, key=self._attr_demand.get)
            demand = self._attr_demand[cand]
            if demand <= 0:
                return
            if len(self._attr_cols) >= self.attr_budget:
                # poisoned columns serve nothing: evict them first
                lfu = min(self._attr_cols,
                          key=lambda n: (not self._attr_cols[n].poisoned,
                                         self._attr_use.get(n, 0)))
                floor = (0 if self._attr_cols[lfu].poisoned
                         else self._attr_use.get(lfu, 0))
                # hysteresis: a swap pays a full backfill + restage +
                # kernel recompile, so the challenger must CLEARLY
                # out-demand the resident (2x), or a budget+1 steady mix
                # would thrash a swap every couple of queries — worse
                # than the host fallback it replaces
                if demand <= 2 * floor:
                    return
                del self._attr_cols[lfu]
                self._overflow_attrs.add(lfu)
                # decay the evicted column's comeback demand: carrying
                # the full historical count over would leave the two
                # counters near-tied forever (perpetual oscillation)
                self._attr_demand[lfu] = self._attr_use.pop(lfu, 0) // 2
            self._overflow_attrs.discard(cand)
            self._attr_use[cand] = self._attr_demand.pop(cand)
            # apply the pending delta backlog FIRST: the backfill reads
            # store-current records, and mixing them into a lagging
            # column snapshot (staleness bound > 0) would stage a row
            # state no store snapshot ever held
            self._drain_locked()
            self._backfill_attr_locked(store, cand)
            self._need_restage = True
            # restage NOW: the very query that triggered the swap will
            # compile against the promoted column, and the serve path
            # only drains when the staleness bound forces it
            self._sync_device_locked()
            self.metrics.inc(m.SCOPE_TPU_VISIBILITY,
                             m.M_VIS_ATTR_REPLACEMENTS)

    def _backfill_attr_locked(self, store, name: str) -> None:
        """Admit `name` as a column populated from the records already
        staged (a late admit must see exactly the values an admit at
        first write would have) — held under self._lock, with the STORE
        lock held by the query entry point above us."""
        col = None
        for key, row in self._key_to_row.items():
            if not self._valid[row]:
                continue
            rec = store._records.get(key)
            if rec is None or name not in rec.search_attrs:
                continue
            kind, norm = self._classify_attr(rec.search_attrs[name])
            if col is None:
                col = _AttrCol(name, kind or "f64", self.capacity)
            if kind is None or (col.kind != kind and not col.poisoned):
                col.poisoned = True
                continue
            if not col.poisoned:
                col.data[row] = (self._intern_id(norm) if kind == "id"
                                 else norm)
        self._attr_cols[name] = (col if col is not None
                                 else _AttrCol(name, "f64", self.capacity))

    def _consistent(self, store) -> bool:
        """True when the device view equals the store right now — the
        precondition for a meaningful parity comparison."""
        return self._applied_seq >= store._seq

    def _compile(self, node, domain_id, token_start=None):
        from ..ops import scan

        plan = scan.compile_plan(
            self._scoped(node, domain_id, token_start), self._binder())
        # the postfix program the kernels run: a plan they cannot hold
        # raises UnsupportedPredicate here, the counted host fallback
        scan.program(plan)
        return plan

    def _args_locked(self, plan):
        cols = tuple(self._slot_array(s) for s in plan.slots)
        return cols, self._dev_valid

    def _fallback(self, store, domain_id, node, hints, reason: str):
        scope = self.metrics.scope(m.SCOPE_TPU_VISIBILITY)
        scope.inc(m.M_VIS_HOST_FALLBACKS)
        scope.inc(reason)
        return store._query_locked(domain_id, self._pred(node), hints)

    def _matched_rows(self, plan) -> Tuple[np.ndarray, int]:
        """Bitmap path: every matching row id (1 bit/row readback).
        Runs under the view lock end to end — with a staleness bound
        > 0 the appender can drain concurrently with a query, and the
        capacity/column snapshot must be consistent with the mask."""
        from ..ops.scan import scan_bitmap

        with self._lock:
            cols, valid = self._args_locked(plan)
            t0 = time.perf_counter()
            bits, count = scan_bitmap(plan, cols, valid)
            bits = bits.cpu().numpy()
            count = int(count)
            self.metrics.record(m.SCOPE_TPU_VISIBILITY,
                                m.M_VIS_SCAN_LATENCY,
                                time.perf_counter() - t0)
            rows = np.nonzero(np.unpackbits(bits,
                                            count=self.capacity))[0]
        return rows, count

    # The three public entry points below are called by VisibilityStore
    # (which owns routing); each takes the STORE lock for the whole
    # operation so flush → scan → materialize → parity is atomic with
    # respect to writers.

    def list(self, store, domain_id: str, query: str):
        from ..ops.scan import UnsupportedPredicate
        from .visibility_query import parse_query

        node, hints = parse_query(query)
        with store._lock:
            if not self._prepare_locked(store):
                return self._fallback(store, domain_id, node, hints,
                                      m.M_VIS_FALLBACK_PREDICATE)
            try:
                plan = self._compile(node, domain_id)
            except UnsupportedPredicate as exc:
                return self._fallback(store, domain_id, node, hints,
                                      _reason_metric(exc))
            rows, _count = self._matched_rows(plan)
            records = self._materialize(store, rows)
            scope = self.metrics.scope(m.SCOPE_TPU_VISIBILITY)
            scope.inc(m.M_VIS_DEVICE_SERVED)
            scope.inc(m.M_VIS_BITMAP)
            if parity_enabled() and self._consistent(store):
                scope.inc(m.M_VIS_PARITY_CHECKS)
                host = self._fallback_silent(store, domain_id, node,
                                             hints)
                if {id(r) for r in records} != {id(r) for r in host}:
                    return self._diverged(host)
            return records

    def count(self, store, domain_id: str, query: str) -> int:
        from ..ops.scan import UnsupportedPredicate
        from .visibility_query import parse_query

        node, hints = parse_query(query)
        with store._lock:
            if not self._prepare_locked(store):
                return len(self._fallback(store, domain_id, node, hints,
                                          m.M_VIS_FALLBACK_PREDICATE))
            try:
                plan = self._compile(node, domain_id)
            except UnsupportedPredicate as exc:
                return len(self._fallback(store, domain_id, node, hints,
                                          _reason_metric(exc)))
            from ..ops.scan import scan_count

            with self._lock:
                cols, valid = self._args_locked(plan)
                t0 = time.perf_counter()
                count = int(scan_count(plan, cols, valid))
            self.metrics.record(m.SCOPE_TPU_VISIBILITY,
                                m.M_VIS_SCAN_LATENCY,
                                time.perf_counter() - t0)
            scope = self.metrics.scope(m.SCOPE_TPU_VISIBILITY)
            scope.inc(m.M_VIS_DEVICE_SERVED)
            if parity_enabled() and self._consistent(store):
                scope.inc(m.M_VIS_PARITY_CHECKS)
                host = len(self._fallback_silent(store, domain_id, node,
                                                 hints))
                if count != host:
                    return self._diverged(host)
            return count

    def page(self, store, domain_id: str, query: str, page_size: int,
             next_page_token=None):
        from ..ops.scan import UnsupportedPredicate, pow2_bucket
        from .visibility_query import parse_query

        node, hints = parse_query(query)
        token = tuple(next_page_token) if next_page_token else None
        with store._lock:
            scope = self.metrics.scope(m.SCOPE_TPU_VISIBILITY)
            if not self._prepare_locked(store):
                scope.inc(m.M_VIS_HOST_FALLBACKS)
                scope.inc(m.M_VIS_FALLBACK_PREDICATE)
                return store._query_page_locked(
                    domain_id, self._pred(node), hints, page_size, token)
            try:
                plan = self._compile(node, domain_id,
                                     token[0] if token else None)
            except UnsupportedPredicate as exc:
                scope.inc(m.M_VIS_HOST_FALLBACKS)
                scope.inc(_reason_metric(exc))
                return store._query_page_locked(
                    domain_id, self._pred(node), hints, page_size, token)
            k = pow2_bucket(page_size + 1, floor=64)
            entries = complete = None
            if k < self.capacity:
                entries, complete = self._topk_page(plan, k, token)
                if (entries is not None and not complete
                        and len(entries) < page_size):
                    # the tie-safe prefix can't fill the page
                    entries = None
            if entries is None:
                # tie straddled the K boundary (or K covers the whole
                # table): the bitmap path has every matching id
                if k < self.capacity:
                    scope.inc(m.M_VIS_TOPK_ESCALATIONS)
                scope.inc(m.M_VIS_BITMAP)
                rows, _ = self._matched_rows(plan)
                entries, complete = self._page_entries(rows, token), True
            else:
                scope.inc(m.M_VIS_TOPK)
            out, tok = self._page_select(store, domain_id, entries,
                                         page_size)
            scope.inc(m.M_VIS_DEVICE_SERVED)
            if parity_enabled() and self._consistent(store):
                scope.inc(m.M_VIS_PARITY_CHECKS)
                h_out, h_tok = store._query_page_locked(
                    domain_id, self._pred(node), hints, page_size, token)
                if ([id(r) for r in out] != [id(r) for r in h_out]
                        or tok != h_tok):
                    return self._diverged((h_out, h_tok))
            return out, tok

    # -- page helpers ------------------------------------------------------

    def _pred(self, node):
        from .visibility_query import eval_node
        return ((lambda rec: eval_node(node, rec)) if node is not None
                else (lambda rec: True))

    def _page_entries(self, rows: np.ndarray, token) -> List[tuple]:
        with self._lock:
            return self._page_entries_locked(rows, token)

    def _page_entries_locked(self, rows: np.ndarray, token) -> List[tuple]:
        """(start_time, workflow_id, run_id, row) per matched row, with
        entries at/after the resume token dropped (host semantics:
        resume strictly below the token in ascending order)."""
        start = self._cols["start_time"]
        out = []
        for row in rows.tolist():
            key = self._row_keys[row]
            entry = (int(start[row]), key[1], key[2])
            if token is not None and entry >= token:
                continue
            out.append(entry + (row,))
        return out

    def _topk_page(self, plan, k: int, token):
        """Device-argsort fast path: the first k matching ids in
        (start DESC, row ASC) order. Returns (entries, complete) or
        (None, False) when a start-time tie straddles the k boundary —
        entries past k could sort between returned ones in the host's
        (workflow_id, run_id) tie order, so the caller escalates."""
        from ..ops.scan import scan_topk

        with self._lock:
            cols, valid = self._args_locked(plan)
            start_dev = self._dev_cols["start_time"]
            t0 = time.perf_counter()
            ids, count = scan_topk(plan, k, cols, valid, start_dev)
            count = int(count)
            rows = ids.cpu().numpy()[:min(count, k)]
            self.metrics.record(m.SCOPE_TPU_VISIBILITY,
                                m.M_VIS_SCAN_LATENCY,
                                time.perf_counter() - t0)
            complete = count <= k
            if not complete:
                # truncation: only entries STRICTLY above the k-th
                # start time are guaranteed tie-complete — an
                # unreturned row tied at that start could sort between
                # returned ones in the host's (workflow_id, run_id)
                # order
                start = self._cols["start_time"]
                st_min = int(start[rows[-1]])
                rows = rows[start[rows] > st_min]
                if len(rows) == 0:
                    return None, False  # every entry ties at st_min
            return self._page_entries_locked(rows, token), complete

    def _page_select(self, store, domain_id: str, entries: List[tuple],
                     page_size: int):
        """Host-order page selection over readback entries: ascending
        (start, wf, run) reversed = the host's DESC iteration, ties
        resolved by the real string order the device cannot see. The
        `more` flag replicates the host exactly: page full AND any
        domain record (matching or not) orders strictly below the last
        returned entry — an O(log n) probe of the host's own ordered
        index, never a scan."""
        import bisect

        ordered = sorted(e[:3] for e in entries)
        ordered.reverse()
        out_entries = ordered[:page_size]
        records = []
        for st, wf, run in out_entries:
            rec = store._records.get((domain_id, wf, run))
            if rec is not None:
                records.append(rec)
        more = False
        if out_entries and len(records) == page_size:
            order = store._ordered.get(domain_id, [])
            more = bisect.bisect_left(order, out_entries[-1]) > 0
        token = out_entries[-1] if records and more else None
        return records, token

    def _materialize(self, store, rows: np.ndarray):
        out = []
        for row in rows.tolist():
            rec = store._records.get(self._row_keys[row])
            if rec is not None:
                out.append(rec)
        return out

    def _fallback_silent(self, store, domain_id, node, hints):
        return store._query_locked(domain_id, self._pred(node), hints)

    def _diverged(self, host_result):
        """Count the divergence, quarantine the view (every later query
        falls back), and serve the HOST answer — wrong data is never
        returned."""
        scope = self.metrics.scope(m.SCOPE_TPU_VISIBILITY)
        scope.inc(m.M_VIS_DIVERGENCE)
        self._quarantined = True
        return host_result

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        reg = self.metrics
        sc = m.SCOPE_TPU_VISIBILITY
        with self._lock:
            pending = len(self._pending)
            poisoned = sorted(a.name for a in self._attr_cols.values()
                              if a.poisoned)
            overflow = sorted(self._overflow_attrs)
            base = {
                "rows": self._rows, "capacity": self.capacity,
                "attr_columns": len(self._attr_cols),
                "attr_overflow": overflow, "attr_poisoned": poisoned,
                "attr_use": dict(self._attr_use),
                "attr_overflow_demand": dict(self._attr_demand),
                "interned_strings": len(self._intern_rev),
                "pending_deltas": pending,
                "applied_seq": self._applied_seq,
                "quarantined": self._quarantined,
                "staleness_max": self.staleness_max,
                "served_staleness_max": self.served_staleness_max,
                "staleness_bound": self.staleness_bound,
                "free_rows": len(self._free_rows),
                "wait_us": self.wait_us, "max_batch": self.max_batch,
            }
        base.update({
            "queries": reg.counter(sc, m.M_VIS_QUERIES),
            "device_served": reg.counter(sc, m.M_VIS_DEVICE_SERVED),
            "host_fallbacks": reg.counter(sc, m.M_VIS_HOST_FALLBACKS),
            "parity_checks": reg.counter(sc, m.M_VIS_PARITY_CHECKS),
            "parity_divergence": reg.counter(sc, m.M_VIS_DIVERGENCE),
            "topk_serves": reg.counter(sc, m.M_VIS_TOPK),
            "bitmap_scans": reg.counter(sc, m.M_VIS_BITMAP),
            "topk_escalations": reg.counter(sc,
                                            m.M_VIS_TOPK_ESCALATIONS),
            "deltas_applied": reg.counter(sc, m.M_VIS_DELTAS),
            "drains": reg.counter(sc, m.M_VIS_DRAINS),
        })
        return base
