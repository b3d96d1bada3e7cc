"""The port's Onebox (cadence_tpu_torch/engine/onebox.py: frontend, history
engine, matching and the queues in one process) on the CPU beside the JAX
package's. Each package builds its own box with the same hosts and shards,
the same manual clock and the same run, domain and request ids (uuid4 drawn
from one seeded sequence, reset before each box is built), and both boxes
are driven through the same frontend calls by tests/taskpoller.py's loop.
For every workflow the serialized history bytes, the final mutable state's
payload row, its state and close status, and its visibility record must be
equal; so must each box's ExecutionScanner report.

The cases: tests/test_onebox.py's lifecycles (`:38` on) and
tests/test_reset_rebuild.py's reset shapes (`:38`, `:74`, `:95`, `:130`,
`:136`), each on workflows of its own in one box a package (the JAX side
jit-compiles its rebuild and verify once a box); tests/test_serving.py's
Onebox serving-tier case on the port's box alone; and the device rule:
Onebox() with no device named means the card."""
import contextlib
import random
import uuid

import numpy as np
import pytest
import torch

from tests.taskpoller import TaskPoller
from tests.torch_parity import PACKAGES, package, reset_port_tiers

DOMAIN = "it-domain"
TL = "it-tasklist"
SEED = 20260816
PORT = "cadence_tpu_torch"


@contextlib.contextmanager
def seeded_ids(seed: int):
    """uuid.uuid4 as a seeded sequence while the block runs (both packages
    call uuid.uuid4() through the module, so one patch covers both)."""
    rng = random.Random(seed)
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
    try:
        yield
    finally:
        uuid.uuid4 = real


def new_box(pkg: str, **kw):
    onebox = package(pkg, "engine.onebox")
    if pkg == PORT:
        kw["device"] = "cpu"
    box = onebox.Onebox(**kw)
    box.frontend.register_domain(DOMAIN)
    return box


def deciders(pkg: str):
    return package(pkg, "models.deciders")


# -- tests/test_onebox.py's lifecycles, each on its own workflow ids and task list

def echo(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "echo", "echo", tl)
    TaskPoller(box, DOMAIN, tl, {"echo": deciders(pkg).EchoDecider(tl)}).drain()


def chained(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "chain", "basic", tl)
    TaskPoller(box, DOMAIN, tl,
               {"chain": deciders(pkg).ChainedActivityDecider(tl, chain_length=5)}).drain()


def signals(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "sig", "signal", tl)
    poller = TaskPoller(box, DOMAIN, tl, {"sig": deciders(pkg).SignalDecider(expected_signals=3)})
    poller.drain()
    for i in range(3):
        box.frontend.signal_workflow_execution(DOMAIN, "sig", f"s{i}")
        poller.drain()


def timer(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "timer", "timer", tl)
    poller = TaskPoller(box, DOMAIN, tl, {"timer": deciders(pkg).TimerDecider(fire_seconds=5)})
    poller.drain()
    box.advance_time(6)
    poller.drain()


def concurrent(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "conc", "conc", tl)
    TaskPoller(box, DOMAIN, tl,
               {"conc": deciders(pkg).ConcurrentActivityDecider(tl, width=4)}).drain()


def child(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "parent", "parent", tl)
    TaskPoller(box, DOMAIN, tl, {"parent": deciders(pkg).ChildWorkflowDecider("parent-child"),
                                 "parent-child": deciders(pkg).EchoDecider(tl)}).drain()


def cancellation(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "cancel", "cancel", tl)
    poller = TaskPoller(box, DOMAIN, tl, {"cancel": deciders(pkg).CancellationDecider(tl)})
    box.pump_once()
    poller.poll_and_decide_once()
    box.frontend.request_cancel_workflow_execution(DOMAIN, "cancel")
    poller.drain()


def activity_timeout(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "tmo", "echo", tl)
    poller = TaskPoller(box, DOMAIN, tl, {"tmo": deciders(pkg).EchoDecider(tl)})
    box.pump_once()
    poller.poll_and_decide_once()
    box.pump_once()
    box.advance_time(130)
    box.pump_once()


def terminate(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "term", "echo", tl)
    box.frontend.terminate_workflow_execution(DOMAIN, "term", reason="ops")


def workflow_timeout(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "wtmo", "echo", tl, execution_timeout=50)
    box.advance_time(60)
    box.pump_once()


def continue_as_new(box, pkg, tl):
    enums = package(pkg, "core.enums")
    Decision = package(pkg, "engine.history_engine").Decision

    class CanOnceDecider:
        def __init__(self):
            self.generation = 0

        def decide(self, history):
            self.generation += 1
            if self.generation == 1:
                return [Decision(enums.DecisionType.ContinueAsNewWorkflowExecution,
                                 dict(task_list=tl))]
            return [Decision(enums.DecisionType.CompleteWorkflowExecution)]

    box.frontend.start_workflow_execution(DOMAIN, "can", "can", tl)
    TaskPoller(box, DOMAIN, tl, {"can": CanOnceDecider()}).drain()


def fleet(box, pkg, tl):
    """TestNorthStarLoop's mixed fleet."""
    dc = deciders(pkg)
    ds = {}
    for i in range(4):
        box.frontend.start_workflow_execution(DOMAIN, f"fleet-echo-{i}", "echo", tl)
        ds[f"fleet-echo-{i}"] = dc.EchoDecider(tl)
    for i in range(3):
        box.frontend.start_workflow_execution(DOMAIN, f"fleet-sig-{i}", "signal", tl)
        ds[f"fleet-sig-{i}"] = dc.SignalDecider(expected_signals=2)
    box.frontend.start_workflow_execution(DOMAIN, "fleet-timer", "timer", tl)
    ds["fleet-timer"] = dc.TimerDecider(fire_seconds=3)
    poller = TaskPoller(box, DOMAIN, tl, ds)
    poller.drain()
    for i in range(2):
        for j in range(3):
            box.frontend.signal_workflow_execution(DOMAIN, f"fleet-sig-{j}", f"s{i}")
        poller.drain()
    box.advance_time(5)
    poller.drain()


#: the three that leave tasks unpolled (so no later drain settles) run last
LIFECYCLES = (echo, chained, signals, timer, concurrent, child, cancellation, continue_as_new,
              fleet, activity_timeout, terminate, workflow_timeout)
#: each case's workflow ids (a prefix covers its numbered or child ids)
LIFECYCLE_IDS = {"echo": ("echo",), "chained": ("chain",), "signals": ("sig",),
                 "timer": ("timer",), "concurrent": ("conc",), "child": ("parent",),
                 "cancellation": ("cancel",), "activity_timeout": ("tmo",), "terminate": ("term",),
                 "workflow_timeout": ("wtmo",), "continue_as_new": ("can",),
                 "fleet": ("fleet-echo", "fleet-sig", "fleet-timer")}
#: the close status tests/test_onebox.py asserts, where it asserts one
CLOSE = {"echo": "Completed", "chain": "Completed", "sig": "Completed", "timer": "Completed",
         "conc": "Completed", "parent": "Completed", "parent-child": "Completed",
         "cancel": "Canceled", "term": "Terminated", "wtmo": "TimedOut", "can": "Completed"}


# -- tests/test_reset_rebuild.py's reset shapes ------------------------------

def _signal_workflow(box, pkg, tl, wf, expected):
    box.frontend.start_workflow_execution(DOMAIN, wf, "signal", tl)
    poller = TaskPoller(box, DOMAIN, tl,
                        {wf: deciders(pkg).SignalDecider(expected_signals=expected)})
    poller.drain()
    domain_id = box.stores.domain.by_name(DOMAIN).domain_id
    return poller, box.stores.execution.get_current_run_id(domain_id, wf)


def reset_reapplies_signals(box, pkg, tl):
    poller, run_id = _signal_workflow(box, pkg, tl, "reset-1", 3)
    box.frontend.signal_workflow_execution(DOMAIN, "reset-1", "s-1")
    box.frontend.signal_workflow_execution(DOMAIN, "reset-1", "s-2")
    poller.drain()
    box.frontend.reset_workflow_execution(DOMAIN, "reset-1", decision_finish_event_id=4,
                                          run_id=run_id, reason="test")
    poller.drain()  # the new run's decision, so the next case's drain can settle


def reset_continues_to_completion(box, pkg, tl):
    poller, run_id = _signal_workflow(box, pkg, tl, "reset-2", 2)
    box.frontend.signal_workflow_execution(DOMAIN, "reset-2", "s-1")
    poller.drain()
    box.frontend.reset_workflow_execution(DOMAIN, "reset-2", decision_finish_event_id=4,
                                          run_id=run_id)
    poller = TaskPoller(box, DOMAIN, tl,
                        {"reset-2": deciders(pkg).SignalDecider(expected_signals=2)})
    poller.drain()
    box.frontend.signal_workflow_execution(DOMAIN, "reset-2", "s-2")
    poller.drain()


def reset_redispatches_activity(box, pkg, tl):
    enums = package(pkg, "core.enums")
    box.frontend.start_workflow_execution(DOMAIN, "reset-act", "echo", tl)
    poller = TaskPoller(box, DOMAIN, tl, {"reset-act": deciders(pkg).EchoDecider(tl)})
    box.pump_once()
    while poller.poll_and_decide_once():
        box.pump_once()
    domain_id = box.stores.domain.by_name(DOMAIN).domain_id
    run_id = box.stores.execution.get_current_run_id(domain_id, "reset-act")
    box.frontend.signal_workflow_execution(DOMAIN, "reset-act", "nudge")
    box.pump_once()
    while poller.poll_and_decide_once():
        box.pump_once()
    events = box.stores.history.read_events(domain_id, "reset-act", run_id)
    finish = max(e.id for e in events if e.event_type == enums.EventType.DecisionTaskCompleted)
    box.frontend.reset_workflow_execution(DOMAIN, "reset-act", decision_finish_event_id=finish,
                                          run_id=run_id)
    TaskPoller(box, DOMAIN, tl, {"reset-act": deciders(pkg).EchoDecider(tl)}).drain()


def reset_rejects_non_boundary(box, pkg, tl):
    _poller, run_id = _signal_workflow(box, pkg, tl, "reset-3", 3)
    with pytest.raises(package(pkg, "engine.history_engine").InvalidRequestError):
        box.frontend.reset_workflow_execution(DOMAIN, "reset-3", decision_finish_event_id=3,
                                              run_id=run_id)


def reset_closed_workflow(box, pkg, tl):
    box.frontend.start_workflow_execution(DOMAIN, "reset-4", "t", tl)
    TaskPoller(box, DOMAIN, tl, {"reset-4": deciders(pkg).CompleteDecider()}).drain()
    domain_id = box.stores.domain.by_name(DOMAIN).domain_id
    run_id = box.stores.execution.get_current_run_id(domain_id, "reset-4")
    box.frontend.reset_workflow_execution(DOMAIN, "reset-4", decision_finish_event_id=4,
                                          run_id=run_id)
    TaskPoller(box, DOMAIN, tl, {"reset-4": deciders(pkg).CompleteDecider()}).drain()


RESETS = (reset_reapplies_signals, reset_continues_to_completion, reset_redispatches_activity,
          reset_rejects_non_boundary, reset_closed_workflow)
RESET_IDS = {"reset_reapplies_signals": "reset-1", "reset_continues_to_completion": "reset-2",
             "reset_redispatches_activity": "reset-act", "reset_rejects_non_boundary": "reset-3",
             "reset_closed_workflow": "reset-4"}


# -- what is compared ---------------------------------------------------------

def fingerprint(box, pkg):
    """{workflow id: sorted [(run id, history bytes, payload row bytes, state,
    close status)]} and {workflow id: sorted visibility records}."""
    codec = package(pkg, "core.codec")
    checksum = package(pkg, "core.checksum")
    runs, vis = {}, {}
    for key in box.stores.execution.list_executions():
        ms = box.stores.execution.get_workflow(*key)
        info = ms.execution_info
        blob = codec.serialize_history(box.stores.history.as_history_batches(*key))
        row = checksum.payload_row(ms, box.config.payload_layout())
        runs.setdefault(key[1], []).append((key[2], blob, np.asarray(row).tobytes(),
                                            int(info.state), int(info.close_status)))
    domain_id = box.stores.domain.by_name(DOMAIN).domain_id
    for r in (box.stores.visibility.list_open(domain_id)
              + box.stores.visibility.list_closed(domain_id)):
        vis.setdefault(r.workflow_id, []).append(
            (r.run_id, r.workflow_type, r.start_time, r.close_time, r.close_status,
             sorted(r.search_attrs.items())))
    return ({w: sorted(v) for w, v in runs.items()}, {w: sorted(v) for w, v in vis.items()})


def scan_report(box):
    r = box.scanner.run_once()
    v = r.verify
    return {"ok": r.ok, "executions": r.executions, "orphan_pointers": r.orphan_pointers,
            "missing_history": r.missing_history, "open_without_pointer": r.open_without_pointer,
            "invalid_pending": r.invalid_pending, "state_divergent": r.state_divergent,
            "total": v.total, "verified_on_device": v.verified_on_device,
            "divergent": v.divergent, "fallback": v.fallback}


@pytest.fixture(scope="module")
def runs():
    """Per package: the lifecycle box's and the reset box's fingerprints,
    the lifecycle box's scanner report and the reset box's rebuilder
    counts. Built once a module (the JAX side compiles its kernels here)."""
    out = {}
    try:
        for pkg in PACKAGES:
            with seeded_ids(SEED):
                box = new_box(pkg, num_hosts=2, num_shards=8)
                for case in LIFECYCLES:
                    case(box, pkg, f"tl-{case.__name__}")
            lifecycle = fingerprint(box, pkg)
            scan = scan_report(box)
            with seeded_ids(SEED + 1):
                rbox = new_box(pkg, num_hosts=1, num_shards=4)
                for case in RESETS:
                    case(rbox, pkg, f"tl-{case.__name__}")
            out[pkg] = {"lifecycle": lifecycle, "scan": scan, "reset": fingerprint(rbox, pkg),
                        "rebuilt": (rbox.rebuilder.stats.device,
                                    rbox.rebuilder.stats.oracle_fallback),
                        "status": {w: package(pkg, "core.enums").CloseStatus(s[0][4]).name
                                   for w, s in lifecycle[0].items()}}
    finally:
        reset_port_tiers()
    return out


def _workflows(fp, prefix):
    return {w: v for w, v in fp.items() if w == prefix or w.startswith(prefix + "-")}


@pytest.mark.parametrize("case", LIFECYCLES, ids=lambda f: f.__name__)
def test_lifecycle_equals_jax(runs, case):
    jax_runs, jax_vis = runs["cadence_tpu"]["lifecycle"]
    port_runs, port_vis = runs[PORT]["lifecycle"]
    for wid in LIFECYCLE_IDS[case.__name__]:
        want = _workflows(jax_runs, wid)
        assert want, wid
        assert _workflows(port_runs, wid) == want
        assert _workflows(port_vis, wid) == _workflows(jax_vis, wid)


@pytest.mark.parametrize("wid", sorted(CLOSE))
def test_close_status_as_the_reference_asserts(runs, wid):
    assert runs[PORT]["status"][wid] == CLOSE[wid]


@pytest.mark.parametrize("case", RESETS, ids=lambda f: f.__name__)
def test_reset_equals_jax(runs, case):
    wid = RESET_IDS[case.__name__]
    for part in (0, 1):
        want = _workflows(runs["cadence_tpu"]["reset"][part], wid)
        assert want
        assert _workflows(runs[PORT]["reset"][part], wid) == want


def test_resets_rebuild_on_the_device(runs):
    """Four of the five shapes reset (one is rejected): each forked prefix
    rebuilt by the box's DeviceRebuilder, as the JAX package counts it."""
    device, oracle = runs[PORT]["rebuilt"]
    assert (device, oracle) == runs["cadence_tpu"]["rebuilt"]
    assert device >= 4 and oracle == 0


def test_scanner_reports_equal(runs):
    port = runs[PORT]["scan"]
    assert port == runs["cadence_tpu"]["scan"]
    assert port["ok"] and port["verified_on_device"] == port["executions"]


def test_committed_transactions_flow_through_tier():
    """tests/test_serving.py's TestOneboxServingTier case on the port's box
    on the CPU."""
    box = package(PORT, "engine.onebox").Onebox(num_hosts=1, num_shards=2, device="cpu")
    sched = box.enable_serving()
    try:
        fe = box.frontend
        fe.register_domain("svd")
        fe.start_workflow_execution("svd", "wf-a", "t", "tl")
        assert sched.drain(timeout=300.0)
        for i in range(3):
            fe.signal_workflow_execution("svd", "wf-a", f"s{i}", request_id=f"r{i}")
        assert sched.drain(timeout=300.0)
        stats = sched.stats()
        assert stats["transactions"] >= 4
        assert stats["parity_divergence"] == 0
        assert stats["cold_admits"] >= 1
        res = box.route("wf-a").last_serving_ticket.result(timeout=60)
        assert res.ok and res.parity_ok
        r = box.tpu.verify_all()
        assert r.ok
        assert len(r.resident) >= 1
    finally:
        sched.stop()
        reset_port_tiers()


def test_every_tier_runs_on_the_named_device():
    """The box resolves its device once and hands it to the verify engine,
    the rebuilder, the visibility store and every engine it creates; an
    engine left without the box's rebuilder builds one on that device."""
    box = new_box(PORT, num_hosts=1, num_shards=2)
    try:
        assert box.device == torch.device("cpu")
        assert box.tpu.device == box.device and box.rebuilder.device == box.device
        assert box.stores.visibility.device == box.device
        box.frontend.start_workflow_execution(DOMAIN, "dev", "t", TL)
        engine = box.route("dev")
        assert engine.device == box.device
        TaskPoller(box, DOMAIN, TL, {"dev": deciders(PORT).CompleteDecider()}).drain()
        del engine.rebuilder
        domain_id = box.stores.domain.by_name(DOMAIN).domain_id
        run_id = box.stores.execution.get_current_run_id(domain_id, "dev")
        box.frontend.reset_workflow_execution(DOMAIN, "dev", decision_finish_event_id=4,
                                              run_id=run_id)
        assert engine.rebuilder is not box.rebuilder
        assert engine.rebuilder.device == box.device
        assert engine.rebuilder.stats.device == 1
    finally:
        reset_port_tiers()


def test_no_device_means_the_card(monkeypatch):
    """Onebox() with no device named runs on the card; without one it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        package(PORT, "engine.onebox").Onebox()


class _RecordingTier:
    """A serving tier that records what the history engine hands it."""

    def __init__(self, layout):
        self.layout = layout
        self.handed = []

    def submit(self, key, row, branch, tail_crc, batch=None):
        self.handed.append((key[1], batch.events[0].id, len(batch.events)))


def test_a_state_past_the_layout_is_not_handed_to_the_tier():
    """Reference behaviour reproduced (ROADMAP §C): a transaction whose
    state holds more pending activities than the payload layout (20 against
    16) has no payload row, so the engine's hand-off skips it, and both
    packages hand the tier the same batches with the same gap (the
    decision that schedules the 20, and each start until 16 are left)."""
    handed = {}
    for pkg in PACKAGES:
        with seeded_ids(SEED + 2):
            box = new_box(pkg, num_hosts=1, num_shards=2)
            box.serving = _RecordingTier(box.config.payload_layout())
            box.frontend.start_workflow_execution(DOMAIN, "wide", "conc", TL)
            TaskPoller(box, DOMAIN, TL,
                       {"wide": deciders(pkg).ConcurrentActivityDecider(TL, width=20)}).drain()
        handed[pkg] = box.serving.handed
    assert handed[PORT] == handed["cadence_tpu"]
    firsts = [first for _, first, _ in handed[PORT]]
    domain_id = box.stores.domain.by_name(DOMAIN).domain_id
    run_id = box.stores.execution.get_current_run_id(domain_id, "wide")
    batches = box.stores.history.as_history_batches(domain_id, "wide", run_id)
    skipped = [b.events[0].id for b in batches if b.events[0].id not in firsts]
    assert skipped and skipped[0] == 4  # the decision completion that schedules the 20
