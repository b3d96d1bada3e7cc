"""The port's operator CLI (cadence_tpu_torch/cli.py, `python -m
cadence_tpu_torch`) held to the JAX package's.

Five kinds of test:
- the reference's own classes run against the port, every verb on the CPU
  (tests/torch_parity.py ported_reference calls the CLI's `main` with
  `device="cpu"`): tests/test_admin_cli.py's TestCLI, TestOpsVerbs and
  TestProfileVerb, tests/test_schema_version.py's TestSqliteBackend,
  tests/test_snapshot.py's TestAdminSnapshot and tests/test_fuzz.py's
  TestPromotion;
- a drift test: cli.py's text equals the JAX module's once `cadence_tpu`
  reads `cadence_tpu_torch`, except the port's own hunks
  (tests/torch_hunks/cli.diff);
- parity of the slice: one argv sequence through both packages' `main`
  over two WALs gives byte-equal WAL files and equal JSON outputs (in
  full: with each invocation's clock patched to one instant, no field of
  these verbs reads the wall clock, so none is dropped);
- the device rule: without a card a verb that builds the cluster exits
  non-zero with resolve_device's message, and the wire arms and the
  schema verbs need no card;
- `python -m cadence_tpu_torch` in a fresh interpreter loads nothing of
  JAX or of the JAX package.

Every verb runs in-process but the `python -m` one."""
import json
import os
import subprocess
import sys

import pytest

from tests.test_torch_onebox import seeded_ids
from tests.torch_parity import PACKAGES, package, ported_reference, reset_port_globals
from tests.torch_port_drift import assert_port_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "cadence_tpu_torch"


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    reset_port_globals()
    yield
    reset_port_globals()


# -- the reference's own classes against the port ----------------------------

globals().update(ported_reference("test_admin_cli.py",
                                  classes=("TestCLI", "TestOpsVerbs", "TestProfileVerb"),
                                  tag="cli"))
globals().update(ported_reference("test_schema_version.py", classes=("TestSqliteBackend",),
                                  tag="schema"))
globals().update(ported_reference("test_snapshot.py", classes=("TestAdminSnapshot",),
                                  tag="snapshot"))
globals().update(ported_reference("test_fuzz.py", classes=("TestPromotion",), tag="promotion"))


# -- drift: cli.py is the JAX module plus the port's hunks ---------------------


def test_cli_is_the_jax_module():
    assert_port_text("cli")


# -- parity of the slice: the same verbs write the same WAL -------------------

SEED = 20261019
DOMAIN = "cli-parity"

#: the verbs, in order, each a fresh `main` over the WAL (a fresh recovery)
ARGVS = ([["domain", "register", "--name", DOMAIN]]
         + [["workflow", "start", "--domain", DOMAIN, "--workflow-id", f"wf-{i}", "--type", "t",
             "--task-list", "tl"] for i in range(3)]
         + [["workflow", "signal", "--domain", DOMAIN, "--workflow-id", f"wf-{i}", "--name",
             f"sig-{i}"] for i in range(2)]
         + [["workflow", "terminate", "--domain", DOMAIN, "--workflow-id", "wf-2"],
            ["admin", "config-set", "--key", "frontend.rps", "--value", "25"],
            ["admin", "verify"], ["admin", "snapshot", "--sweep"], ["wal", "fsck"],
            ["workflow", "list", "--domain", DOMAIN, "--closed"], ["domain", "list"]])

def _drive(pkg, wal, capsys, monkeypatch):
    """ARGVS through `pkg`'s CLI over `wal`, with seeded ids and each
    invocation's clock at one fixed instant; returns [(rc, JSON output)]."""
    clock = package(pkg, "utils.clock")
    monkeypatch.setattr(clock, "RealTimeSource", clock.ManualTimeSource)
    # the JAX package's backend is up in this process: no probe a verb
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    main = package(pkg, "cli").main
    kw = {"device": "cpu"} if pkg == PORT else {}
    out = []
    with seeded_ids(SEED):
        for argv in ARGVS:
            rc = main(["--wal", wal] + argv, **kw)
            out.append((rc, json.loads(capsys.readouterr().out)))
    return out


def test_the_same_verbs_write_the_same_wal(tmp_path, capsys, monkeypatch):
    got = {}
    for pkg in PACKAGES:
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)  # one relative WAL path: outputs carry it
        got[pkg] = (_drive(pkg, "cluster.jsonl", capsys, monkeypatch),
                    open("cluster.jsonl", "rb").read())
    (jax_out, jax_wal), (port_out, port_wal) = got["cadence_tpu"], got[PORT]
    assert [rc for rc, _ in port_out] == [0] * len(ARGVS)
    assert port_wal == jax_wal
    assert b'"t":"snap"' in port_wal  # the sweep's device rows are in both
    for argv, got_argv, want_argv in zip(ARGVS, port_out, jax_out):
        assert got_argv == want_argv, argv
    verify = port_out[ARGVS.index(["admin", "verify"])][1]
    assert verify["ok"] and verify["verified_on_device"] == 3


# -- the device rule -----------------------------------------------------------


def test_without_a_card_a_cluster_verb_exits_and_the_wire_arms_run(tmp_path, capsys,
                                                                   monkeypatch):
    import torch

    from cadence_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wal = str(tmp_path / "c.jsonl")
    assert cli.main(["--device", "cpu", "--wal", wal, "domain", "register", "--name", "d"]) == 0
    capsys.readouterr()
    for argv, kw in ((["--wal", wal, "domain", "list"], {}),
                     (["--wal", wal, "admin", "verify"], {}),
                     # --device overrides the keyword
                     (["--device", "cuda", "--wal", wal, "domain", "list"], {"device": "cpu"}),
                     (["fuzz", "run", "--seeds", "1"], {})):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv, **kw)
        captured = capsys.readouterr()
        assert exc.value.code == 2 and captured.out == "", argv
        assert "no CUDA device is available" in captured.err, argv
    # the schema verbs and the wire arms build no cluster
    assert cli.main(["--wal", wal, "admin", "schema-version"]) == 0
    assert json.loads(capsys.readouterr().out)["version"] is not None
    assert cli.main(["admin", "top", "--http", "dead=127.0.0.1:1"]) == 1
    assert "error" in json.loads(capsys.readouterr().out)["hosts"]["dead"]
    assert cli.main(["admin", "cluster", "--host", "127.0.0.1:1"]) == 1
    assert "error" in json.loads(capsys.readouterr().out)["127.0.0.1:1"]
    assert cli.main(["--wal", wal, "wal", "fsck"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"]
    # `--device cpu` serves the keyword's absence
    assert cli.main(["--device", "cpu", "--wal", wal, "domain", "list"]) == 0
    assert json.loads(capsys.readouterr().out)[0]["name"] == "d"


def test_python_m_loads_nothing_of_jax(tmp_path):
    """`python -m cadence_tpu_torch` in a fresh interpreter (this one has
    imported JAX): `-X importtime` names every module it imports."""
    wal = str(tmp_path / "m.jsonl")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    runs = []
    for argv in (["domain", "register", "--name", "dm"], ["domain", "list"]):
        runs.append(subprocess.run(
            [sys.executable, "-X", "importtime", "-m", PORT, "--device", "cpu", "--wal", wal]
            + argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120))
    for run in runs:
        assert run.returncode == 0, run.stderr[-2000:]
    assert [d["name"] for d in json.loads(runs[1].stdout)] == ["dm"]
    loaded = {line.rsplit("|", 1)[1].strip() for run in runs
              for line in run.stderr.splitlines() if line.startswith("import time:")}
    assert "cadence_tpu_torch.cli" in loaded and "torch" in loaded
    bad = sorted(m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "cadence_tpu")
                 or m.startswith("jax"))
    assert not bad, bad


def test_profile_records_the_replay_legs(tmp_path, capsys):
    """`admin profile`'s `legs` carry replay_corpus's pack, h2d, kernel and
    readback legs and its bytes up, as the JAX package's replay_corpus
    records them (the port's recorded none before the CLI came)."""
    from cadence_tpu.gen.corpus import generate_corpus
    from cadence_tpu.ops.replay import replay_corpus
    from cadence_tpu.utils.metrics import DEFAULT_REGISTRY
    from cadence_tpu.utils.profiler import ReplayProfiler
    from cadence_tpu_torch import cli

    out_dir = str(tmp_path / "trace")
    assert cli.main(["--wal", str(tmp_path / "p.jsonl"), "admin", "profile", "--out", out_dir,
                     "--workflows", "8", "--events", "30"], device="cpu") == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["platform"] == "cpu"
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(out_dir))
    DEFAULT_REGISTRY.reset()
    replay_corpus(generate_corpus("basic", num_workflows=8, seed=1, target_events=30))
    want = ReplayProfiler().summary()
    assert set(doc["legs"]) == set(want) >= {"pack", "h2d", "kernel", "readback"}
    assert doc["legs"]["h2d_bytes"] == want["h2d_bytes"] > 0
    assert all(doc["legs"][leg]["count"] == 1 for leg in ("pack", "h2d", "kernel", "readback"))
