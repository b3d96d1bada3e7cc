"""The port's fuzz grammar (cadence_tpu_torch/gen/fuzz.py, gen/shrink.py and
the `fuzz` routes of gen/corpus.py) on the CPU beside the JAX package's:
the same coordinates give byte-identical histories (history_digest), the
same coverage, specs, shrink reports and parity_run document."""
import dataclasses
import json
import os

import numpy as np
import pytest

from cadence_tpu.gen import corpus as j_corpus
from cadence_tpu.gen import fuzz as j_fuzz
from cadence_tpu.gen import shrink as j_shrink
from cadence_tpu_torch.gen import corpus as t_corpus
from cadence_tpu_torch.gen import fuzz as t_fuzz
from cadence_tpu_torch.gen import shrink as t_shrink
from tests.torch_parity import reset_port_tiers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated():
    yield
    reset_port_tiers()


def test_profiles_and_evidence_as_jax():
    assert t_fuzz.PROFILES == j_fuzz.PROFILES
    assert ({d.name: [e.name for e in ev] for d, ev in t_fuzz.DECISION_EVIDENCE.items()}
            == {d.name: [e.name for e in ev] for d, ev in j_fuzz.DECISION_EVIDENCE.items()})
    for profile in t_fuzz.PROFILES:
        assert t_fuzz._weights(profile) == j_fuzz._weights(profile)


@pytest.mark.parametrize("profile", j_fuzz.PROFILES)
def test_history_digest_equals_jax(profile):
    """Every profile over a few seeds and indices: the same bytes, witnessed
    by each package's digest of its own histories and of the other's."""
    for seed in (0, 1, 7):
        for i in range(3):
            th = t_fuzz.generate_fuzz_history(seed, i, 80, profile)
            jh = j_fuzz.generate_fuzz_history(seed, i, 80, profile)
            assert t_fuzz.history_digest(th) == j_fuzz.history_digest(jh)
            assert t_fuzz.history_digest(jh) == j_fuzz.history_digest(th)


@pytest.mark.parametrize("suite", ["fuzz"] + [f"fuzz:{p}" for p in j_fuzz.PROFILES])
def test_generate_corpus_routes_fuzz_as_jax(suite):
    """`fuzz` and `fuzz:<profile>` reach the grammar through the corpus
    addressing, as in the JAX package; the coverage counters agree."""
    th = t_corpus.generate_corpus(suite, 4, seed=3, target_events=60)
    jh = j_corpus.generate_corpus(suite, 4, seed=3, target_events=60)
    assert [t_fuzz.history_digest(h) for h in th] == [j_fuzz.history_digest(h) for h in jh]
    profile = suite.partition(":")[2] or "mixed"
    assert (t_fuzz.history_digest(t_corpus.generate_history(suite, 3, 1, 60))
            == t_fuzz.history_digest(t_fuzz.generate_fuzz_history(3, 1, 60, profile)))
    assert t_fuzz.coverage(th) == j_fuzz.coverage(jh)


def test_unknown_profile_and_suite_raise():
    with pytest.raises(ValueError):
        t_fuzz.generate_fuzz_history(0, 0, 60, "no-such-profile")
    with pytest.raises(ValueError):
        t_corpus.generate_history("fuzz:no-such-profile", 0)
    with pytest.raises(KeyError):
        t_corpus.generate_history("no-such-suite", 0)


def test_coverage_of_the_parity_corpus_as_jax():
    """The parity run's corpus shape (one profile a workflow, rotating by
    seed): every decision type covered, counts equal."""
    th = [t_fuzz.generate_fuzz_history(s, i, 100, t_fuzz.PROFILES[(s + i) % 7])
          for s in range(6) for i in range(4)]
    jh = [j_fuzz.generate_fuzz_history(s, i, 100, j_fuzz.PROFILES[(s + i) % 7])
          for s in range(6) for i in range(4)]
    cov = t_fuzz.coverage(th)
    assert cov == j_fuzz.coverage(jh)
    assert set(cov["decisions"]) == {d.name for d in t_fuzz.DECISION_EVIDENCE}


@pytest.mark.parametrize("profile", ["chain", "cron_retry"])
def test_oracle_rows_and_store_shapes_as_jax(profile):
    """oracle_final_row follows the continue-as-new chain; the store-shaped
    copies drop new_run_events; both as in the JAX package."""
    th = t_fuzz.generate_fuzz_corpus(6, seed=2, target_events=60, profile=profile)
    jh = j_fuzz.generate_fuzz_corpus(6, seed=2, target_events=60, profile=profile)
    for t, j in zip(th, jh):
        assert np.array_equal(t_fuzz.oracle_final_row(t), j_fuzz.oracle_final_row(j))
    ts, js = t_fuzz.strip_new_run_events(th), j_fuzz.strip_new_run_events(jh)
    assert not any(b.new_run_events for h in ts for b in h)
    assert [t_fuzz.history_digest(h) for h in ts] == [j_fuzz.history_digest(h) for h in js]


def test_seed_stores_and_ndc_fork_as_jax():
    """seed_stores persists the store shape with the oracle's live state;
    fork_ndc_branch makes a two-branch tree whose winner is current."""
    from cadence_tpu.engine.persistence import Stores as JStores
    from cadence_tpu_torch.engine.persistence import Stores as TStores

    th = t_fuzz.generate_fuzz_corpus(3, seed=4, target_events=60, profile="mixed")
    jh = j_fuzz.generate_fuzz_corpus(3, seed=4, target_events=60, profile="mixed")
    ts, js = TStores(), JStores()
    tkeys, jkeys = t_fuzz.seed_stores(ts, th), j_fuzz.seed_stores(js, jh)
    assert tkeys == jkeys
    for i, key in enumerate(tkeys):
        assert t_fuzz.fork_ndc_branch(ts, key, seed=i) == j_fuzz.fork_ndc_branch(js, key, seed=i)
        assert ts.history.get_current_branch(*key) == js.history.get_current_branch(*key)
        assert ([(e.id, int(e.event_type), e.version) for e in ts.history.read_events(*key, branch=1)]
                == [(e.id, int(e.event_type), e.version)
                    for e in js.history.read_events(*key, branch=1)])


def test_shrink_report_equals_jax():
    """The injected-divergence harness: the port's shrinker (its device row
    from the CPU) reduces to the same minimal slice as the JAX package's."""
    poison = t_shrink.inject_poison_signal(5, 0, target_events=60)
    assert poison == j_shrink.inject_poison_signal(5, 0, target_events=60)
    got = t_shrink.shrink_history(5, 0, t_shrink.poisoned_parity_predicate(poison, device="cpu"),
                                  target_events=60)
    want = j_shrink.shrink_history(5, 0, j_shrink.poisoned_parity_predicate(poison),
                                   target_events=60)
    assert got.summary() == want.summary()
    assert t_fuzz.history_digest(got.reproduce()) == got.digest
    assert got.shrunk_batches <= 3


def test_shrink_batches_is_one_minimal_and_refuses_clean_input():
    batches = t_fuzz.generate_fuzz_history(3, 0, 60, "signal_storm")
    marked = {1, 7}

    def failing(sub):
        return marked <= {batches.index(b) for b in sub}

    kept, calls = t_shrink.shrink_batches(batches, failing)
    assert sorted(kept) == sorted(marked) and calls > 0
    assert (kept, calls) == j_shrink.shrink_batches(batches, failing)
    with pytest.raises(ValueError):
        t_shrink.shrink_batches(batches, lambda sub: False)
    # a clean history: the real parity predicate finds nothing to chase
    assert not t_shrink.parity_predicate(device="cpu")(batches)


def test_load_specs_as_jax_and_save_round_trip(tmp_path):
    """The promoted specs in fuzz_specs/ read the same in both packages and
    still reproduce their digests; save_spec and make_spec round-trip."""
    t_specs, j_specs = t_fuzz.load_specs(ROOT), j_fuzz.load_specs(ROOT)
    assert [dataclasses.asdict(s) for s in t_specs] == [dataclasses.asdict(s) for s in j_specs]
    assert len(t_specs) == 2
    for spec in t_specs:
        first = t_fuzz.generate_fuzz_history(spec.seed, 0, spec.target_events, spec.profile,
                                             chain=spec.chain)
        assert t_fuzz.history_digest(first) == spec.digest
    spec = t_fuzz.make_spec("tiny", seed=9, workflows=3, target_events=50,
                            profile="timer_churn", note="a round trip")
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        j_fuzz.make_spec("tiny", seed=9, workflows=3, target_events=50, profile="timer_churn",
                         note="a round trip"))
    path = t_fuzz.save_spec(spec, root=str(tmp_path))
    with open(path, encoding="utf-8") as fh:
        assert json.load(fh)["schema"] == t_fuzz.SPEC_SCHEMA
    assert t_fuzz.load_specs(str(tmp_path)) == [spec]
    assert j_fuzz.load_specs(str(tmp_path))[0] == j_fuzz.CorpusSpec(**dataclasses.asdict(spec))
    assert len(spec.generate()) == 3
    drifted = dataclasses.replace(spec, digest="0" * 64)
    with pytest.raises(ValueError):
        drifted.generate()


def test_write_fuzz_trajectory_takes_the_next_slot(tmp_path):
    doc = {"seeds": 1, "ok": True}
    first = t_fuzz.write_fuzz_trajectory(doc, root=str(tmp_path))
    second = t_fuzz.write_fuzz_trajectory(doc, root=str(tmp_path))
    assert os.path.basename(first) == "FUZZ_r01.json"
    assert os.path.basename(second) == "FUZZ_r02.json"
    with open(second, encoding="utf-8") as fh:
        assert json.load(fh) == {"schema": t_fuzz.TRAJECTORY_SCHEMA, **doc}


def test_parity_run_document_equals_jax():
    """The port's parity_run on the CPU (dense and wirec replay, verify_all,
    the NDC tree replay) returns the JAX package's document key for key."""
    kw = dict(seeds=3, workflows_per_seed=2, target_events=60, ndc_forks=1)
    got = t_fuzz.parity_run(device="cpu", **kw)
    want = j_fuzz.parity_run(**kw)
    assert got == want
    assert got["dense_divergent"] == got["wirec_divergent"] == got["verify_divergent"] == 0
    assert got["ndc_forked"] == 1 and got["ndc_divergent"] == 0


def test_parity_run_with_no_device_named_means_the_card(monkeypatch):
    """No fallback: without a card, parity_run with no device named raises
    instead of carrying on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_fuzz.parity_run(seeds=1, workflows_per_seed=1, target_events=40, ndc_forks=0)
