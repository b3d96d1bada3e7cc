"""Shared helpers of the tests/test_torch_*.py files: the same numpy inputs
go through the JAX package and through cadence_tpu_torch on the CPU, and
the results are compared exactly (every value is an integer, so the
tolerance is 0)."""
import numpy as np

from cadence_tpu_torch.ops.state import leaves

#: every replay in these tests pads to this many events, so the JAX
#: package compiles each (W, E) shape once
E_PAD = 130


def jax_state_to_numpy(js) -> dict:
    """Flatten a JAX ReplayState (NamedTuple of tables) to
    {dotted field path: numpy array}, the form ops/convert.py takes."""
    out = {}

    def walk(prefix, x):
        if hasattr(x, "_fields"):
            for f in x._fields:
                walk(f"{prefix}.{f}" if prefix else f, getattr(x, f))
        else:
            out[prefix] = np.asarray(x)

    walk("", js)
    return out


def assert_states_equal(port_state, jax_state) -> None:
    """Every one of the 66 state tensors equal, in value and dtype."""
    want = jax_state_to_numpy(jax_state)
    got = {name: t.cpu().numpy() for name, t in leaves(port_state)}
    assert sorted(got) == sorted(want)
    assert len(got) == 66
    bad = [name for name in want
           if got[name].dtype != want[name].dtype
           or got[name].shape != want[name].shape
           or not np.array_equal(got[name], want[name])]
    assert not bad, f"fields differ from the JAX package: {bad}"


def pad_events(ev: np.ndarray, num_events: int = E_PAD, num_workflows: int = 0) -> np.ndarray:
    """Pad a [W, E, 18] corpus with no-op rows (id 0, type -1) to
    [max(W, num_workflows), num_events, 18]."""
    W, E, L = ev.shape
    assert E <= num_events, (E, num_events)
    out = np.zeros((max(W, num_workflows), num_events, L), dtype=ev.dtype)
    out[:, :, 1] = -1
    out[:W, :E] = ev
    return out


#: the corpora the wirec tests pack: the five suites, the overflow suite,
#: the lane-level random corpus (no-op rows between real ones), the
#: adversarial values of tests/test_wirec.py and all-padding workflows
WIREC_KINDS = ("basic", "echo_signal", "timer_retry", "concurrent_child", "ndc", "overflow",
               "lanes", "adversarial", "empty")


def wirec_corpus(kind: str, num_workflows: int = 16) -> np.ndarray:
    """[W, E, 18] int64 lanes of one WIREC_KINDS corpus, made from a seed."""
    from cadence_tpu.gen.corpus import generate_corpus
    from cadence_tpu.ops.encode import NUM_LANES, encode_corpus
    from cadence_tpu_torch.gen.lanes import random_lanes

    if kind == "lanes":
        return random_lanes(num_workflows, 64, 23)
    if kind == "adversarial":  # wide random values, negatives, 64-bit magnitudes
        rng = np.random.default_rng(3)
        W, E = 8, 32
        ev = np.zeros((W, E, NUM_LANES), dtype=np.int64)
        n = rng.integers(5, E, size=W)
        for w in range(W):
            ev[w, :n[w], 0] = np.arange(1, n[w] + 1)
            ev[w, :n[w], 1] = rng.integers(0, 40, n[w])
            ev[w, :n[w], 3] = rng.integers(-2**62, 2**62, n[w])
            ev[w, :n[w], 7] = rng.integers(-2**31, 2**31, n[w])
            ev[w, n[w]:, 1] = -1
        return ev
    if kind == "empty":  # all-padding rows beside one short workflow
        ev = np.zeros((4, 16, NUM_LANES), dtype=np.int64)
        ev[:, :, 1] = -1
        ev[0, :3, 0] = [1, 2, 3]
        ev[0, :3, 1] = [0, 2, 3]
        return ev
    return encode_corpus(generate_corpus(kind, num_workflows, seed=9, target_events=80))


def assert_corpora_equal(got, want) -> None:
    """Two WirecCorpus values hold the same profile and the same bytes."""
    assert tuple(got.profile) == tuple(want.profile)
    for name in ("slab", "bases", "n_events"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), name


#: the two packages the engine tests build stores for
PACKAGES = ("cadence_tpu", "cadence_tpu_torch")


def package(pkg: str, module: str):
    """`pkg.module` (for example package("cadence_tpu_torch", "gen.corpus"))."""
    import importlib

    return importlib.import_module(f"{pkg}.{module}")


def stores_with(hists, pkg: str):
    """(Stores of package `pkg`, keys): each history appended to the history
    store and, as its live state, the same package's oracle MutableState
    of it upserted into the execution store."""
    stores = package(pkg, "engine.persistence").Stores()
    builder = package(pkg, "oracle.state_builder").StateBuilder
    keys = []
    for h in hists:
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(builder().replay_history(h))
        keys.append(key)
    return stores, keys
