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
