"""The drift test of the modules the port copies from the JAX package:
a copied module's text equals the JAX module's once `cadence_tpu` reads
`cadence_tpu_torch`, except the port's own hunks, kept as a unified diff
in tests/torch_hunks/<package>_<module>.diff (no file: no hunks).

After a deliberate change to a copied module (or to its JAX twin), write
the new hunks and review them like code:

    python -m tests.torch_port_drift rpc/server loadgen/scenarios
"""
import difflib
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HUNKS = ROOT / "tests" / "torch_hunks"


def port_diff(module: str) -> str:
    """The unified diff from the JAX module (imports rewritten) to the
    port's copy, one line of context."""
    jax = (ROOT / "cadence_tpu" / f"{module}.py").read_text()
    want = re.sub(r"\bcadence_tpu\b", "cadence_tpu_torch", jax)
    got = (ROOT / "cadence_tpu_torch" / f"{module}.py").read_text()
    return "".join(difflib.unified_diff(want.splitlines(True), got.splitlines(True),
                                        f"cadence_tpu/{module}.py",
                                        f"cadence_tpu_torch/{module}.py", n=1))


def hunks_path(module: str) -> Path:
    return HUNKS / (module.replace("/", "_") + ".diff")


def assert_port_text(module: str) -> None:
    path = hunks_path(module)
    want = path.read_text() if path.exists() else ""
    assert port_diff(module) == want, (
        f"cadence_tpu_torch/{module}.py drifted from the JAX module and "
        f"{path.relative_to(ROOT)}")


if __name__ == "__main__":
    for module in sys.argv[1:]:
        diff, path = port_diff(module), hunks_path(module)
        if diff:
            HUNKS.mkdir(exist_ok=True)
            path.write_text(diff)
        elif path.exists():
            path.unlink()
        print(f"{module}: {diff.count(chr(10) + '@@')} hunks" if diff else f"{module}: none")
