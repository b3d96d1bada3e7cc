"""Nothing the benchmark runs loads JAX or the JAX package."""
import subprocess
import sys

from perfbench.catalog import ROOT
from perfbench.guard import forbidden_modules


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "cadence_tpu",
             "cadence_tpu.ops.replay", "cadence_tpu_torch", "cadence_tpu_torch.ops.replay",
             "jaxtyping", "flaxen", "perfbench.guard", "torch"]
    assert forbidden_modules(names) == ["cadence_tpu", "cadence_tpu.ops.replay", "flax.linen",
                                        "jax", "jax.numpy", "jaxlib.xla_client"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_the_harness_and_the_port_load_nothing_forbidden():
    loaded = _loaded("import perfbench.run, perfbench.harness, perfbench.control\n"
                     "from perfbench.catalog import find_cell\n"
                     "for c in ('north-star.wire32', 'bench-basic.wire32', 'bench-basic.wirec'):\n"
                     "    find_cell(c)\n"
                     "import cadence_tpu_torch.ops.replay, cadence_tpu_torch.native.wirec")
    assert forbidden_modules(loaded) == []


def test_the_reference_and_the_generator_load_nothing_of_the_program():
    loaded = _loaded("import perfbench.reference, perfbench.gen.basic, perfbench.verify")
    assert forbidden_modules(loaded) == []
    assert [m for m in loaded if m.split(".")[0] == "cadence_tpu_torch"] == []
