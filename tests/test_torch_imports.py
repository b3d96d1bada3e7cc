"""cadence_tpu_torch never imports JAX or anything of cadence_tpu; only the
tests import both packages."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cadence_tpu_torch")


def _python_sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _modules():
    for path in _python_sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "cadence_tpu") or top.startswith("jax")


def test_every_module_imports_without_jax():
    """In a fresh interpreter (tests/conftest.py has imported jax here)."""
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cadence_tpu') or m.startswith('jax'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('cadence_tpu_torch')]))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(_python_sources()) + [os.path.join(ROOT, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
