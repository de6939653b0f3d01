"""The port stands alone: `pvderx_torch` and `chip_smoke.py` never import
JAX or the JAX package.

- In a fresh interpreter, importing `pvderx_torch` and every submodule
  leaves neither `jax` nor any `pvderx` module in `sys.modules`.
- An AST scan of `pvderx_torch/**/*.py` and `chip_smoke.py` finds no import
  of `jax` or of `pvderx` / `pvderx.*`.
"""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pvderx_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_torch_import_pulls_in_no_jax():
    mods = list(_modules())
    assert {"pvderx_torch.ops.window", "pvderx_torch.physics.fleet",
            "pvderx_torch.env.fleet", "pvderx_torch.oracle",
            "pvderx_torch.ops._build", "pvderx_torch.ops.dualfloat",
            "pvderx_torch.env.vector"} <= set(mods) and len(mods) >= 23
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith("
        "('jax.', 'jaxlib')) or k == 'pvderx' or k.startswith('pvderx.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_torch_source_imports_no_jax(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "pvderx"), f"{path}: import {name}"
