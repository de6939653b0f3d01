"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: `pvderx_torch` is not `pvderx`), and the reference
imports nothing of the program."""
import ast

import pytest

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "pvderx"}
FILES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_portbench_module_imports_no_jax(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & BANNED


def test_portbench_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench/reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in imported(path)}
        assert "pvderx_torch" not in tops, path


def test_portbench_banned_modules_compares_whole_names(monkeypatch):
    import sys

    from portbench import harness

    monkeypatch.setitem(sys.modules, "pvderx_torch_like", object())
    assert "pvderx" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "pvderx.env", object())
    assert "pvderx" in harness.banned_modules()
