"""The reference imports neither JAX nor the JAX package nor anything of
the program; no file of the benchmark imports JAX or the JAX package.
Top-level names are compared whole: ``tpu_flash_torch`` is not
``tpu_flash``."""

import ast

import pytest

from port_bench.run import FORBIDDEN, forbidden_modules
from port_bench.spec import ROOT


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_torch_alone(path):
    assert set(imported(path)) <= {"__future__", "contextlib", "math",
                                   "torch"}


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    assert not set(imported(path)) & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "tpu_flash_torch_fake",
                        types.ModuleType("tpu_flash_torch_fake"))
    assert "tpu_flash" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_flash.sub",
                        types.ModuleType("tpu_flash.sub"))
    assert "tpu_flash" in forbidden_modules()
