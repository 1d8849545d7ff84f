"""No module of the benchmark loads JAX or the JAX package, and the
yardstick (the plain references and the counts) loads nothing of the
program either. Names are compared whole at the top level:
`crvqa_tpu_torch` is the program, `crvqa_tpu` the JAX package."""
from __future__ import annotations

import ast
import pathlib
import sys
import types

import pytest

from portbench.harness.main import FORBIDDEN, forbidden_modules

PB = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)
YARDSTICK = [p for p in SOURCES
             if p.relative_to(PB).parts[0] in ("reference", "counts")]


def top_level_imports(path: pathlib.Path) -> set[str]:
    """The top-level names a file imports (`import a.b`, `from a.b import
    c`, `importlib.import_module("a.b")`); relative imports are the
    benchmark's own."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_benchmark_has_sources():
    assert len(SOURCES) > 20 and len(YARDSTICK) >= 6


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", YARDSTICK,
                         ids=lambda p: str(p.relative_to(PB)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    imports = top_level_imports(path)
    assert "crvqa_tpu_torch" not in imports
    assert not imports & set(FORBIDDEN)


def test_the_run_time_check_compares_whole_names(monkeypatch):
    import crvqa_tpu_torch  # noqa: F401 (the program itself passes)

    assert "crvqa_tpu_torch" in sys.modules
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "crvqa_tpu.models",
                        types.ModuleType("crvqa_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert forbidden_modules() == ["crvqa_tpu", "jaxlib"]
