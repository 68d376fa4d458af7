"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either. Names are compared by
their top-level part (before the first dot), whole: the program's package
name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
JAX = {"jax", "jaxlib", "flax", "bevyray_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_modules_found():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", [p for p in MODULES if p.parent.name == "reference"],
    ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not top_level_imports(path) & (JAX | {"bevyray_tpu_torch"})


def test_names_compared_whole():
    assert "bevyray_tpu_torch" not in JAX
    assert top_level_imports(HERE / "entries" / "fused.py") >= {
        "bevyray_tpu_torch"}
