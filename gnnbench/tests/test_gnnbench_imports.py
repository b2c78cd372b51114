"""The import check: every module under ``gnnbench/`` is parsed and each
imported module's top-level name (the part before the first dot) compared
whole. Nothing imports JAX or the JAX package; nothing under
``gnnbench/reference/`` imports the port; nothing opens a fixed path under
``/tmp`` or ``/dev/shm``."""
import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tf_geometric_tpu"}
FIXED_DIRS = ("/" + "tmp", "/dev/" + "shm")
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_module_imports(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "tf_geometric_tpu_torch" not in names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not node.value.startswith(FIXED_DIRS), node.value


def test_the_check_compares_whole_top_level_names():
    assert "tf_geometric_tpu_torch" not in FORBIDDEN
    assert {"tf_geometric_tpu_torch", "gnnbench", "torch"} & FORBIDDEN == set()
