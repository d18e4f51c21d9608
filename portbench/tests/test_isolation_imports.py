"""Nothing under portbench/ imports JAX, its libraries or the JAX package,
and the reference imports nothing of the measured program; names are
compared as whole top-level module names (armnet_tpu_torch is not
armnet_tpu)."""

import ast
import os

import pytest

from portbench import run

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {"jax", "jaxlib", "flax", "armnet_tpu"}


def _sources(under):
    for base, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            found.add(node.args[0].value.split(".", 1)[0])
    return found


@pytest.mark.parametrize("path", sorted(_sources(PACKAGE)),
                         ids=lambda p: os.path.relpath(p, PACKAGE))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize(
    "path", sorted(_sources(os.path.join(PACKAGE, "reference"))),
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    found = _top_level_imports(path)
    assert "armnet_tpu_torch" not in found
    assert found <= {"torch", "math", "contextlib", "portbench"}


def test_scan_compares_whole_names():
    assert run.forbidden_modules(["armnet_tpu_torch.models", "torch"]) == []
    assert run.forbidden_modules(["armnet_tpu.models", "jaxlib.xla"]) == [
        "armnet_tpu", "jaxlib"]
    assert run.forbidden_modules(["jax_utils", "flaxen"]) == []
