"""Nothing under portbench/ imports JAX or the JAX package, compared by
each import's whole top-level name (the port, pint_tpu_torch, is not the
JAX package pint_tpu); the reference imports nothing of the port."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "pint_tpu"}


def modules():
    for dirpath, _, files in os.walk(HERE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    bad = set(imported(path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize(
    "path", [p for p in modules()
             if os.sep + "reference" + os.sep in p],
    ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    names = set(imported(path))
    assert "pint_tpu_torch" not in names
    assert "portbench" not in names  # only its own modules, relatively


def test_checker_sees_through_names(tmp_path):
    """Whole top-level names: the port's name starts with the JAX
    package's and passes; the JAX package and jaxlib are caught."""
    path = tmp_path / "m.py"
    path.write_text("import pint_tpu_torch.toa\nfrom pint_tpu import x\n"
                    "import jaxlib\nimport importlib\n"
                    "importlib.import_module('jax.numpy')\n")
    assert set(imported(str(path))) & FORBIDDEN == {"pint_tpu", "jaxlib",
                                                    "jax"}
