"""What the benchmark's files import, by each import's whole top-level
name: nothing of JAX or of the JAX package anywhere (`ouroboros_tpu_torch`
is not `ouroboros_tpu`), and nothing of the program in the reference."""
import ast
import os

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "ouroboros_tpu"}


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_whole_names_are_compared():
    assert "ouroboros_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "ouroboros_tpu.crypto".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_nor_the_jax_package(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "ouroboros_tpu_torch" not in top_names(path)
    assert not top_names(path) & {"torch", "numpy"}
