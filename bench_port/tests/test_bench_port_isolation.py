"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program under test."""

from __future__ import annotations

import ast
import os

import pytest

from conftest import PACKAGE

FORBIDDEN = {"jax", "jaxlib", "flax", "bikg_graph_explainability_public_tpu"}
PORT = "bikg_graph_explainability_public_tpu_torch"
FILES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PACKAGE) for f in fs if f.endswith(".py")
    and "__pycache__" not in d
)


def _imports(path):
    """Top-level names of every module the file imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, PACKAGE) for p in FILES])
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


REFERENCE = [p for p in FILES if os.sep + "reference" + os.sep in p]


@pytest.mark.parametrize("path", REFERENCE, ids=[os.path.relpath(p, PACKAGE) for p in REFERENCE])
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(_imports(path))


def test_the_port_name_is_not_a_forbidden_one():
    # the port's name begins with the JAX package's; whole names are compared
    assert PORT.split(".")[0] not in FORBIDDEN
