"""What the benchmark's files import, by whole top-level module names."""
import ast
import os

import pytest

from portbench.bench import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "mmoe_multimodal_rec_tpu"}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def files(sub=""):
    for d, _, names in os.walk(os.path.join(HERE, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(files()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_jax_package(path):
    assert not set(imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(files("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "mmoe_multimodal_rec_tpu_torch" not in set(imports(path))


def test_whole_names_are_compared():
    assert "mmoe_multimodal_rec_tpu_torch".split(".")[0] not in FORBIDDEN
