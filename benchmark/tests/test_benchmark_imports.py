"""What the benchmark's modules import, by their top-level names compared
whole: no JAX and no JAX package anywhere, nothing of the program's own
bench package, and nothing of the program in the reference."""

import ast

import pytest

from benchmark.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "hnsw_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Every module name an import statement of `path` names."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.name)
def test_no_jax_and_no_program_bench(path):
    for name in imported(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)
        assert not name.startswith("hnsw_tpu_torch.bench"), (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for name in imported(HERE / "reference.py"):
        assert name.split(".")[0] in {"__future__", "numpy", "torch"}, name


def test_top_level_names_are_compared_whole():
    assert "hnsw_tpu_torch.models".split(".")[0] not in FORBIDDEN
    assert "hnsw_tpu.models".split(".")[0] in FORBIDDEN
