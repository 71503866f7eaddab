"""Nothing the benchmark runs imports JAX or the JAX package: names are
compared whole at the top level, so the port's etts_torch passes."""
from __future__ import annotations

import ast

from pb import guard, spec


def test_whole_top_level_names():
    assert guard.forbidden_loaded(["etts_torch", "etts_torch.api",
                                   "numpy"]) == []
    assert guard.forbidden_loaded(["etts.models", "jaxlib.xla_client",
                                   "flax", "jax"]) == ["etts", "flax",
                                                       "jax", "jaxlib"]


def test_no_source_of_the_benchmark_imports_them():
    bad = []
    for path in spec.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in guard.FORBIDDEN]
    assert bad == []


def test_the_references_import_nothing_of_the_program():
    for path in (spec.HERE / "pb" / "reference").glob("*.py"):
        src = path.read_text()
        assert "etts_torch" not in src, path
