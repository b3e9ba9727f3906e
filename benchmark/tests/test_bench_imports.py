"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either (top-level names compared
whole: ``busca_tpu_torch`` begins with ``busca_tpu`` and is not it)."""

import ast
import os
import sys

from conftest import BENCH

NEVER = {"jax", "jaxlib", "flax", "busca_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    bad = {(p, m) for p in sources() for m in imported_tops(p) if m in NEVER}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    bad = {(p, m) for p in sources("benchref") for m in imported_tops(p)
           if m in NEVER | {"busca_tpu_torch", "bmk"}}
    assert not bad


def test_names_are_compared_whole(monkeypatch):
    import types

    sys.path.insert(0, BENCH)
    import run

    fake = dict.fromkeys(["busca_tpu_torch", "busca_tpu_torch.ops",
                          "jaxtyping", "numpy"])
    monkeypatch.setattr(run, "sys", types.SimpleNamespace(modules=fake))
    assert run.forbidden_modules() == []
    fake["busca_tpu.eval"] = None
    fake["jax._src"] = None
    assert run.forbidden_modules() == ["busca_tpu", "jax"]
