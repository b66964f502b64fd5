"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the port."""

import ast
import os

from benchmark import run as R

BENCH = R.BENCH_DIR


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return [m.split(".")[0] for m in out if m]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if "__pycache__" in dirpath or "/tests" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    seen = set()
    for path in _sources():
        tops = _imports(path)
        seen.update(tops)
        bad = set(tops) & set(R.FORBIDDEN)
        assert not bad, (path, bad)
    # the port's name begins with the JAX package's: whole names differ
    assert "deepviewagg_tpu_torch" in seen
    assert "deepviewagg_tpu_torch" not in R.FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "deepviewagg_tpu_torch" not in _imports(path), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "deepviewagg_tpu_torch_x",
                        types.ModuleType("deepviewagg_tpu_torch_x"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deepviewagg_tpu.ops",
                        types.ModuleType("deepviewagg_tpu.ops"))
    assert R.forbidden_modules() == ["deepviewagg_tpu"]
