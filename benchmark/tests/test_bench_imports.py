"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's)."""

import ast
import json
from pathlib import Path

import _harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_sparse"}


def _top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax():
    for path in (_harness.ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_names(path) & FORBIDDEN, path


def test_references_import_torch_alone():
    for path in (_harness.ROOT / "benchmark" / "reference").glob("*.py"):
        assert _top_names(path) <= {"__future__", "math", "torch",
                                    "benchmark"}, path


def test_run_refuses_a_loaded_jax_package():
    # the harness's own check, by whole names: tpu_sparse_torch is not
    # tpu_sparse, and a loaded tpu_sparse fails the run
    import sys

    from benchmark import run
    saved = dict(sys.modules)
    try:
        sys.modules.pop("tpu_sparse", None)
        sys.modules["tpu_sparse_torch_fake"] = object()
        assert "tpu_sparse" not in run.forbidden_modules()
        sys.modules["tpu_sparse.sparse"] = object()
        assert run.forbidden_modules() == ["tpu_sparse"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    code, last, err = _harness.run_cell("hpcg256.cg_f32", seconds=0.5)
    assert code == 0, err[-2000:]
    assert last["correct"] is True
    assert "forbidden" not in err


def test_benchmark_json_names_no_outside_file():
    bench = json.loads((_harness.ROOT / "BENCHMARK.json").read_text())
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
