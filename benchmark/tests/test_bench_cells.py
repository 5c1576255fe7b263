"""Discovery by name, BENCHMARK.json's shape, and a configuration, a cell,
a traffic mix and a metric added as new files only."""

import json
import re
import shutil

import _harness
import pytest

from benchmark.core import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return json.loads((_harness.ROOT / "BENCHMARK.json").read_text())


def test_every_name_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = cells.load_cell(_harness.ROOT, bench, w["name"])
        assert cell.chips == w["chips"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names
        assert any(n.startswith("solve_ms") for n in names)
        assert cell.per_layer
        assert cell.workload["limits"]["max_rel_residual"] > 0
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.load_reader(_harness.ROOT, m["name"]))
    for c in bench["configs"]:
        assert (_harness.ROOT / c["file"]).is_file()


def test_benchmark_json_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        names.append(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        names.append(m["name"])
    layers = set()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        layers.add(m["layer"])
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len(names) == len(set(names))
    perf = (_harness.ROOT / "PERF.md").read_text()
    for layer in layers:   # PERF.md's list of layers names each, exactly
        assert layer in perf, layer
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_unknown_names_are_refused():
    bench = _bench()
    with pytest.raises(cells.CellError):
        cells.load_cell(_harness.ROOT, bench, "no.such_cell")
    with pytest.raises(cells.CellError):
        cells.load_reader(_harness.ROOT, "no.such_metric")
    with pytest.raises(cells.CellError):
        cells.load_reader(_harness.ROOT, "../run")


def test_new_files_only(tmp_path):
    """Two deployments (one with its own 27-point coefficients), three
    traffic mixes (a block of 2 right-hand sides; the matrix refreshed
    every 3rd request; BiCGStab with its iteration check), three cells and
    a metric, added as files: the harness finds
    them without an edit to any file it has."""
    root, bench = _harness.checkout(tmp_path / "checkout")
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "hpcg_256.json").read_text())
    cfg.update(name="hpcg_small", grid=[40, 40, 40])
    (b / "configs" / "hpcg_small.json").write_text(json.dumps(cfg))
    convdiff = dict(_harness.convdiff_config(), name="convdiff_small",
                    grid=[40, 40, 40])
    (b / "configs" / "convdiff_small.json").write_text(json.dumps(convdiff))
    base = json.loads((b / "traffic" / "cg_closed.json").read_text())
    block = dict(base, rhs_columns=2, iteration_reference=False)
    (b / "traffic" / "cg_block2.json").write_text(json.dumps(block))
    refresh = dict(base, refresh_every=3, kwargs={"backend": "amg"},
                   iteration_reference=False)
    (b / "traffic" / "amg_refresh3.json").write_text(json.dumps(refresh))
    named = dict(base, kwargs={"method": "bicgstab"}, base_seed=1,
                 iteration_reference=True)
    (b / "traffic" / "bicgstab_named.json").write_text(json.dumps(named))
    cells_ = {"small.cg_block2": ("hpcg_small", "cg_block2"),
              "small.amg_refresh3": ("hpcg_small", "amg_refresh3"),
              "small.cd_bicgstab": ("convdiff_small", "bicgstab_named")}
    for cell in cells_:
        limits = {"max_rel_residual": 2e-06}
        if cell == "small.cd_bicgstab":
            limits["iters_gap"] = 0.05
        (b / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": limits, "why": "test"}))
    (b / "metrics" / "solver.max_iterations.py").write_text(
        "def read(run):\n"
        "    return float(max(s['iterations'] for s in run.solves))\n")
    for name in ("hpcg_small", "convdiff_small"):
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for cell, (config, traffic) in cells_.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    bench["per_layer"].append({
        "name": "solver.max_iterations", "unit": "iters", "better": "lower",
        "source": "program_counter", "layer": "solvers: Krylov loops",
        "moves": "solve_ms", "workloads": list(cells_)})
    for m in bench["end_to_end"]:
        if m["name"] in ("solve_ms", "solve_ms_p90"):
            m["workloads"] += list(cells_)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell in cells_:
        code, last, err = _harness.run_cell(cell, root=root, trace=1, nx=10)
        assert code == 0, err[-3000:]
        assert last["correct"] is True, err[-2000:]
        assert last["metrics"]["solver.max_iterations"]["value"] > 0
        assert last["attempted"] == 8
        assert ("iters_gap" in last["checks"]) == (cell == "small.cd_bicgstab")
    code, last, err = _harness.run_cell("small.amg_refresh3", root=root,
                                        nx=10, seconds=1.5)
    assert code == 0 and last["correct"] is True, err[-2000:]


def test_the_convdiff_checkout_adds_files_only(tmp_path):
    root = _harness.convdiff_checkout(tmp_path)
    for path in (_harness.ROOT / "benchmark").rglob("*"):
        rel = path.relative_to(_harness.ROOT)
        if path.is_file() and "tests" not in rel.parts \
                and "__pycache__" not in rel.parts:
            assert (root / rel).read_bytes() == path.read_bytes(), rel
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (traffic, kwargs) in _harness.CONVDIFF_CELLS.items():
        assert not (_harness.ROOT / "benchmark" / "traffic"
                    / f"{traffic}.json").exists()
        assert any(w["name"] == cell for w in bench["workloads"])
        loaded = cells.load_cell(root, bench, cell)
        assert loaded.method == kwargs["method"]
        assert loaded.coefficients == {(-1, 0, 0): -1.3, (1, 0, 0): -0.7}
    for w in json.loads((_harness.ROOT / "BENCHMARK.json").read_text()
                        )["workloads"]:
        loaded = cells.load_cell(_harness.ROOT, bench, w["name"])
        assert (loaded.method, loaded.coefficients) == ("cg", {})


def test_a_checkout_without_the_program_fails(tmp_path):
    root = tmp_path / "bare"
    root.mkdir()
    shutil.copy(_harness.ROOT / "BENCHMARK.json", root)
    shutil.copytree(_harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code, last, _ = _harness.run_cell("hpcg256.cg_f32", root=root)
    assert code != 0 and last is None
