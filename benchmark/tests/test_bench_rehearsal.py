"""A ``--seconds`` rehearsal of every cell on the CPU at a tiny grid: the
same code paths, the port's plain kernels, the last line's shape, and no
device metric from a CPU run; also of the cells later changes add as files
(``_harness.dist_checkout``, ``_harness.convdiff_checkout``). A card run of
a cell is marked ``cuda`` and skips here."""

import json

import _harness
import pytest
import torch

from benchmark.core import cells

CELLS = [w["name"] for w in json.loads(
    (_harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
DEVICE_METRICS = {"peak_mem_gib", "kernel.cg_iter_roofline",
                  "kernel.cg_iter_roofline.dist", "device.idle_pct",
                  "device.idle_pct.amg", "device.idle_pct.dist",
                  "precond.vcycle_ms", "precond.launches_per_vcycle",
                  "dist.halo_ms"}


@pytest.fixture(scope="module")
def dist_root(tmp_path_factory):
    return _harness.dist_checkout(tmp_path_factory.mktemp("dist"))


@pytest.fixture(scope="module")
def convdiff_root(tmp_path_factory):
    return _harness.convdiff_checkout(tmp_path_factory.mktemp("convdiff"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS + [_harness.DIST_CELL]
                         + list(_harness.CONVDIFF_CELLS))
def test_rehearsal(cell, trace, request):
    root = _harness.ROOT
    if cell == _harness.DIST_CELL:
        root = request.getfixturevalue("dist_root")
    elif cell in _harness.CONVDIFF_CELLS:
        root = request.getfixturevalue("convdiff_root")
    code, last, err = _harness.run_cell(cell, trace=trace, seconds=1.0,
                                        root=root)
    assert code == 0, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert last["device"]["platform"] == "cpu"
    assert not set(last["metrics"]) & DEVICE_METRICS
    assert "breakdown" not in last and "busy_s" not in last["device"]
    traffic = cells.load_cell(root, cells.load_benchmark(root), cell).traffic
    assert ("iters_gap" in last["checks"]) == traffic["iteration_reference"]
    if trace:
        assert last["attempted"] == traffic["trace_solves"]
        assert any(m.startswith("solver.iterations") for m in last["metrics"])
    else:
        assert "setup_s" in last["metrics"]
        assert any(m.startswith("solve_ms") for m in last["metrics"])
    tail = err.strip().splitlines()[-len(last["checks"]):]
    for line, name in zip(tail, last["checks"]):
        assert line.startswith(f"check {name} ")


def test_no_card_no_result():
    """Without the rehearsal flag a machine with no card prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(_harness.RUN), "--workload", "hpcg256.cg_f32",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=_harness.ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
def test_cell_on_the_card():
    """Cell 1 on the card for two seconds: correct, with device metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(_harness.RUN), "--workload", "hpcg256.cg_f32",
         "--seed", "2147483723", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=_harness.ROOT)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["metrics"]["peak_mem_gib"]["value"] > 0
