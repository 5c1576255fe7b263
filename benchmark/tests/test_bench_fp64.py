"""The float64 cells (``hpcg_256_fp64``) and their two readers:
``solver.refine_sweeps`` (the mean ``refine.sweeps`` of the traced
solves' ``tsp.solve`` records) and ``kernel.refine_roofline`` (the
refinement's least bytes, ``core.refine_roofline``, over the window's
kernel time). Both give None off the card where they need it, without
spans, and on the parent's records, which carry no ``refine.*`` counter;
the traced CPU rehearsal of each cell reports what it can."""

import math
import sys
from types import SimpleNamespace

import _harness
import pytest
import torch

from benchmark.core import cells, refine_roofline, roofline
from benchmark.core import stencil

REFINED, FULL = "hpcg256.cg_f64_refined", "hpcg256.cg_f64_full"
SWEEPS, ROOFLINE = "solver.refine_sweeps", "kernel.refine_roofline"


def _reader(name):
    return cells.load_reader(_harness.ROOT, name)


def test_refine_bytes_arithmetic():
    """Each inner iteration a float32 CG iteration, (27 + 6) x rows x 4 B;
    each sweep one float64 product, (27 + 2) x rows x 8 B."""
    rows = 256 ** 3
    assert refine_roofline.refine_bytes(rows, 27, 8, 180, 2) == \
        180 * 33 * rows * 4 + 2 * 29 * rows * 8
    assert refine_roofline.refine_bytes(rows, 27, 8, 0, 1) == \
        roofline.spmv_bytes(rows, 27, 8)
    assert refine_roofline.refine_bytes(rows, 27, 8, 1, 0) == \
        roofline.cg_iteration_bytes(rows, 27, 4)


def _traced_refinements(count):
    """``count`` real refined solves at 8^3 under the CPU profiler: the
    program's own tsp.solve records, and the solves as the harness keeps
    them."""
    from torch.profiler import ProfilerActivity, profile

    import tpu_sparse_torch
    from tpu_sparse_torch import tracing

    data, offsets = stencil.diagonals([8, 8, 8], 26.0, -1.0, torch.float64,
                                      "cpu")
    n = data.shape[1]
    A = tpu_sparse_torch.DIA(data, offsets, (n, n))
    pool = stencil.rhs_pool(data, offsets, count, 1, 2147483901, 1)
    tracing.reset()
    solves = []
    with profile(activities=[ProfilerActivity.CPU]):
        for b in pool:
            _, res = tpu_sparse_torch.solve(A, b, method="cg", tol=1e-8)
            solves.append({"iterations": res.iterations,
                           "converged": res.converged})
    return solves, n, len(offsets)


def test_readers_on_a_synthetic_card_run():
    """The program's records of three refined solves, read as if a card
    had run them in 0.5 ms of kernels."""
    solves, n, ndiag = _traced_refinements(3)
    from tpu_sparse_torch import tracing

    per_solve = [r.counters["refine.sweeps"] for r in tracing.solves()]
    assert len(per_solve) == 3 and min(per_solve) >= 1
    run = SimpleNamespace(solves=solves, rows=n, ndiag=ndiag, itemsize=8,
                          device=torch.device("cuda"),
                          trace=SimpleNamespace(kernel_s=5e-4))
    assert _reader(SWEEPS)(run) == pytest.approx(sum(per_solve) / 3)
    iters = sum(s["iterations"] for s in solves)
    nbytes = 33 * n * 4 * iters + 29 * n * 8 * sum(per_solve)
    assert _reader(ROOFLINE)(run) == pytest.approx(
        100.0 * nbytes / 3.35e12 / 5e-4)
    run.device = torch.device("cpu")
    assert _reader(ROOFLINE)(run) is None
    run.device, run.trace = torch.device("cuda"), None
    assert _reader(ROOFLINE)(run) is None


def test_parent_records_read_nothing(monkeypatch):
    """A program whose registry has no ``refine`` group (the parent's)
    reads None from both, though its records are there."""
    solves, n, ndiag = _traced_refinements(1)
    from tpu_sparse_torch import tracing

    monkeypatch.setattr(tracing, "_groups", [
        (p, d) for p, d in tracing._groups if p != "refine"])
    run = SimpleNamespace(solves=solves, rows=n, ndiag=ndiag, itemsize=8,
                          device=torch.device("cuda"),
                          trace=SimpleNamespace(kernel_s=5e-4))
    assert _reader(SWEEPS)(run) is None
    assert _reader(ROOFLINE)(run) is None


def test_a_program_without_spans_reports_nothing(monkeypatch):
    import tpu_sparse_torch

    monkeypatch.delattr(tpu_sparse_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tpu_sparse_torch.tracing", None)
    run = SimpleNamespace(solves=[{"iterations": 3}], rows=8, ndiag=27,
                          itemsize=8, device=torch.device("cuda"),
                          trace=SimpleNamespace(kernel_s=1.0))
    assert _reader(SWEEPS)(run) is None
    assert _reader(ROOFLINE)(run) is None


@pytest.mark.parametrize("cell", [REFINED, FULL])
def test_traced_rehearsal_of_the_fp64_cells(cell):
    """Both routes at 10^3 on the CPU: correct to the float64 limit; the
    refined cell reads its sweeps and no device share, the full cell runs
    no refinement and holds its iterations to the reference's."""
    code, last, err = _harness.run_cell(cell, trace=1, nx=10)
    assert code == 0, err[-3000:]
    assert last["correct"] is True and last["failed"] == 0
    metrics = {k: v["value"] for k, v in last["metrics"].items()}
    assert ROOFLINE not in metrics and "kernel.cg_iter_roofline" not in metrics
    for name in ("solver.iterations", "solver.host_syncs",
                 "solver.overshoot_pct", "router.host_ms"):
        assert math.isfinite(metrics[name]), name
    if cell == REFINED:
        assert 1 <= metrics[SWEEPS] <= 3
        assert "iters_gap" not in last["checks"]
    else:
        assert SWEEPS not in metrics
        assert last["checks"]["iters_gap"]["value"] == 0.0
    assert last["checks"]["max_rel_residual"]["value"] <= 1e-8
