"""The per-layer metrics read from the program's own spans and counters
(``tpu_sparse_torch.tracing``): present and sane in a traced CPU
rehearsal of both cells, absent (not raised) for a program without
spans, and BENCHMARK.json still keeping the rules of
``test_bench_cells.py`` with them."""

import math
import sys

import _harness
import pytest
import test_bench_cells

from benchmark.core import cells

SPAN_METRICS = {
    "hpcg256.cg_f32": ("router.host_ms", "solver.overshoot_pct",
                       "solver.host_syncs"),
    "hpcg256.amgpcg_f32": ("router.host_ms.amg", "solver.overshoot_pct.amg",
                           "solver.host_syncs.amg",
                           "precond.vcycle_host_ms"),
}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_rehearsal_reports_the_span_metrics(cell):
    code, last, err = _harness.run_cell(cell, trace=1, nx=10)
    assert code == 0, err[-3000:]
    assert last["correct"] is True
    metrics = {k: v["value"] for k, v in last["metrics"].items()}
    for name in SPAN_METRICS[cell]:
        assert name in metrics and math.isfinite(metrics[name]), name
    for name, value in metrics.items():
        if name.startswith("solver.overshoot_pct"):
            assert value >= 0
        elif name.startswith("solver.host_syncs"):
            assert value >= 1
        elif name.startswith(("router.host_ms", "precond.vcycle_host_ms")):
            assert value > 0


def test_a_program_without_spans_reports_nothing(monkeypatch):
    """The readers run against a checkout of the program from before its
    spans: they return None, so the result line leaves the metric out."""
    import tpu_sparse_torch

    monkeypatch.delattr(tpu_sparse_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tpu_sparse_torch.tracing", None)

    class Run:
        solves = [{"iterations": 3}]

    for names in SPAN_METRICS.values():
        for name in names:
            assert cells.load_reader(_harness.ROOT, name)(Run()) is None


def test_benchmark_json_keeps_its_rules():
    test_bench_cells.test_benchmark_json_shape()
    test_bench_cells.test_every_name_resolves()
