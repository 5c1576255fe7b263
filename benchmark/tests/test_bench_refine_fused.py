"""``solver.refine_fused_pct``: the share of the refinement's sweeps whose
inner solve ran the fused CG kernels, from the ``refine.fused_sweeps`` and
``refine.sweeps`` counters of the traced window's ``tsp.solve`` records.
A program without the counter (the parent's) or without spans gives None,
and so does a window without a sweep."""

import sys

import _harness
import pytest

from benchmark.core import cells

NAME = "solver.refine_fused_pct"


class _Root:
    def __init__(self, counters):
        self.counters = counters


def _read(monkeypatch, roots, solves, registry=None):
    from tpu_sparse_torch import tracing

    monkeypatch.setattr(tracing, "solves", lambda: list(roots))
    if registry is not None:
        monkeypatch.setattr(tracing, "counters", lambda: dict(registry))

    class Run:
        pass

    run = Run()
    run.solves = [{"iterations": 3}] * solves
    return cells.load_reader(_harness.ROOT, NAME)(run)


def test_every_sweep_fused_reads_100(monkeypatch):
    """Only the window's own solves count: an earlier solve's unfused
    sweeps stay out."""
    warm = _Root({"refine.sweeps": 3})
    window = [_Root({"refine.sweeps": 2, "refine.fused_sweeps": 2})
              for _ in range(8)]
    assert _read(monkeypatch, [warm] + window, 8) == 100.0


def test_half_the_sweeps_fused_reads_50(monkeypatch):
    roots = [_Root({"refine.sweeps": 2, "refine.fused_sweeps": 2}),
             _Root({"refine.sweeps": 2}), _Root(None)]
    assert _read(monkeypatch, roots, 3) == pytest.approx(50.0)


def test_no_counter_or_no_sweep_reads_nothing(monkeypatch):
    """The parent's registry has ``refine.sweeps`` but no
    ``refine.fused_sweeps``; a window without sweeps has no share."""
    parent = [_Root({"refine.sweeps": 2}) for _ in range(2)]
    assert _read(monkeypatch, parent, 2,
                 registry={"refine.sweeps": 4}) is None
    assert _read(monkeypatch, [_Root({"solver.host_syncs": 9})], 1) is None
    assert _read(monkeypatch, [], 0) is None


def test_a_program_without_spans_reports_nothing(monkeypatch):
    import tpu_sparse_torch

    monkeypatch.delattr(tpu_sparse_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tpu_sparse_torch.tracing", None)

    class Run:
        solves = [{"iterations": 3}]

    assert cells.load_reader(_harness.ROOT, NAME)(Run()) is None
