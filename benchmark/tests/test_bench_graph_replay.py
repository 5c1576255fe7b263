"""``precond.graph_replay_pct``: the share of the AMG cycle's applies on
the card that replayed a captured graph, from the ``precond.graph_*``
counters of the traced window's ``tsp.solve`` records. A CPU rehearsal
applies nothing on a card, so the traced AMG rehearsal leaves the metric
out; a program without the counters or without spans gives None."""

import sys

import _harness
import pytest

from benchmark.core import cells

NAME = "precond.graph_replay_pct"


class _Root:
    def __init__(self, counters):
        self.counters = counters


def _read(monkeypatch, roots, solves):
    from tpu_sparse_torch import tracing

    monkeypatch.setattr(tracing, "solves", lambda: list(roots))

    class Run:
        pass

    run = Run()
    run.solves = [{"iterations": 3}] * solves
    return cells.load_reader(_harness.ROOT, NAME)(run)


def test_replays_over_every_apply_of_the_window(monkeypatch):
    """Only the window's own solves count: an earlier solve's eager apply
    and capture stay out."""
    warm = _Root({"precond.graph_eager": 1, "precond.graph_captures": 1,
                  "precond.graph_replays": 30})
    window = [_Root({"precond.graph_replays": 33}) for _ in range(8)]
    assert _read(monkeypatch, [warm] + window, 8) == 100.0
    mixed = [_Root({"precond.graph_replays": 30, "precond.graph_eager": 2,
                    "precond.graph_captures": 0}), _Root({})]
    assert _read(monkeypatch, mixed, 2) == pytest.approx(100.0 * 30 / 32)


def test_no_apply_on_a_card_reads_nothing(monkeypatch):
    """The parent's records (no ``precond.*`` counter) and a window
    without solves give None."""
    parent = [_Root({"solver.host_syncs": 4}), _Root(None)]
    assert _read(monkeypatch, parent, 2) is None
    assert _read(monkeypatch, [], 0) is None


def test_a_program_without_spans_reports_nothing(monkeypatch):
    import tpu_sparse_torch

    monkeypatch.delattr(tpu_sparse_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tpu_sparse_torch.tracing", None)

    class Run:
        solves = [{"iterations": 3}]

    assert cells.load_reader(_harness.ROOT, NAME)(Run()) is None


def test_traced_amg_rehearsal_leaves_it_out():
    code, last, err = _harness.run_cell("hpcg256.amgpcg_f32", trace=1, nx=10)
    assert code == 0, err[-3000:]
    assert last["correct"] is True
    assert NAME not in last["metrics"]
    assert "precond.vcycle_host_ms" in last["metrics"]
