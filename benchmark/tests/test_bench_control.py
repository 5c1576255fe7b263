"""The comparison that decides ``correct`` fails what it must: the control
(the reference CG computed in bfloat16 in the program's place) and the
faults a cell can have, planted under a run whose chip check is skipped
(a CPU rehearsal at a small grid), also in the BiCGStab and GMRES cells a
later change adds as files (``_harness.convdiff_checkout``)."""

import json
import subprocess
import sys

import _harness
import pytest
import torch

from benchmark import run
from benchmark.core import cells


def _last_json(text: str):
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


@pytest.fixture(scope="module")
def readings():
    cmd = [sys.executable, str(_harness.RUN), "--workload", "hpcg256.cg_f32",
           "--seed", "1", "--seconds", "1", "--cpu-rehearsal", "12",
           "--calibrate", "11,12", "--control-seeds", "21,22,23"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=_harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]


def test_control_readings(readings):
    program = [r for r in readings if r["side"] == "program"]
    control = [r for r in readings if r["side"] == "control"]
    assert len(program) == 2 and len(control) == 3
    assert all(r["correct"] for r in program)
    assert not any(r["correct"] for r in control)
    low = max(r["checks"]["max_rel_residual"]["value"] for r in program)
    high = min(r["checks"]["max_rel_residual"]["value"] for r in control)
    assert high >= 3 * low


@pytest.mark.parametrize("cell", list(_harness.CONVDIFF_CELLS))
def test_bf16_control_fails_the_residual_limit(tmp_path, cell):
    """The program's readings pass the limit 2e-6; the method's reference
    computed in bfloat16 in its place fails it, by far."""
    root = _harness.convdiff_checkout(tmp_path)
    cmd = [sys.executable, str(root / "benchmark" / "run.py"), "--workload",
           cell, "--seed", "1", "--seconds", "1", "--cpu-rehearsal", "8",
           "--calibrate", "11", "--control-seeds", "21"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    (program,) = [r for r in lines if r["side"] == "program"]
    (control,) = [r for r in lines if r["side"] == "control"]
    limit = program["checks"]["max_rel_residual"]["limit"]
    assert limit == 2e-06
    assert program["correct"] and not control["correct"]
    low = program["checks"]["max_rel_residual"]["value"]
    high = control["checks"]["max_rel_residual"]["value"]
    assert high > limit and high >= 3 * low


def _patched_solve(monkeypatch, fault):
    import tpu_sparse_torch

    original = tpu_sparse_torch.solve

    def faulty(A, b, **kw):
        if fault == "early_stop":  # a weaker stop: 9 x the stated tolerance
            return original(A, b, **dict(kw, tol=9.0 * kw["tol"]))
        x, res = original(A, b, **kw)
        if fault == "unchanged":   # the solve hands back its start, x0 = 0
            return torch.zeros_like(x), res
        x = x.clone()              # one entry altered where it is produced
        x[x.shape[0] // 2] += 1.0
        return x, res

    monkeypatch.setattr(tpu_sparse_torch, "solve", faulty)


@pytest.mark.parametrize("workload", ["hpcg256.cg_f32", "hpcg256.amgpcg_f32"]
                         + list(_harness.CONVDIFF_CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "altered", "early_stop"])
def test_single_card_faults(monkeypatch, capfd, tmp_path, workload, fault):
    _patched_solve(monkeypatch, fault)
    nx = 10
    if workload in _harness.CONVDIFF_CELLS:
        monkeypatch.setattr(run, "ROOT", _harness.convdiff_checkout(tmp_path))
        # GMRES(30) at 24^3 takes two restart cycles; at 10^3 one cycle
        # reaches 9 x the tolerance, so the weaker stop changes nothing
        nx = 24 if "gmres" in workload else 10
    code = run.main(["--workload", workload, "--seed", "2147483711",
                     "--seconds", "0.5", "--trace", "0",
                     "--cpu-rehearsal", str(nx)])
    out = _last_json(capfd.readouterr().out)
    assert code == 0
    assert out["correct"] is False
    assert out["checks"]["max_rel_residual"]["value"] > \
        out["checks"]["max_rel_residual"]["limit"]


_WRAPPER = """
import runpy, sys
sys.path.insert(0, {root!r})
import torch
import tpu_sparse_torch.dist as D
import tpu_sparse_torch.dist.spmv as S
fault = {fault!r}
if fault == "no_exchange":
    def fill(ext, x, off, wl, wr, mesh):
        ext[off:off + x.shape[0]] = x      # the neighbours' strips left out
    S._halo_fill = fill
else:
    original = D.distributed_cg
    def faulty(A, b, *a, **kw):
        x, info, it, res = original(A, b, *a, **kw)
        if fault == "unchanged":
            return torch.zeros_like(x), info, it, res
        x = x.clone()
        x[x.shape[0] // 2] += 1.0
        return x, info, it, res
    D.distributed_cg = faulty
sys.argv = [{run_py!r}] + sys.argv[1:]
runpy.run_path({run_py!r}, run_name="__main__")
"""


@pytest.mark.parametrize("fault", ["no_exchange", "unchanged", "altered"])
def test_four_rank_faults(tmp_path, capfd, fault):
    root = _harness.dist_checkout(tmp_path)
    run_py = root / "benchmark" / "run.py"
    wrapper = tmp_path / "faulty_rank.py"
    wrapper.write_text(_WRAPPER.format(root=str(root), fault=fault,
                                       run_py=str(run_py)))
    args = run.parse_args(["--workload", _harness.DIST_CELL, "--seed",
                           "2147483713", "--seconds", "0.5", "--trace", "0",
                           "--cpu-rehearsal", "8"])
    cell = cells.load_cell(root, cells.load_benchmark(root), args.workload)
    code = run.launch(args, cell, worker_cmd=[sys.executable, str(wrapper)])
    out = _last_json(capfd.readouterr().out)
    assert code == 0
    assert out["correct"] is False
