"""Which runner takes the sweeps of the mixed-precision refinement
(``solvers/mixed.py::_inner_route``), and the fused sweeps on the CPU.

On the card a CG sweep on a float32 DIA with M None or diagonal runs the
fused CG kernels 2-3 (``cuda_cg.fused_cg_ext``); the other methods and
bf16 sweeps run their loop over the extended operator; a CWELL, another M
or a complex cast runs the method on the cast operand. The route is
chosen from the operand alone, so it is checked here without a card.
Off the card every sweep runs the method on the cast operand, so
``refine.fused_sweeps`` stays 0.

``fused_cg_ext`` runs its plain PyTorch version on CPU tensors, so a
refinement through the fused runner (the device test replaced) is held
against the loop's, with tolerances and their reasons:

* the same sweeps, every one fused, and the true residual at most tol;
* the reported inner iterations within 1 a sweep of the loop's: both stop
  at the first crossing of ||r|| <= 1e-5 ||r0||, the fused kernels from
  ||r||^2 reduced in float64, the loop in float32;
* x within 1e-6 of the loop's, relative in norm: both refine to a true
  residual under 1e-8 and cond(A) < 40 at 12^3, so each x is within
  40 x 1e-8 of the exact solution;
* a sign and a power-of-two scale of b: the same iterations and sweeps,
  and x scaled exactly (each step is linear in b and such a scale is exact
  in float32 and float64; the fp64 cells' fixed-base pools rely on it).
"""

import numpy as np
import pytest
import torch
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

import tpu_sparse_torch
from benchmark.core import stencil
from tpu_sparse_torch import tracing
from tpu_sparse_torch.precond.jacobi import (DiagonalPreconditioner,
                                             jacobi_preconditioner)
from tpu_sparse_torch.solvers import mixed
from tpu_sparse_torch.solvers.krylov import bicgstab_full, cg_full, gmres_full
from tpu_sparse_torch.sparse import generators as gen
from tpu_sparse_torch.sparse.containers import DIA
from tpu_sparse_torch.sparse.convert import to_csr
from tpu_sparse_torch.sparse.cwell import csr_to_cwell

TOL = 1e-8


def _f32():
    return gen.poisson3d_27pt(6, dtype=np.float32, device="cpu")


def _jacobi(A):
    return jacobi_preconditioner(A)


_CASES = {
    # name: (inner solver, A32, M32, inner keyword arguments)
    "cg": lambda: (cg_full, _f32(), None, {}),
    "cg-jacobi": lambda: (cg_full, _f32(), _jacobi(_f32()), {}),
    "cg-bf16": lambda: (cg_full, _f32().with_data(
        _f32().data.to(torch.bfloat16)), None, {}),
    "cg-kwargs": lambda: (cg_full, _f32(), None, {"atol": 0.0}),
    "bicgstab": lambda: (bicgstab_full, _f32(), None, {}),
    "bicgstab-jacobi": lambda: (bicgstab_full, _f32(), _jacobi(_f32()), {}),
    "gmres": lambda: (gmres_full, _f32(), None,
                      {"restart": 20, "solve_method": "batched"}),
    "cg-callable-M": lambda: (cg_full, _f32(), lambda v: 0.5 * v, {}),
    "cg-cwell": lambda: (cg_full, csr_to_cwell(to_csr(_f32())), None, {}),
    "cg-complex64": lambda: (cg_full, _f32().with_data(
        _f32().data.to(torch.complex64)), None, {}),
}
_ROUTES = {"cg": "fused", "cg-jacobi": "fused", "cg-bf16": "extended",
           "cg-kwargs": "extended", "bicgstab": "extended",
           "bicgstab-jacobi": "extended", "gmres": "extended",
           "cg-callable-M": "plain", "cg-cwell": "plain",
           "cg-complex64": "plain"}


@pytest.mark.parametrize("case", list(_CASES))
def test_route_of_a_sweep(case):
    """The runner each operand takes on the card; off the card, every
    operand takes the method on the cast operand (never fused)."""
    inner, A32, M32, kw = _CASES[case]()
    route, op = mixed._inner_route(inner, A32, M32, kw)
    assert route == _ROUTES[case]
    assert (op is None) == (route == "plain")
    if route == "fused":
        assert op.dtype == torch.float32
    fused, _ = mixed._make_inner(inner, A32, M32, 1e-5, 100, kw)
    assert fused is False


def _system(nx, seed):
    data, offsets = stencil.diagonals([nx] * 3, 26.0, -1.0, torch.float64,
                                      "cpu")
    n = data.shape[1]
    b, = stencil.rhs_pool(data, offsets, 1, 1, seed, 1)
    return tpu_sparse_torch.DIA(data, offsets, (n, n)), b


def _refine(A, b, M):
    """(x, reported inner iterations, true relative residual, the
    ``refine`` counters of the solve)."""
    tracing.reset()
    x, info, it, _ = mixed.cg_refined(A, b, tol=TOL, M=M)
    assert int(info) == 0
    res = float(torch.linalg.vector_norm(b - A @ x)
                / torch.linalg.vector_norm(b))
    counts = {k: v for k, v in tracing.counters().items()
              if k.startswith("refine.")}
    return x, int(it), res, counts


def _on_card_for_dia(monkeypatch):
    """Route a CPU DIA as a card's: the fused runner's plain versions."""
    monkeypatch.setattr(mixed, "_on_card", lambda A: isinstance(A, DIA))


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "jacobi"])
def test_fused_sweeps_match_the_loop_on_cpu(monkeypatch, jacobi):
    A, b = _system(12, 2147483713)
    M = jacobi_preconditioner(A) if jacobi else None
    x_loop, it_loop, res_loop, c_loop = _refine(A, b, M)
    assert c_loop["refine.fused_sweeps"] == 0
    _on_card_for_dia(monkeypatch)
    x, it, res, c = _refine(A, b, M)
    sweeps = c["refine.sweeps"]
    assert sweeps == c_loop["refine.sweeps"] >= 1
    assert c["refine.fused_sweeps"] == sweeps
    assert c["refine.rescues"] == 0
    assert max(res, res_loop) <= TOL
    assert abs(it - it_loop) <= sweeps
    err = float(torch.linalg.vector_norm(x - x_loop)
                / torch.linalg.vector_norm(x_loop))
    assert err <= 1e-6


def test_fused_sweeps_see_a_sign_and_power_of_two_scale_exactly(
        monkeypatch):
    _on_card_for_dia(monkeypatch)
    A, b = _system(12, 2147483719)
    x, it, _, c = _refine(A, b, None)
    assert c["refine.fused_sweeps"] == c["refine.sweeps"] >= 1
    for factor in (-1.0, 0.25, 4.0, -2.0):
        xf, itf, _, cf = _refine(A, b * factor, None)
        assert itf == it and cf == c
        assert torch.equal(xf, x * factor)


def test_fused_sweep_takes_jacobi_in_original_space(monkeypatch):
    """The fused runner hands M's dinv to ``fused_cg_ext``, which extends
    it itself: a Jacobi of a matrix with a varying diagonal converges to
    the float64 tolerance through ``solve(precision="auto")``."""
    _on_card_for_dia(monkeypatch)
    A64 = gen.poisson3d_27pt(8, dtype=np.float64, device="cpu")
    scale = torch.linspace(1.0, 3.0, A64.shape[0], dtype=torch.float64)
    data = A64.data.clone()
    data[A64.offsets.index(0)] *= scale
    A = A64.with_data(data)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]))
    tracing.reset()
    x, res = tpu_sparse_torch.solve(A, b, method="cg", M="jacobi",
                                    precision="auto", tol=TOL)
    counts = tracing.counters()
    assert res.converged
    assert counts["refine.fused_sweeps"] == counts["refine.sweeps"] >= 1
    assert float(torch.linalg.vector_norm(b - A @ x)
                 / torch.linalg.vector_norm(b)) <= TOL
    M = mixed._cast_precond(jacobi_preconditioner(A), torch.float32)
    assert isinstance(M, DiagonalPreconditioner)
