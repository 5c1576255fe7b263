"""Which runner takes a DIA solve (``solvers/extended.py``, the one owner
of the choice for the router, ``runner``, and the refinement's sweeps,
``sweep_runner``), and the fused sweeps on the CPU.

On the card the router sends a float32 CG with no x0 and M None or
diagonal to the fused CG kernels 2-3 (``cuda_cg.fused_cg_ext``), a float32
BiCGStab with no x0 and no M to K10, the other cg / bicgstab / gmres solves
on a float32 or bf16 DIA to their loop over the extended operator, a
float64 one at tol >= 1e-11 to the loop over the fp64 extended operator; a
CWELL, another M, a complex cast, another method or a CPU tensor runs the
method on the operand. A float32 or bf16 sweep runs the fused CG kernels
for CG and the extended loop for every other named method (BiCGStab with
no M too); a float64 sweep, another operand, M or inner solver runs the
inner solver on the operand. The answers depend on the operand and one
device test (``extended._on_card``), so they are checked here without a
card by patching that test; ``refine.fused_sweeps`` counts exactly the
sweeps whose answer is the fused CG, and off the card it stays 0.

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
from tpu_sparse_torch.solvers import extended, mixed
from tpu_sparse_torch.solvers.krylov import bicgstab_full, cg_full, gmres_full
from tpu_sparse_torch.solvers.pipelined import cg_sr_full
from tpu_sparse_torch.sparse import generators as gen
from tpu_sparse_torch.sparse.containers import DIA
from tpu_sparse_torch.sparse.convert import to_csr
from tpu_sparse_torch.sparse.cwell import csr_to_cwell

TOL = 1e-8


def _f32():
    return gen.poisson3d_27pt(6, dtype=np.float32, device="cpu")


def _cast(dtype):
    return _f32().with_data(_f32().data.to(dtype))


def _jacobi(A):
    return jacobi_preconditioner(A)


_X0 = torch.zeros(216, dtype=torch.float32)

# name: (inner solver, A, b's dtype, M, inner keyword arguments, tol, x0,
# on the card): the first ten are a refinement's float32 sweeps (x0 None,
# the inner dtype as b's), the rest solves the router hands to the owner
_CASES = {
    "cg": lambda: (cg_full, _f32(), torch.float32, None, {}, 1e-5, None,
                   True),
    "cg-jacobi": lambda: (cg_full, _f32(), torch.float32, _jacobi(_f32()),
                          {}, 1e-5, None, True),
    "cg-bf16": lambda: (cg_full, _cast(torch.bfloat16), torch.bfloat16, None,
                        {}, 1e-5, None, True),
    "cg-kwargs": lambda: (cg_full, _f32(), torch.float32, None,
                          {"atol": 0.0}, 1e-5, None, True),
    "bicgstab": lambda: (bicgstab_full, _f32(), torch.float32, None, {},
                         1e-5, None, True),
    "bicgstab-jacobi": lambda: (bicgstab_full, _f32(), torch.float32,
                                _jacobi(_f32()), {}, 1e-5, None, True),
    "gmres": lambda: (gmres_full, _f32(), torch.float32, None,
                      {"restart": 20, "solve_method": "batched"}, 1e-5, None,
                      True),
    "cg-callable-M": lambda: (cg_full, _f32(), torch.float32,
                              lambda v: 0.5 * v, {}, 1e-5, None, True),
    "cg-cwell": lambda: (cg_full, csr_to_cwell(to_csr(_f32())),
                         torch.float32, None, {}, 1e-5, None, True),
    "cg-complex64": lambda: (cg_full, _cast(torch.complex64),
                             torch.complex64, None, {}, 1e-5, None, True),
    "router-cg-x0": lambda: (cg_full, _f32(), torch.float32, None, {}, 1e-6,
                             _X0, True),
    "router-bf16-f32-b": lambda: (bicgstab_full, _cast(torch.bfloat16),
                                  torch.float32, None, {}, 1e-6, None, True),
    "router-f64": lambda: (cg_full, _cast(torch.float64), torch.float64,
                           None, {}, 1e-8, None, True),
    "router-f64-tol-1e-12": lambda: (cg_full, _cast(torch.float64),
                                     torch.float64, None, {}, 1e-12, None,
                                     True),
    "router-cg_sr": lambda: (cg_sr_full, _f32(), torch.float32, None, {},
                             1e-6, None, True),
    "router-cpu": lambda: (cg_full, _f32(), torch.float32, None, {}, 1e-6,
                           None, False),
}
# the owner's answers for each case, as names: the router's (``runner``,
# with the case's x0) and a sweep's (``sweep_runner``, no x0): the fused CG
# kernels 2-3, K10, the extended loop (float32 / bf16 or fp64) or the plain
# loop. They differ for a float32 BiCGStab with no M, for cg_sr (and fcg,
# minres, fgmres) and for a float64 or x0 solve (no sweep has either).
_ROUTES = {"cg": ("fused", "fused"), "cg-jacobi": ("fused", "fused"),
           "cg-bf16": ("extended", "extended"),
           "cg-kwargs": ("fused", "fused"),
           "bicgstab": ("k10", "extended"),
           "bicgstab-jacobi": ("extended", "extended"),
           "gmres": ("extended", "extended"),
           "cg-callable-M": ("plain", "plain"),
           "cg-cwell": ("plain", "plain"),
           "cg-complex64": ("plain", "plain"),
           "router-cg-x0": ("extended", "fused"),
           "router-bf16-f32-b": ("extended", "extended"),
           "router-f64": ("extended-f64", "plain"),
           "router-f64-tol-1e-12": ("plain", "plain"),
           "router-cg_sr": ("plain", "extended"),
           "router-cpu": ("plain", "plain")}


def _on_card_for_dia(monkeypatch):
    """Route a CPU DIA as a card's: the runners' plain versions."""
    monkeypatch.setattr(extended, "_on_card",
                        lambda A, b: isinstance(A, DIA))


def _route(method, A, b, M, tol, x0) -> str:
    run = extended.runner(method, A, b, M, tol)
    if run is None:
        return "plain"
    if run is extended.ext_run_f64:
        return "extended-f64"
    assert run is extended.ext_run
    if extended._fused(method, A, x0, M):
        return {"cg": "fused", "bicgstab": "k10"}[method]
    return "extended"


def _sweep_route(inner, A, b, M) -> str:
    run, fused = extended.sweep_runner(inner, A, b, M)
    assert fused is (run is extended.ext_run)
    return {None: "plain", extended.ext_run: "fused",
            extended.ext_loop: "extended"}[run]


@pytest.mark.parametrize("case", list(_CASES))
def test_route_of_a_solve(monkeypatch, case):
    """The owner's answers for each solve; off the card every answer is
    the plain loop, and no sweep is fused."""
    inner, A, dtype, M, kw, tol, x0, card = _CASES[case]()
    method = mixed._method_name(inner)
    b = torch.ones(A.shape[0], dtype=dtype)

    def routes():
        return (_route(method, A, b, M, tol, x0),
                _sweep_route(inner, A, b, M))

    assert routes() == ("plain", "plain")
    if card:
        _on_card_for_dia(monkeypatch)
    assert routes() == _ROUTES[case]


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
