"""HPCG's 27-point problem in float64 through ``solve()`` on the CPU, held
to the benchmark's plain reference (``benchmark/reference/hpcg.py``): the
two float64 routes of the benchmark's fp64 cells, ``precision="auto"``
(defect correction: float32 CG sweeps, float64 residuals) and
``precision="full"`` (float64 CG), at 12^3 and 16^3 on the benchmark's own
diagonals (``benchmark.core.stencil.diagonals``). No JAX.

Tolerances, each with its reason:

* the true relative residual, in float64 by the reference, at most the
  solve's tol 1e-8: the configuration's guarantee;
* full: x within 1e-12 of the reference CG's x, relative in norm: the same
  CG recurrence in float64 from x0 = 0, apart only in the order of sums;
  iterations within 1 of the reference's (a residual that lands on the
  threshold may cross it one iteration apart);
* auto: x within 1e-6 of the reference's: another algorithm, so each x is
  only as near the exact solution as its residual allows, ||x - x*|| /
  ||x*|| <= cond(A) * 1e-8, and cond(A) < 40 at these grids (eigenvalues
  26 - prod_d (1 + 2 cos(k_d pi / (m + 1))) + 1 lie in [0.9, 35.5] at
  m = 16), so the two differ by at most 2 * 40 * 1e-8;
* a sign and a power-of-two scale of b: the same iterations and the same
  ``refine.sweeps``, and x scaled exactly: every step of either route is
  linear in b and such a scale is exact in float32 and float64 (the fp64
  mixes' ``base_seed`` pools rely on it).
"""

import pytest
import torch
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

import tpu_sparse_torch
from benchmark.core import stencil
from benchmark.reference import hpcg as ref
from tpu_sparse_torch import tracing

TOL = 1e-8
MAXITER = 1000


def _system(nx: int, seed: int):
    data, offsets = stencil.diagonals([nx] * 3, 26.0, -1.0, torch.float64,
                                      "cpu")
    n = data.shape[1]
    b, = stencil.rhs_pool(data, offsets, 1, 1, seed, None)
    return tpu_sparse_torch.DIA(data, offsets, (n, n)), data, offsets, b


def _solve(A, b, precision):
    """(x, result, refine.sweeps over the solve)."""
    before = tracing.counters().get("refine.sweeps", 0)
    x, res = tpu_sparse_torch.solve(A, b, method="cg", precision=precision,
                                    tol=TOL, maxiter=MAXITER)
    assert res.converged
    return x, res, tracing.counters()["refine.sweeps"] - before


@pytest.mark.parametrize("precision", ["auto", "full"])
@pytest.mark.parametrize("nx", [12, 16])
def test_fp64_routes_against_the_reference(nx, precision):
    A, data, offsets, b = _system(nx, 2147483701 + nx)
    x, res, sweeps = _solve(A, b, precision)
    x_ref, it_ref, conv_ref = ref.cg(data, offsets, b, TOL, MAXITER)
    assert conv_ref
    assert max(ref.rel_residuals(data, offsets, x, b)) <= TOL
    err = float(torch.linalg.vector_norm(x - x_ref)
                / torch.linalg.vector_norm(x_ref))
    if precision == "full":
        assert sweeps == 0
        assert abs(res.iterations - it_ref) <= 1
        assert err <= 1e-12
    else:
        assert 1 <= sweeps <= 3
        assert err <= 1e-6


@pytest.mark.parametrize("precision", ["auto", "full"])
@pytest.mark.parametrize("nx", [12, 16])
def test_sign_and_power_of_two_scale_send_the_same_work(nx, precision):
    A, _, _, b = _system(nx, 7 * nx)
    x, res, sweeps = _solve(A, b, precision)
    for factor in (-1.0, 0.25, 4.0, -2.0):
        xf, resf, sweepsf = _solve(A, b * factor, precision)
        assert resf.iterations == res.iterations
        assert sweepsf == sweeps
        assert torch.equal(xf, x * factor)
