"""tpu_sparse_torch CG and defect-correction refinement against the JAX
package on the CPU, from the same numpy inputs.

Tolerances: float64 CG takes the same iterations and info, x rtol 1e-10
(both run the same recurrence; only dot-product summation order differs);
the mixed-precision path (f32 inner sweeps) agrees within 2 inner
iterations and x rtol 1e-8 relative to ||x||.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_sparse.precond.jacobi import jacobi_preconditioner as jjacobi
from tpu_sparse.solvers import cg_full as jcg_full
from tpu_sparse.solvers import cg_refined as jcg_refined
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner as tjacobi
from tpu_sparse_torch.solvers import krylov
from tpu_sparse_torch.solvers import cg as tcg
from tpu_sparse_torch.solvers import cg_full as tcg_full
from tpu_sparse_torch.solvers import cg_refined as tcg_refined
from tpu_sparse_torch.sparse.convert import dia_from_numpy
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

MATRICES = {
    "tridiagonal100": lambda: jgen.tridiagonal(100),
    "poisson2d16": lambda: jgen.poisson2d(16),
}


def _system(name, seed=0):
    Aj = MATRICES[name]()
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                        device="cpu")
    b = np.random.default_rng(seed).standard_normal(Aj.shape[0])
    return Aj, At, b


def _assert_same_solve(out_j, out_t, rtol):
    xj, ij, kj, _ = out_j
    xt, it, kt, _ = out_t
    assert int(it) == int(ij)
    assert int(kt) == int(kj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(xj))))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("jacobi", [False, True])
def test_cg_full_f64_matches_jax(name, jacobi):
    Aj, At, b = _system(name)
    Mj = jjacobi(Aj) if jacobi else None
    Mt = tjacobi(At) if jacobi else None
    out_j = jcg_full(Aj, jnp.asarray(b), tol=1e-10, maxiter=2000, M=Mj)
    out_t = tcg_full(At, torch.from_numpy(b), tol=1e-10, maxiter=2000, M=Mt)
    assert int(out_t[1]) == 0
    _assert_same_solve(out_j, out_t, 1e-10)


@pytest.mark.parametrize("maxiter", [5, 16, 37])
def test_cg_full_maxiter_stop_matches_jax(maxiter):
    """Stopping at maxiter (not a multiple of the host-check interval)
    counts the same iterations and reports info -1 like the JAX loop."""
    Aj, At, b = _system("poisson2d16", seed=1)
    out_j = jcg_full(Aj, jnp.asarray(b), tol=1e-12, maxiter=maxiter)
    out_t = tcg_full(At, torch.from_numpy(b), tol=1e-12, maxiter=maxiter)
    assert int(out_t[1]) == -1 and int(out_t[2]) == maxiter
    _assert_same_solve(out_j, out_t, 1e-10)


def test_cg_full_x0_and_atol_match_jax():
    Aj, At, b = _system("tridiagonal100", seed=2)
    x0 = np.random.default_rng(3).standard_normal(b.shape[0])
    out_j = jcg_full(Aj, jnp.asarray(b), jnp.asarray(x0), tol=0.0,
                     atol=1e-6, maxiter=500)
    out_t = tcg_full(At, torch.from_numpy(b), torch.from_numpy(x0), tol=0.0,
                     atol=1e-6, maxiter=500)
    _assert_same_solve(out_j, out_t, 1e-10)


def test_cg_on_pytree_operands():
    """Tuple operands: two independent systems solved as one."""
    _, A1, b1 = _system("tridiagonal100", seed=4)
    _, A2, b2 = _system("poisson2d16", seed=5)

    def mv(v):
        return (A1 @ v[0], A2 @ v[1])

    b = (torch.from_numpy(b1), torch.from_numpy(b2))
    x, info = tcg(mv, b, tol=1e-10, maxiter=2000)
    assert int(info) == 0
    for A, xi, bi in ((A1, x[0], b[0]), (A2, x[1], b[1])):
        assert float(torch.linalg.vector_norm(A @ xi - bi)) <= \
            1e-9 * float(torch.linalg.vector_norm(bi)) * 10


def test_cg_full_flags_non_finite_rhs():
    _, At, b = _system("tridiagonal100")
    b[3] = np.nan
    _, info, _, _ = tcg_full(At, torch.from_numpy(b), tol=1e-8)
    assert int(info) == -1
    assert krylov._final_check_relax(torch.float32) == 10.0
    assert krylov._final_check_relax(torch.float64) == 1.0


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("jacobi", [False, True])
def test_cg_refined_matches_jax(name, jacobi):
    Aj, At, b = _system(name, seed=6)
    Mj = jjacobi(Aj) if jacobi else None
    Mt = tjacobi(At) if jacobi else None
    xj, ij, kj, rj = jcg_refined(Aj, jnp.asarray(b), tol=1e-10, M=Mj)
    xt, it, kt, rt = tcg_refined(At, torch.from_numpy(b), tol=1e-10, M=Mt)
    assert int(it) == int(ij) == 0
    assert abs(int(kt) - int(kj)) <= 2, (int(kt), int(kj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8,
                               atol=1e-8 * float(np.max(np.abs(xj))))
    assert float(rt) <= 1e-10 * float(np.linalg.norm(b))


@pytest.mark.parametrize("method,kw", [
    ("gmres", dict(solve_method="batched")),
    ("gmres", dict(solve_method="incremental")), ("fgmres", {})])
@pytest.mark.parametrize("cols", [None, 2])
def test_bf16_gmres_least_squares_in_float32(method, kw, cols):
    """torch has no bf16 QR or triangular solve: a bf16 GMRES / FGMRES
    cycle solves its least squares in float32 and rounds y to bf16
    (single and batched), where it raised NotImplementedError."""
    import tpu_sparse_torch

    A = jgen.poisson2d(8, dtype=np.float32)
    At = dia_from_numpy(np.asarray(A.data), A.offsets, A.shape,
                        device="cpu")
    At = At.with_data(At.data.to(torch.bfloat16))
    rng = np.random.default_rng(7)
    shape = (64,) if cols is None else (64, cols)
    b = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
    x, res = tpu_sparse_torch.solve(At, b, method=method, tol=1e-2,
                                    maxiter=200, **kw)
    assert x.dtype == torch.bfloat16 and x.shape == b.shape
    assert res.converged
    r = b.float() - torch.from_numpy(np.array(A.todense())) @ x.float()
    assert float(torch.linalg.vector_norm(r, dim=0).max()
                 / torch.linalg.vector_norm(b.float(), dim=0).min()) <= 0.1
