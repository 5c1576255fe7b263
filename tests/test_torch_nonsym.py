"""tpu_sparse_torch BiCGStab and GMRES (and their defect-correction
refinements) against the JAX package on the CPU, from the same numpy inputs.

Tolerances: float64 solves take the same iterations (BiCGStab) or restart
cycles (GMRES) and the same info, x rtol 1e-8 relative to max|x| (both run
the same recurrence; only summation order differs). float32 GMRES: cycles
within 1, x rtol 1e-4. Refined solves (f32 inner sweeps): info equal, x
rtol 1e-8, inner counts within 2 (f32 dot products summed in another
order shift an inner sweep's stop by an iteration).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_sparse.precond.jacobi import jacobi_preconditioner as jjacobi
from tpu_sparse.solvers import bicgstab_full as jbicgstab_full
from tpu_sparse.solvers import bicgstab_refined as jbicgstab_refined
from tpu_sparse.solvers import gmres_full as jgmres_full
from tpu_sparse.solvers import gmres_refined as jgmres_refined
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner as tjacobi
from tpu_sparse_torch.solvers import bicgstab, gmres
from tpu_sparse_torch.solvers import bicgstab_full as tbicgstab_full
from tpu_sparse_torch.solvers import bicgstab_refined as tbicgstab_refined
from tpu_sparse_torch.solvers import gmres_full as tgmres_full
from tpu_sparse_torch.solvers import gmres_refined as tgmres_refined
from tpu_sparse_torch.sparse.convert import dia_from_numpy
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


def _skewed_poisson2d(nx, dtype=np.float64):
    """The upwind-skewed 2-D Poisson of tests/test_fused_bicgstab.py."""
    A = jgen.poisson2d(nx, dtype=dtype)
    data = np.array(A.data)
    offs = list(A.offsets)
    data[offs.index(-1)] *= 1.3
    data[offs.index(1)] *= 0.7
    return A.with_data(jnp.asarray(data))


MATRICES = {
    "convection_diffusion200": lambda dt: jgen.convection_diffusion(
        200, dtype=dt),
    "skewed_poisson2d24": lambda dt: _skewed_poisson2d(24, dt),
}


def _system(name, dtype=np.float64, seed=0):
    Aj = MATRICES[name](dtype)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                        device="cpu")
    b = np.random.default_rng(seed).standard_normal(Aj.shape[0]).astype(
        dtype)
    return Aj, At, b


def _assert_same(out_j, out_t, rtol, slack=0):
    xj, ij, kj, _ = out_j
    xt, it, kt, _ = out_t
    assert int(it) == int(ij)
    assert abs(int(kt) - int(kj)) <= slack, (int(kt), int(kj))
    assert xt.numpy().dtype == np.asarray(xj).dtype
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(xj))))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("jacobi", [False, True])
def test_bicgstab_full_f64_matches_jax(name, jacobi):
    Aj, At, b = _system(name)
    Mj = jjacobi(Aj) if jacobi else None
    Mt = tjacobi(At) if jacobi else None
    out_j = jbicgstab_full(Aj, jnp.asarray(b), tol=1e-10, maxiter=2000, M=Mj)
    out_t = tbicgstab_full(At, torch.from_numpy(b), tol=1e-10, maxiter=2000,
                           M=Mt)
    assert int(out_t[1]) == 0
    _assert_same(out_j, out_t, 1e-8)


@pytest.mark.parametrize("maxiter", [5, 16, 37])
def test_bicgstab_full_maxiter_stop_matches_jax(maxiter):
    """Stopping at maxiter (not a multiple of the host-check interval)
    counts the same iterations and reports info -1 like the JAX loop."""
    Aj, At, b = _system("skewed_poisson2d24", seed=1)
    out_j = jbicgstab_full(Aj, jnp.asarray(b), tol=1e-14, maxiter=maxiter)
    out_t = tbicgstab_full(At, torch.from_numpy(b), tol=1e-14,
                           maxiter=maxiter)
    assert int(out_t[1]) == -1 and int(out_t[2]) == maxiter
    _assert_same(out_j, out_t, 1e-8)


@pytest.mark.parametrize("A,b,code", [
    ([[0.0, 2.0, 2.0], [1.0, 1.0, 2.0], [1.0, -1.0, -2.0]],
     [0.0, -1.0, 0.0], -10),
    ([[2.0, 1.0], [0.0, -1.0]], [-1.0, -2.0], -11),
])
def test_bicgstab_breakdown_codes_match_jax(A, b, code):
    A, b = np.array(A), np.array(b)
    _, ij, kj, _ = jbicgstab_full(jnp.asarray(A), jnp.asarray(b), tol=1e-10,
                                  maxiter=50)
    x, it, kt, _ = tbicgstab_full(torch.from_numpy(A), torch.from_numpy(b),
                                  tol=1e-10, maxiter=50)
    assert int(ij) == int(it) == code
    assert int(kj) == int(kt) == code
    assert int(bicgstab(torch.from_numpy(A), torch.from_numpy(b), tol=1e-10,
                        maxiter=50)[1]) == code


def test_bicgstab_flags_non_finite_rhs():
    _, At, b = _system("convection_diffusion200")
    b[3] = np.inf
    _, info, _, _ = tbicgstab_full(At, torch.from_numpy(b), tol=1e-8)
    assert int(info) == -1


@pytest.mark.parametrize("solve_method", ["batched", "incremental"])
@pytest.mark.parametrize("restart", [5, 20])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gmres_full_f64_matches_jax(name, restart, solve_method):
    Aj, At, b = _system(name, seed=2)
    Mj, Mt = jjacobi(Aj), tjacobi(At)
    kw = dict(tol=1e-10, restart=restart, maxiter=500,
              solve_method=solve_method)
    out_j = jgmres_full(Aj, jnp.asarray(b), M=Mj, **kw)
    out_t = tgmres_full(At, torch.from_numpy(b), M=Mt, **kw)
    assert int(out_t[1]) == 0
    _assert_same(out_j, out_t, 1e-8)


@pytest.mark.parametrize("solve_method", ["batched", "incremental"])
def test_gmres_restart_above_n_is_clamped(solve_method):
    Aj = jgen.convection_diffusion(30)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                        device="cpu")
    b = np.random.default_rng(3).standard_normal(30)
    kw = dict(tol=1e-10, restart=50, maxiter=20, solve_method=solve_method)
    out_j = jgmres_full(Aj, jnp.asarray(b), **kw)
    out_t = tgmres_full(At, torch.from_numpy(b), **kw)
    assert int(out_t[1]) == 0 and int(out_t[2]) == 1
    _assert_same(out_j, out_t, 1e-8)
    x, info = gmres(At, torch.from_numpy(b), **kw)
    assert int(info) == 0 and torch.equal(x, out_t[0])


@pytest.mark.parametrize("solve_method", ["batched", "incremental"])
def test_gmres_full_f32_matches_jax(solve_method):
    Aj, At, b = _system("skewed_poisson2d24", np.float32, seed=4)
    kw = dict(tol=1e-5, restart=20, maxiter=200, solve_method=solve_method)
    out_j = jgmres_full(Aj, jnp.asarray(b), **kw)
    out_t = tgmres_full(At, torch.from_numpy(b), **kw)
    assert int(out_t[1]) == 0
    _assert_same(out_j, out_t, 1e-4, slack=1)


def test_gmres_on_pytree_operands():
    """A tuple operand: two independent systems solved as one."""
    _, A1, b1 = _system("convection_diffusion200", seed=5)
    _, A2, b2 = _system("skewed_poisson2d24", seed=6)

    def mv(v):
        return (A1 @ v[0], A2 @ v[1])

    b = (torch.from_numpy(b1), torch.from_numpy(b2))
    x, info = gmres(mv, b, tol=1e-10, restart=30, maxiter=100)
    assert int(info) == 0
    for A, xi, bi in ((A1, x[0], b[0]), (A2, x[1], b[1])):
        assert xi.shape == bi.shape
        assert float(torch.linalg.vector_norm(A @ xi - bi)) <= \
            1e-9 * float(torch.linalg.vector_norm(bi)) * 10


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_refined_matches_jax(method):
    Aj, At, b = _system("convection_diffusion200", seed=7)
    jf, tf = {"bicgstab": (jbicgstab_refined, tbicgstab_refined),
              "gmres": (jgmres_refined, tgmres_refined)}[method]
    xj, ij, kj, _ = jf(Aj, jnp.asarray(b), tol=1e-10)
    xt, it, kt, rt = tf(At, torch.from_numpy(b), tol=1e-10)
    assert int(it) == int(ij) == 0
    assert abs(int(kt) - int(kj)) <= 2, (int(kt), int(kj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8,
                               atol=1e-8 * float(np.max(np.abs(xj))))
    assert float(rt) <= 1e-10 * float(np.linalg.norm(b))


def test_gmres_refined_adaptive_restart_matches_jax():
    """n <= 1024 raises the restart to n (full GMRES, one cycle per
    sweep), in both packages; adaptive_restart=False keeps restart 5."""
    Aj, At, b = _system("skewed_poisson2d24", seed=8)
    for adaptive in (True, False):
        kw = dict(tol=1e-10, restart=5, adaptive_restart=adaptive)
        xj, ij, kj, _ = jgmres_refined(Aj, jnp.asarray(b), **kw)
        xt, it, kt, _ = tgmres_refined(At, torch.from_numpy(b), **kw)
        assert int(it) == int(ij) == 0
        assert abs(int(kt) - int(kj)) <= 2, (adaptive, int(kt), int(kj))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8,
                                   atol=1e-8 * float(np.max(np.abs(xj))))
