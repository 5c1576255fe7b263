"""The adjoint gradient of tpu_sparse_torch's solves against the JAX
package's ``*_diff`` on the CPU, from the same numpy inputs, and the
refusals outside the slice.

Tolerances: float64 gradients with respect to b and to A's values rtol 1e-6
against ``jax.grad`` (both take one adjoint solve at tol 1e-12 of the same
recurrence); the float32 extended paths (fused CG, K10 on A^T) rtol 1e-3
against the exact float64 gradient (solves at tol 1e-6 in float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_sparse
from tpu_sparse.autodiff import bicgstab_diff as jbicgstab_diff
from tpu_sparse.autodiff import cg_diff as jcg_diff
from tpu_sparse.autodiff import gmres_diff as jgmres_diff
from tpu_sparse.precond.jacobi import jacobi_preconditioner as jjacobi
from tpu_sparse.sparse import convert as jconvert
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.autodiff import implicit
from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner as tjacobi
from tpu_sparse_torch.sparse import convert as tconvert
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

DIFF = {"cg": (jcg_diff, implicit.cg_diff),
        "bicgstab": (jbicgstab_diff, implicit.bicgstab_diff),
        "gmres": (jgmres_diff, implicit.gmres_diff)}


def _operands(method, fmt):
    """The same system in both packages: SPD for cg, nonsymmetric for
    bicgstab and gmres; as DIA, CSR or a dense matrix."""
    Aj = jgen.poisson2d(6) if method == "cg" else \
        jgen.convection_diffusion_3d_27pt(4, dtype=np.float64)
    At = tconvert.dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                                 device="cpu")
    if fmt == "csr":
        return jconvert.to_csr(Aj), tconvert.to_csr(At)
    if fmt == "dense":
        return Aj.todense(), At.todense()
    return Aj, At


def _values_j(A):
    return A if isinstance(A, jax.Array) else A.data


def _grads_jax(fn, Aj, b, w, **kw):
    def loss(vals, bb):
        A_ = vals if isinstance(Aj, jax.Array) else Aj.with_data(vals)
        return jnp.dot(jnp.asarray(w), fn(A_, bb, **kw)[0])

    gA, gb = jax.grad(loss, argnums=(0, 1))(_values_j(Aj), jnp.asarray(b))
    return np.asarray(gA), np.asarray(gb)


def _grads_torch(fn, At, b, w, **kw):
    vals = (At if isinstance(At, torch.Tensor) else At.data).clone()
    vals.requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    A_ = vals if isinstance(At, torch.Tensor) else At.with_data(vals)
    x = fn(A_, bt, **kw)[0]
    (x * torch.from_numpy(w)).sum().backward()
    return vals.grad.numpy(), bt.grad.numpy()


@pytest.mark.parametrize("fmt", ["dia", "csr", "dense"])
@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_adjoint_gradients_match_jax(method, fmt):
    Aj, At = _operands(method, fmt)
    n = At.shape[0]
    rng = np.random.default_rng(3)
    b, w = rng.standard_normal(n), rng.standard_normal(n)
    jf, tf = DIFF[method]
    kw = dict(tol=1e-12, maxiter=500)
    gAj, gbj = _grads_jax(jf, Aj, b, w, **kw)
    gAt, gbt = _grads_torch(tf, At, b, w, **kw)
    np.testing.assert_allclose(gbt, gbj, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(gbj)))
    np.testing.assert_allclose(gAt, gAj, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(gAj)))


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_adjoint_with_jacobi_matches_jax(method):
    """cg reuses M in its adjoint solve; bicgstab solves A^T v = x_bar
    without M. x0 and M get no gradient."""
    Aj, At = _operands(method, "dia")
    n = At.shape[0]
    rng = np.random.default_rng(4)
    b, w = rng.standard_normal(n), rng.standard_normal(n)
    jf, tf = DIFF[method]
    x0 = rng.standard_normal(n)
    gAj, gbj = _grads_jax(jf, Aj, b, w, tol=1e-12, M=jjacobi(Aj),
                          x0=jnp.asarray(x0))
    x0t = torch.from_numpy(x0).requires_grad_()
    gAt, gbt = _grads_torch(tf, At, b, w, tol=1e-12, M=tjacobi(At), x0=x0t)
    assert x0t.grad is None
    np.testing.assert_allclose(gbt, gbj, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(gbj)))
    np.testing.assert_allclose(gAt, gAj, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(gAj)))


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_extended_paths_differentiate_like_the_dense_adjoint(method):
    """ext_krylov_diff (float32: fused CG, K10 forward and on A^T, GMRES
    over the extended operator; plain kernel versions on CPU tensors) and
    ext_krylov_diff_f64 against the exact gradient of x = A^-1 b."""
    Aj, At = _operands(method, "dia")
    n = At.shape[0]
    rng = np.random.default_rng(5)
    b, w = rng.standard_normal(n), rng.standard_normal(n)
    dense = At.todense()
    x = torch.linalg.solve(dense, torch.from_numpy(b))
    v = torch.linalg.solve(dense.T, torch.from_numpy(w))
    pattern = At.with_data(torch.ones_like(At.data)).todense()
    for run, dtype, tol, rtol in (
            (implicit.ext_krylov_diff, torch.float32, 1e-6, 1e-3),
            (implicit.ext_krylov_diff_f64, torch.float64, 1e-12, 1e-8)):
        data = At.data.to(dtype).requires_grad_()
        bt = torch.from_numpy(b).to(dtype).requires_grad_()
        kw = dict(tol=tol, atol=0.0, maxiter=None)
        xt, info, _, _ = run(method, kw, At.with_data(data), bt, None, None)
        assert int(info) == 0
        (xt * torch.from_numpy(w).to(dtype)).sum().backward()
        torch.testing.assert_close(bt.grad.double(), v, rtol=rtol,
                                   atol=rtol * float(v.abs().max()))
        gA = At.with_data(data.grad.double()).todense()
        want = -torch.outer(v, x) * pattern
        torch.testing.assert_close(gA, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()))


def test_mixed_path_refuses_gradients_like_jax():
    """Neither package differentiates the defect-correction path: JAX
    cannot reverse its loops, the port refuses up front."""
    Aj = jgen.poisson2d(6)
    At = tconvert.dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                                 device="cpu")
    b = np.ones(36)
    with pytest.raises(ValueError, match="Reverse-mode"):
        jax.grad(lambda bb: tpu_sparse.solve(
            Aj, bb, precision="mixed", tol=1e-8)[0].sum())(jnp.asarray(b))
    import tpu_sparse_torch

    for method in ("cg", "bicgstab", "gmres"):
        with pytest.raises(ValueError, match="not differentiable"):
            tpu_sparse_torch.solve(
                At.with_data(At.data.clone().requires_grad_()),
                torch.from_numpy(b), method=method, precision="mixed",
                tol=1e-8)


def test_callable_operands_are_forward_only():
    """A matrix-free callable solves to the same x with and without
    autograd, and (since the callable adjoint) its b.grad is the matrix
    operand's."""
    At = tconvert.dia_from_numpy(np.asarray(jgen.tridiagonal(30).data),
                                 (-1, 0, 1), (30, 30), device="cpu")
    b = torch.ones(30, dtype=torch.float64)
    for method in ("cg", "bicgstab", "gmres"):
        fn = DIFF[method][1]
        bg = b.clone().requires_grad_()
        x_g = fn(lambda v: At @ v, bg, tol=1e-10)[0]
        x_g.sum().backward()
        bm = b.clone().requires_grad_()
        fn(At, bm, tol=1e-10)[0].sum().backward()
        torch.testing.assert_close(bg.grad, bm.grad, rtol=1e-8, atol=1e-12)
        x, info, _, _ = fn(lambda v: At @ v, b, tol=1e-10)
        with torch.no_grad():
            x_ng, _, _, _ = fn(lambda v: At @ v, b.clone().requires_grad_(),
                               tol=1e-10)
        assert int(info) == 0 and torch.equal(x, x_ng)
        assert torch.equal(x_g.detach(), x)
