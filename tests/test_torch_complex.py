"""tpu_sparse_torch on complex64 / complex128 operands against the JAX
package (which solves complex systems natively off the TPU), scipy and
torch autograd, on the CPU, from the same numpy inputs.

* JAX's own complex cases (``tests/test_batched_complex.py``): CG on a
  Hermitian dense matrix, GMRES on a dense one, BiCGStab on a CSR, MINRES
  on a Hermitian indefinite matrix, block CG on an HPD one and the router
  with three right-hand sides. ``converged`` and the iterations are JAX's,
  x within 1e-10 of max|x| (the same recurrences; only summation orders
  differ). MINRES within one iteration: its stopping estimate falls
  through tol ||b|| at JAX's last iteration within rounding (both end with
  true residuals below tol, JAX 9.1e-11, the port 9.4e-12).
* The complex ILU(0) factor against JAX's ``ilu0_factor``: within 1e-13
  of max|L|, max|U| in complex128 and 1e-5 in complex64 (the host factor
  divides by std::complex's quotient, XLA by its own); an apply within
  1e-12 of max|y|.
* ``SupernodalLU.factor`` on complex CPU tensors against scipy's ``splu``
  in complex128: x within 1e-10 of max|x| on poisson2d(70) (1 + 0.3i) +
  0.1 triu (n = 4,900); the banded and dense direct solvers (Thomas, PCR,
  block PCR, banded LU, dense) keep complex, x within 1e-10 of numpy's.
* R12: a complex mixed-precision solve runs its inner sweeps on a
  complex64 operator (and M) and converges to tol. JAX's inner sweeps
  drop the imaginary part, so its iteration count is no reference.
* R13: gradients in b and A's values through cg, gmres, bicgstab and
  minres (DIA, CWELL and dense operands) against torch autograd through
  ``torch.linalg.solve`` of the dense matrix, within 1e-8 of the largest
  entry (solves at tol 1e-12). JAX's gradient conjugates A^T where its
  VJP convention wants the plain transpose (ROADMAP R13): it is no
  reference.
* A real matrix with a complex b: the operand is cast once per solve (none
  again for the same matrix), and x equals the solve with the matrix cast
  by hand, bit for bit.
* The ``*_from_numpy`` carriers keep complex64 and complex128; the plain
  kernels compute the complex product (against numpy's dense product,
  1e-12 / 1e-5 of max|y|); the complex kernel wrappers refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

import tpu_sparse
import tpu_sparse.solvers as js
import tpu_sparse_torch
from tpu_sparse import precond as jpre
from tpu_sparse.sparse import containers as jcont
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import dense_to_csr as jdense_to_csr
from tpu_sparse_torch import kernels as tk
from tpu_sparse_torch import precond as tpre
from tpu_sparse_torch import solvers as ts
from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import cuda_bell, cuda_cwell, cuda_spmv
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse.cwell import csr_to_cwell
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _crand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ---- JAX's complex cases (tests/test_batched_complex.py) -----------------

def _hermitian_dense(n, seed=0):
    rng = np.random.default_rng(seed)
    B = _crand(rng, (n, n))
    return B @ B.conj().T + n * np.eye(n)


def _case(name):
    """(system, right-hand side, solver name, keyword arguments) of one of
    JAX's cases; the system is a dense array or a CSR (``"csr"``)."""
    if name == "cg_hermitian":
        A = _hermitian_dense(24)
        rng = np.random.default_rng(3)
        return A, A @ _crand(rng, 24), "cg_full", dict(tol=1e-12)
    if name == "gmres_dense":
        rng = np.random.default_rng(4)
        A = _crand(rng, (24, 24)) + 4 * 24 * np.eye(24)
        return A, A @ _crand(rng, 24), "gmres_full", dict(tol=1e-12,
                                                         restart=24)
    if name == "bicgstab_csr":
        rng = np.random.default_rng(5)
        A = _crand(rng, (32, 32))
        A[np.abs(A) < 1.0] = 0
        A += 4 * 32 * np.eye(32)
        return ("csr", A), A @ _crand(rng, 32), "bicgstab_full", dict(
            tol=1e-12)
    if name == "minres_indefinite":
        rng = np.random.default_rng(60)
        Q = _crand(rng, (48, 48))
        H = (Q + Q.conj().T) / 2
        H = H - 0.5 * np.trace(H).real / 48 * np.eye(48)
        return H, H @ _crand(rng, 48), "minres_full", dict(tol=1e-10,
                                                          maxiter=2000)
    if name == "block_cg_hpd":
        rng = np.random.default_rng(61)
        Q = _crand(rng, (40, 40))
        H = Q @ Q.conj().T / 40 + 2 * np.eye(40)
        return H, H @ _crand(rng, (40, 3)), "block_cg", dict(tol=1e-10)
    raise KeyError(name)


JAX_CASES = ("cg_hermitian", "gmres_dense", "bicgstab_csr",
             "minres_indefinite", "block_cg_hpd")


@pytest.mark.parametrize("name", JAX_CASES)
def test_jax_complex_cases_match_jax(name):
    A, b, fn, kw = _case(name)
    if isinstance(A, tuple):
        Aj = jdense_to_csr(A[1])
        At = tconvert.dense_to_csr(torch.from_numpy(A[1]))
        dense = A[1]
    else:
        Aj, At, dense = jnp.asarray(A), torch.from_numpy(A), A
    xj, ij, itj, _ = getattr(js, fn)(Aj, jnp.asarray(b), **kw)
    xt, it_, itt, _ = getattr(ts, fn)(At, torch.from_numpy(b), **kw)
    assert xt.dtype == torch.complex128
    assert np.all(np.asarray(ij) == 0) and bool(torch.all(it_ == 0))
    slack = 1 if fn == "minres_full" else 0
    assert abs(int(np.max(np.asarray(itj))) - int(torch.max(itt))) <= slack
    assert _rel(xt.numpy(), xj) <= 1e-10
    np.testing.assert_allclose(dense @ xt.numpy(), b, rtol=1e-6, atol=1e-7)


def test_router_complex_multirhs_matches_jax():
    """JAX's ``test_complex_multirhs_router``: a complex tridiagonal system
    with three right-hand sides through solve(method='gmres')."""
    n, k = 64, 3
    rng = np.random.default_rng(6)
    data = np.asarray(jgen.tridiagonal(n, dtype=np.float64).data)
    Ad = (np.diag(data[1] + 0.3j) + np.diag(data[0][1:], -1)
          + np.diag(data[2][:-1], 1))
    Xt = _crand(rng, (n, k))
    B = Ad @ Xt
    Xj, rj = tpu_sparse.solve(jnp.asarray(Ad), jnp.asarray(B),
                              method="gmres", tol=1e-8, restart=30)
    Xp, rp = tpu_sparse_torch.solve(torch.from_numpy(Ad),
                                    torch.from_numpy(B), method="gmres",
                                    tol=1e-8, restart=30)
    assert rj.converged and rp.converged
    assert rp.iterations == rj.iterations
    assert _rel(Xp.numpy(), np.asarray(Xj)) <= 1e-10
    assert np.linalg.norm(Xp.numpy() - Xt) / np.linalg.norm(Xt) < 1e-4


# ---- complex ILU(0) ------------------------------------------------------

def _hermitian_dia_np(A, seed=0):
    """(data, offsets, shape) of D^H A D, D = diag(exp(i theta)), theta
    uniform on [0, 2 pi) from default_rng(seed)."""
    n = A.shape[0]
    D = np.exp(1j * np.random.default_rng(seed).uniform(0, 2 * np.pi, n))
    data = np.asarray(A.data).astype(np.complex128)
    for d, o in enumerate(A.offsets):
        i = np.arange(max(0, -o), min(n, n - o))
        data[d, i] = D[i].conj() * data[d, i] * D[i + o]
    return data, A.offsets, A.shape


ILU_SYSTEMS = {
    "poisson2d_hermitian": lambda: _hermitian_dia_np(jgen.poisson2d(8)),
    "poisson3d_27pt_scaled": lambda: (
        np.asarray(jgen.poisson3d_27pt(5, dtype=np.float64).data)
        * (1 + 0.2j), jgen.poisson3d_27pt(5).offsets, (125, 125)),
    "convection_diffusion_scaled": lambda: (
        np.asarray(jgen.convection_diffusion(36).data) * (1 - 0.5j),
        jgen.convection_diffusion(36).offsets, (36, 36)),
    "zero_pivot": lambda: (
        np.asarray(jgen.tridiagonal(16, main=1.0, off=1.0).data)
        * (1 + 1j), (-1, 0, 1), (16, 16)),
}


@pytest.mark.parametrize("dtype,bound", [(np.complex128, 1e-13),
                                         (np.complex64, 1e-5)])
@pytest.mark.parametrize("name", list(ILU_SYSTEMS))
def test_complex_ilu0_factor_matches_jax(name, dtype, bound):
    data, offsets, shape = ILU_SYSTEMS[name]()
    data = data.astype(dtype)
    Lj, Uj = jpre.ilu0_factor(jcont.DIA(jnp.asarray(data), offsets, shape))
    A = tconvert.dia_from_numpy(data, offsets, shape, device="cpu")
    Lt, Ut = tpre.ilu0_factor(A)
    assert Lt.dtype == Ut.dtype == A.dtype
    assert Lt.offsets == Lj.offsets and Ut.offsets == Uj.offsets
    assert _rel(Lt.data.numpy(), np.asarray(Lj.data)) <= bound
    assert _rel(Ut.data.numpy(), np.asarray(Uj.data)) <= bound
    if dtype == np.complex128:
        v = _crand(np.random.default_rng(1), shape[0])
        yj = jpre.ilu0_preconditioner(jcont.DIA(jnp.asarray(data), offsets,
                                                shape))(jnp.asarray(v))
        yt = tpre.ilu0_preconditioner(A)(torch.from_numpy(v))
        assert _rel(yt.numpy(), np.asarray(yj)) <= 1e-12


# ---- the complex supernodal LU -------------------------------------------

def test_complex_supernodal_factor_matches_splu():
    """The factors keep the imaginary parts: x within 1e-10 of scipy's
    complex128 SuperLU solve (the float64 cast gave an error of 48.5)."""
    from tpu_sparse_torch.direct import SupernodalLU

    S = tconvert.to_scipy_csr(tpu_sparse_torch.sparse.generators.poisson2d(
        70, dtype=np.float64, device="cpu"))
    S = (S * (1 + 0.3j) + 0.1 * sp.triu(S, k=1)).tocsr()
    S.sort_indices()
    A = tconvert.csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                                 device="cpu")
    b = _crand(np.random.default_rng(2), S.shape[0])
    lu = SupernodalLU.factor(A)
    assert lu.diagL.dtype == torch.complex128
    x = lu.solve(torch.from_numpy(b))
    xs = spl.splu(S.tocsc()).solve(b)
    assert x.dtype == torch.complex128
    assert _rel(x.numpy(), xs) <= 1e-10
    # the adjoint solve: A^T x = b by the same factors
    xt = lu.solve_transpose(torch.from_numpy(b))
    assert _rel(xt.numpy(), spl.splu(S.T.tocsc()).solve(b)) <= 1e-10


@pytest.mark.parametrize("name", ["thomas_solve", "pcr_solve",
                                  "block_pcr_solve", "banded_lu_solve",
                                  "dense_solve"])
def test_complex_banded_and_dense_solvers_keep_complex(name):
    """The direct solvers of banded and dense systems (PCR and block PCR
    are the card's torch-op paths) on complex128: x within 1e-10 of
    numpy's dense solve."""
    from tpu_sparse_torch import direct

    rng = np.random.default_rng(10)
    tri = name in ("thomas_solve", "pcr_solve")
    base = jgen.tridiagonal(200) if tri else jgen.poisson2d(12)
    data = np.asarray(base.data) * (1 + 0.3j) + 0.1j * _crand(
        rng, np.asarray(base.data).shape).real
    A = tconvert.dia_from_numpy(data, base.offsets, base.shape, device="cpu")
    b = _crand(rng, base.shape[0])
    x = getattr(direct, name)(A, torch.from_numpy(b))
    assert x.dtype == torch.complex128
    xs = np.linalg.solve(A.todense().numpy(), b)
    assert _rel(x.numpy(), xs) <= 1e-10


# ---- R12: complex mixed precision ----------------------------------------

def _probe_dia(dtype=torch.complex128):
    data, offsets, shape = _hermitian_dia_np(jgen.poisson2d(12))
    return tconvert.dia_from_numpy(data, offsets, shape,
                                   device="cpu").to(dtype)


@pytest.mark.parametrize("method", ["cg", "gmres", "bicgstab"])
def test_complex_mixed_inner_sweeps_are_complex64(method, monkeypatch):
    from tpu_sparse_torch.solvers import mixed

    seen = []
    real_cast = mixed._cast_operator

    def spy(A, dtype, outer_dtype=torch.float64):
        seen.append(dtype)
        return real_cast(A, dtype, outer_dtype)

    monkeypatch.setattr(mixed, "_cast_operator", spy)
    A = _probe_dia()
    b = torch.from_numpy(_crand(np.random.default_rng(3), A.shape[0]))
    tol = 1e-10
    x, r = tpu_sparse_torch.solve(A, b, method=method, M="jacobi",
                                  precision="mixed", tol=tol)
    assert seen == [torch.complex64]
    assert r.converged and r.residual <= tol
    assert float(torch.linalg.norm(b - A @ x) / torch.linalg.norm(b)) <= tol
    # the batched refinement: (n, 2) right-hand sides
    seen.clear()
    B = torch.from_numpy(_crand(np.random.default_rng(4), (A.shape[0], 2)))
    X, rB = tpu_sparse_torch.solve(A, B, method=method, precision="mixed",
                                   tol=tol)
    assert seen == [torch.complex64]
    assert rB.converged and rB.residual <= tol
    # the inner dtype of a real system stays float32
    assert mixed._inner_dtype(torch.float64) == torch.float32
    assert mixed._inner_dtype(torch.complex128) == torch.complex64


def test_complex_mixed_casts_preconditioner_to_complex64():
    from tpu_sparse_torch.solvers.mixed import _cast_precond

    A = _probe_dia()
    for name in ("jacobi", "chebyshev", "ilu0"):
        M = tpu_sparse_torch.SparseSolver()._precond_M(A, name)
        M64 = _cast_precond(M, torch.complex64)
        v = torch.from_numpy(_crand(np.random.default_rng(5), A.shape[0]))
        y = M64(v.to(torch.complex64))
        assert y.dtype == torch.complex64
        assert _rel(y.numpy(), M(v).numpy()) <= 1e-5


# ---- R13: complex gradients against dense autograd -----------------------

def _cwell_dense(W, vals):
    """The dense matrix of a CWELL pack with values ``vals``, built by
    differentiable torch ops (slots at or past m dropped)."""
    n, m = W.shape
    cols = (W.srow[:, :, None].long() * 128 + W.idx2.long())
    rows = (torch.arange(W.vals.shape[0])[:, None, None] * 128
            + torch.arange(128)[None, None, :]).expand_as(cols)
    keep = (cols < m) & (rows < n)
    out = torch.zeros((n, m), dtype=vals.dtype)
    return out.index_put((rows[keep], cols[keep]), vals[keep],
                         accumulate=True)


@pytest.mark.parametrize("fmt", ["dia", "cwell", "dense"])
@pytest.mark.parametrize("method", ["cg", "gmres", "bicgstab", "minres"])
def test_complex_gradients_match_dense_autograd(method, fmt):
    """d/d(b, values) of |w^T x|^2 + |x|^2 for x = solve(A, b)."""
    from tpu_sparse_torch.sparse.convert import to_csr

    A = _probe_dia()
    n = A.shape[0]
    rng = np.random.default_rng(6)
    b0 = torch.from_numpy(_crand(rng, n))
    w = torch.from_numpy(_crand(rng, n))
    if fmt == "dia":
        op = A
        vals0 = A.data

        def dense(v):
            return A.with_data(v).todense()
    elif fmt == "cwell":
        op = csr_to_cwell(to_csr(A))
        vals0 = op.vals

        def dense(v):
            return _cwell_dense(op, v)
    else:
        op = A.todense()
        vals0 = op

        def dense(v):
            return v

    def loss(x):
        return (w @ x).abs() ** 2 + (x.conj() @ x).real

    v1 = vals0.clone().requires_grad_()
    b1 = b0.clone().requires_grad_()
    A1 = v1 if fmt == "dense" else op.with_data(v1)
    x1, r = tpu_sparse_torch.solve(A1, b1, method=method, tol=1e-12,
                                   precision="full", maxiter=2000)
    assert r.converged
    loss(x1).backward()
    v2 = vals0.clone().requires_grad_()
    b2 = b0.clone().requires_grad_()
    loss(torch.linalg.solve(dense(v2), b2)).backward()
    assert _rel(b1.grad.numpy(), b2.grad.numpy()) <= 1e-8
    assert _rel(v1.grad.numpy(), v2.grad.numpy()) <= 1e-8


# ---- a real matrix with a complex b --------------------------------------

@pytest.mark.parametrize("fmt", ["dia", "cwell", "csr"])
def test_real_matrix_complex_rhs_casts_once(fmt):
    from tpu_sparse_torch.sparse.convert import to_csr

    L = tpu_sparse_torch.sparse.generators.poisson2d(12, dtype=np.float64,
                                                     device="cpu")
    A = {"dia": L, "cwell": csr_to_cwell(to_csr(L)), "csr": to_csr(L)}[fmt]
    b = torch.from_numpy(_crand(np.random.default_rng(7), L.shape[0]))
    solver = tpu_sparse_torch.SparseSolver()
    tracing.reset()
    x, r = solver.solve(A, b, method="cg", M="jacobi", tol=1e-10)
    assert r.converged and x.dtype == torch.complex128
    assert tk.CAST_COUNTS["values_casts"] == 1
    x2, _ = solver.solve(A, b, method="cg", M="jacobi", tol=1e-10)
    assert tk.CAST_COUNTS["values_casts"] == 1  # the cast is cached
    assert torch.equal(x, x2)
    Ac = A.with_data(A.data.to(torch.complex128)) if fmt != "cwell" \
        else A.with_data(A.vals.to(torch.complex128))
    xh, _ = tpu_sparse_torch.SparseSolver().solve(Ac, b, method="cg",
                                                   M="jacobi", tol=1e-10)
    assert torch.equal(x, xh)
    # a values gradient reaches the real values through the cast
    tracing.reset()
    v = L.data.clone().requires_grad_()
    xg, _ = solver.solve(L.with_data(v), b, tol=1e-12)
    xg.abs().sum().backward()
    assert v.grad is not None and v.grad.dtype == torch.float64
    assert tk.CAST_COUNTS["values_casts"] == 1
    assert float(v.grad.abs().max()) > 0


# ---- carriers, plain kernels, wrappers -----------------------------------

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_from_numpy_carriers_keep_complex(dtype):
    rng = np.random.default_rng(8)
    data = _crand(rng, (3, 20)).astype(dtype)
    A = tconvert.dia_from_numpy(data, (-1, 0, 1), (20, 20), device="cpu")
    assert A.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(A.data.numpy(), data)
    Dj = jdense_to_csr(_hermitian_dense(40).astype(dtype))
    from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell

    Wj = jcsr_to_cwell(Dj)
    W = tconvert.cwell_from_numpy(np.asarray(Wj.vals), np.asarray(Wj.idx2),
                                  np.asarray(Wj.srow), Wj.shape, nnz=Wj.nnz,
                                  fill=Wj.fill, group=Wj.group, device="cpu")
    assert W.vals.dtype == A.dtype and W.idx2.dtype == torch.int32
    np.testing.assert_array_equal(W.vals.numpy(), np.asarray(Wj.vals))
    blocks = _crand(rng, (5, 2, 4, 4)).astype(dtype)
    Bl = tconvert.bell_from_numpy(blocks, np.zeros((5, 2), np.int32),
                                  (20, 20), device="cpu")
    assert Bl.blocks.dtype == A.dtype
    np.testing.assert_array_equal(Bl.blocks.numpy(), blocks)


@pytest.mark.parametrize("dtype,bound", [(torch.complex128, 1e-12),
                                         (torch.complex64, 1e-5)])
def test_plain_kernels_compute_the_complex_product(dtype, bound):
    from tpu_sparse_torch.sparse import cwell_compact

    rng = np.random.default_rng(9)
    A = _probe_dia(dtype)
    Ad = A.todense().numpy()
    x = torch.from_numpy(_crand(rng, A.shape[0])).to(dtype)
    X = torch.from_numpy(_crand(rng, (A.shape[0], 3))).to(dtype)
    y0, Y0 = Ad @ x.numpy(), Ad @ X.numpy()
    assert _rel(tref.dia_spmv(A, x).numpy(), y0) <= bound
    W = csr_to_cwell(tconvert.to_csr(A))
    plan, cvals = cwell_compact.compact(W)
    assert cvals.dtype == dtype
    assert _rel(tref.cwell_spmv(W, x).numpy(), y0) <= bound
    assert _rel(tref.cwell_compact_spmv(plan, cvals, x).numpy(), y0) <= bound
    assert _rel(tref.cwell_compact_spmm(plan, cvals, X).numpy(), Y0) <= bound
    assert _rel(tref.cwell_spmm(W, X).numpy(), Y0) <= bound
    bell = bsr_to_bell(csr_to_bsr(tconvert.to_csr(A), 8))
    assert _rel(tref.bell_spmm(bell, X).numpy(), Y0) <= bound
    assert _rel(tk.spmv(bell, x).numpy(), y0) <= bound
    # the CPU wrappers take the plain versions
    assert torch.equal(cuda_spmv.dia_spmv(A, x), tref.dia_spmv(A, x))
    assert torch.equal(cuda_cwell.cwell_spmm(W, X), tref.cwell_spmm(W, X))
    assert torch.equal(cuda_bell.bell_spmm(bell, X), tref.bell_spmm(bell, X))
    for fn, op, v in ((cuda_spmv.dia_spmv_cuda, A, x),
                      (cuda_cwell.cwell_spmv_cuda, W, x),
                      (cuda_cwell.cwell_spmm_cuda, W, X),
                      (cuda_bell.bell_spmm_cuda, bell, X)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(op, v)
