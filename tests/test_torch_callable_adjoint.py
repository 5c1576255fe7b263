"""The adjoint gradient through matrix-free operators, and the ``*_diff``
forms of single-reduction CG, flexible CG, MINRES and FGMRES, against the
JAX package on the CPU, from the same numpy inputs.

A torch-op callable that closes over a coefficient tensor gives
gradients of b and of the coefficient, held against ``jax.grad`` of the
same loss through JAX's ``custom_linear_solve`` and against finite
differences. ``A_transpose`` is held against JAX's case of
tests/test_autodiff.py (its Pallas CWELL matvec in interpret mode; the
port's callable runs the plain CWELL SpMV on the CPU). A callable that
autograd cannot transpose raises an error naming ``A_transpose=``.

Tolerances: float64 gradients rtol 1e-6 against ``jax.grad`` and against
the port's matrix path (adjoint solves at tol 1e-12 of the same
recurrence), 1e-5 against central differences (h = 1e-6, solves at tol
1e-13); float32 gradients (the ``A_transpose`` case, solves at tol 1e-6)
rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_sparse.autodiff as jad
from tpu_sparse.kernels import pallas_cwell
from tpu_sparse.sparse import containers as jcont
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import csr_from_arrays as jcsr_from_arrays
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell
from tpu_sparse_torch import autodiff as tad
from tpu_sparse_torch import kernels
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse.cwell import csr_to_cwell
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

N = 40
SYMMETRIC = ("cg", "cg_sr", "fcg", "minres")
NONSYMMETRIC = ("bicgstab", "gmres", "fgmres")
# a short restart keeps JAX's compiles of the GMRES cycles cheap
KW = {"gmres": dict(restart=5), "fgmres": dict(restart=5)}


def _op(xp, c, v, convection):
    """Variable-coefficient 1-D diffusion (SPD for c > 0), plus an upwind
    convection term for the nonsymmetric methods; the same expression in
    torch and in jax.numpy."""
    cat = torch.cat if xp is torch else jnp.concatenate
    zero = v[:1] * 0
    left = cat([zero, v[:-1]])
    right = cat([v[1:], zero])
    out = (c[:-1] + c[1:]) * v - c[:-1] * left - c[1:] * right
    return out + 0.5 * (v - left) if convection else out


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (1.0 + rng.random(N + 1), rng.standard_normal(N),
            rng.standard_normal(N))


def _loss_port(method, c, b, w, tol=1e-12):
    conv = method in NONSYMMETRIC
    x = getattr(tad, f"{method}_diff")(
        lambda v: _op(torch, c, v, conv), b, tol=tol,
        **KW.get(method, {}))[0]
    return torch.dot(w, x)


def _grads_port(method, c_np, b_np, w_np):
    c = torch.from_numpy(c_np).requires_grad_()
    b = torch.from_numpy(b_np).requires_grad_()
    _loss_port(method, c, b, torch.from_numpy(w_np)).backward()
    return c.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("method", SYMMETRIC + NONSYMMETRIC)
def test_callable_grads_match_jax(method):
    c, b, w = _data()
    conv = method in NONSYMMETRIC

    def loss(cc, bb):
        x = getattr(jad, f"{method}_diff")(
            lambda v: _op(jnp, cc, v, conv), bb, tol=1e-12,
            **KW.get(method, {}))[0]
        return jnp.dot(jnp.asarray(w), x)

    gcj, gbj = jax.grad(loss, argnums=(0, 1))(jnp.asarray(c), jnp.asarray(b))
    gct, gbt = _grads_port(method, c, b, w)
    np.testing.assert_allclose(gbt, np.asarray(gbj), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(gct, np.asarray(gcj), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("method", ["minres", "fgmres"])
def test_callable_grads_match_finite_differences(method):
    c, b, w = _data(1)
    gct, gbt = _grads_port(method, c, b, w)
    h = 1e-6

    def loss(cc, bb):
        with torch.no_grad():
            return float(_loss_port(method, torch.from_numpy(cc),
                                    torch.from_numpy(bb),
                                    torch.from_numpy(w), tol=1e-13))

    for i in (0, 7, N - 1):
        e = np.zeros(N)
        e[i] = h
        fd = (loss(c, b + e) - loss(c, b - e)) / (2 * h)
        np.testing.assert_allclose(gbt[i], fd, rtol=1e-5, atol=1e-9)
        e = np.zeros(N + 1)
        e[i] = h
        fd = (loss(c + e, b) - loss(c - e, b)) / (2 * h)
        np.testing.assert_allclose(gct[i], fd, rtol=1e-5, atol=1e-9)


def _nonsymmetric_cwell_pair():
    """JAX tests/test_autodiff.py's A_transpose case: a nonsymmetric
    tridiagonal float32 matrix of 256 rows and its transpose, packed as
    CWELL in both packages."""
    n = 256
    T = sp.diags([np.full(n - 1, -1.0), np.full(n, 4.0),
                  np.full(n - 1, -2.0)], [-1, 0, 1], format="csr",
                 dtype=np.float32)
    pairs = []
    for S in (T, T.T.tocsr()):
        Wj = jcsr_to_cwell(jcsr_from_arrays(S.data, S.indices, S.indptr,
                                            S.shape))
        Wt = csr_to_cwell(tconvert.csr_from_arrays(
            S.data, S.indices, S.indptr, S.shape, device="cpu"))
        pairs.append((Wj, Wt))
    b = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    return pairs, b


@pytest.mark.parametrize("method", NONSYMMETRIC)
def test_explicit_transpose_matches_jax_and_matrix_path(method):
    """With A_transpose the backward solves with it, without M, and b alone
    gets a gradient; it equals JAX's (Pallas matvec in interpret mode) and
    the port's matrix path on the same pack."""
    ((Wj, Wt), (Wtj, Wtt)), b = _nonsymmetric_cwell_pair()
    w = np.random.default_rng(8).standard_normal(b.shape[0]).astype(
        np.float32)
    pallas_cwell._INTERPRET = True
    try:
        def loss(bb):
            x = getattr(jad, f"{method}_diff")(
                lambda v: pallas_cwell.cwell_spmv_pallas(Wj, v), bb,
                tol=1e-6,
                A_transpose=lambda v: pallas_cwell.cwell_spmv_pallas(Wtj, v),
                **KW.get(method, {}))[0]
            return jnp.dot(jnp.asarray(w), x)

        gj = np.asarray(jax.grad(loss)(jnp.asarray(b)))
    finally:
        pallas_cwell._INTERPRET = False
    kw = dict(tol=1e-6, **KW.get(method, {}))
    fn = getattr(tad, f"{method}_diff")
    bt = torch.from_numpy(b).requires_grad_()
    x, info, _, _ = fn(lambda v: kernels.spmv(Wt, v), bt,
                       A_transpose=lambda v: kernels.spmv(Wtt, v), **kw)
    assert int(info) == 0
    torch.dot(torch.from_numpy(w), x).backward()
    bm = torch.from_numpy(b).requires_grad_()
    torch.dot(torch.from_numpy(w), fn(Wt, bm, **kw)[0]).backward()
    np.testing.assert_allclose(bt.grad.numpy(), gj, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), bm.grad.numpy(), rtol=1e-3,
                               atol=1e-5)


def _host_matvec(S):
    """A matvec through numpy: its output leaves autograd's graph, as a
    kernel without a backward does on the card."""
    return lambda v: torch.from_numpy(S @ v.detach().numpy())


@pytest.mark.parametrize("case", ["host", "partial"])
@pytest.mark.parametrize("method", NONSYMMETRIC)
def test_untransposable_callable_raises_naming_a_transpose(method, case):
    """A callable autograd cannot transpose raises in the backward; so does
    one it can transpose only in part (the check <u, A w> = <A^H u, w>),
    instead of a zero or partial gradient. The forward solve stands."""
    A = tconvert.dia_from_numpy(np.asarray(
        jgen.convection_diffusion(N).data), (-1, 0, 1), (N, N),
        device="cpu")
    S = A.todense().numpy()
    if case == "host":
        A_fn = _host_matvec(S)
    else:
        A_fn = lambda v: _host_matvec(S - np.eye(N))(v) + v  # noqa: E731
    b = torch.from_numpy(_data()[1]).requires_grad_()
    x, info, _, _ = getattr(tad, f"{method}_diff")(A_fn, b, tol=1e-10,
                                                   **KW.get(method, {}))
    assert int(info) == 0
    with pytest.raises(RuntimeError, match="A_transpose="):
        x.sum().backward()


@pytest.mark.parametrize("method", SYMMETRIC)
def test_symmetric_methods_reuse_the_callable_in_the_adjoint(method):
    """Symmetric methods solve the adjoint system with A_fn itself, so an
    untransposable A_fn still gives b its gradient (the matrix path's)."""
    A = tconvert.dia_from_numpy(np.asarray(jgen.poisson2d(6).data),
                                (-6, -1, 0, 1, 6), (36, 36), device="cpu")
    fn = getattr(tad, f"{method}_diff")
    b = np.random.default_rng(3).standard_normal(36)
    grads = []
    for op in (_host_matvec(A.todense().numpy()), A):
        bb = torch.from_numpy(b).requires_grad_()
        fn(op, bb, tol=1e-12)[0].sum().backward()
        grads.append(bb.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-12)


def _matrix_system(method):
    if method == "fgmres":
        return jgen.convection_diffusion_3d_27pt(4, dtype=np.float64)
    if method == "minres":
        A = jgen.poisson2d(6)
        d0 = A.offsets.index(0)
        return jcont.DIA(A.data.at[d0].add(-1.5), A.offsets, A.shape)
    return jgen.poisson2d(6)


@pytest.mark.parametrize("fmt", ["dia", "cwell"])
@pytest.mark.parametrize("method", ["cg_sr", "fcg", "minres", "fgmres"])
def test_matrix_diff_forms_match_jax(method, fmt):
    """The new ``*_diff`` forms on a matrix operand: b.grad and the values'
    grad against ``jax.grad`` (DIA), and on the CWELL pack of the same
    matrix b.grad against JAX's and the values' grad against the DIA's
    (through the pack's dense form)."""
    Aj = _matrix_system(method)
    n = Aj.shape[0]
    rng = np.random.default_rng(11)
    b, w = rng.standard_normal(n), rng.standard_normal(n)

    def loss(vals, bb):
        x = getattr(jad, f"{method}_diff")(Aj.with_data(vals), bb,
                                           tol=1e-12, **KW.get(method, {}))[0]
        return jnp.dot(jnp.asarray(w), x)

    gAj, gbj = jax.grad(loss, argnums=(0, 1))(Aj.data, jnp.asarray(b))
    At = tconvert.dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                                 device="cpu")
    if fmt == "cwell":
        At = csr_to_cwell(tconvert.to_csr(At))
    vals = (At.vals if fmt == "cwell" else At.data).clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    A_ = At.with_data(vals)
    x = getattr(tad, f"{method}_diff")(A_, bt, tol=1e-12,
                                       **KW.get(method, {}))[0]
    torch.dot(torch.from_numpy(w), x).backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gbj), rtol=1e-6,
                               atol=1e-10)
    # a CWELL's padding slots get a gradient too (JAX's convention); only
    # the stored nonzeros map to entries of the dense form
    gA = At.with_data(torch.where(vals != 0, vals.grad, 0)).todense().numpy()
    gA_ref = jcont.DIA(gAj, Aj.offsets, Aj.shape).todense()
    pattern = np.asarray(Aj.todense()) != 0
    np.testing.assert_allclose(gA[pattern], np.asarray(gA_ref)[pattern],
                               rtol=1e-6, atol=1e-10)
