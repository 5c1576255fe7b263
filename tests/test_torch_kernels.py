"""tpu_sparse_torch kernels: the plain versions against the JAX package
(its Pallas kernels in interpret mode, as its own tests run them). The CUDA
kernels against their plain versions are in test_torch_cuda.py.

Tolerances: plain DIA SpMV against the JAX reference rel 1e-14 (f64) and
1e-6 (f32) — same products and summation order; extended operator against
the interpreted Pallas kernel rtol 1e-5 (f32), margins exactly zero; one
fused K=8 CG block rtol 1e-4 (f32 dot products summed in another order);
a whole fused CG solve |diters| <= 1 and x rtol 5e-3 / atol 5e-4 (the
bounds of tests/test_fused_cg.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_sparse.kernels.pallas_cg as jpcg
import tpu_sparse.kernels.pallas_spmv as jps
from tpu_sparse.kernels import reference as jref
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.kernels import cuda_cg, cuda_spmv
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.sparse.convert import dia_from_numpy


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jps, "_INTERPRET", True)
    monkeypatch.setattr(jps, "_HAS_PALLAS", True)
    monkeypatch.setattr(jpcg, "_INTERPRET", True)
    monkeypatch.setattr(jpcg, "_HAS_PALLAS", True)
    yield


def _carry(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-14),
                                         (np.float32, 1e-6)])
@pytest.mark.parametrize("case", ["tridiagonal", "poisson2d", "poisson3d",
                                  "rect"])
def test_plain_dia_spmv_matches_jax_reference(case, dtype, bound):
    rng = np.random.default_rng(5)
    if case == "tridiagonal":
        Aj = jgen.tridiagonal(300, dtype=dtype)
    elif case == "poisson2d":
        Aj = jgen.poisson2d(12, dtype=dtype)
    elif case == "poisson3d":
        Aj = jgen.poisson3d_27pt(7, 5, 3, dtype=dtype)
    else:
        from tpu_sparse.sparse.convert import dia_from_offsets

        Aj = dia_from_offsets((-3, 0, 2, 5),
                              rng.standard_normal((4, 40)).astype(dtype),
                              (40, 33))
    x = rng.standard_normal(Aj.shape[1]).astype(dtype)
    y_j = np.asarray(jref.dia_spmv(Aj, jnp.asarray(x)))
    y_t = tref.dia_spmv(_carry(Aj), torch.from_numpy(x)).numpy()
    assert y_t.dtype == y_j.dtype
    assert _rel(y_t, y_j) <= bound


@pytest.mark.parametrize("gen", ["poisson2d", "tridiagonal", "poisson3d"])
def test_extended_operator_plain_matches_jax_interpret(interpret_mode, gen):
    Aj = {"poisson2d": lambda: jgen.poisson2d(40, dtype=np.float32),
          "tridiagonal": lambda: jgen.tridiagonal(1500, dtype=np.float32),
          "poisson3d": lambda: jgen.poisson3d_27pt(9)}[gen]()
    v = np.random.default_rng(1).standard_normal(Aj.shape[0]).astype(
        np.float32)
    opj = jps.ExtendedStencilOperator(Aj)
    yj = np.asarray(opj.extract(opj(opj.extend(jnp.asarray(v)))))
    opt = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    yt_ext = opt(opt.extend(torch.from_numpy(v)))
    assert float(yt_ext[:opt.Wl].abs().max()) == 0.0
    assert float(yt_ext[opt.Wl + opt.n:].abs().max()) == 0.0
    np.testing.assert_allclose(opt.extract(yt_ext).numpy(), yj, rtol=1e-5,
                               atol=1e-5)


def test_extended_operator_f64_matvec64_matches_reference():
    A = _carry(jgen.poisson2d(20))
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(400))
    op = cuda_spmv.make_extended_operator_f64(A)
    assert op is not None
    y = op.matvec64(v)
    assert y.dtype == torch.float64
    assert _rel(y.numpy(), tref.dia_spmv(A, v).numpy()) <= 1e-15
    # f32 / rectangular / too-wide matrices do not take the layout
    assert cuda_spmv.make_extended_operator_f64(
        _carry(jgen.poisson2d(5, dtype=np.float32))) is None
    assert cuda_spmv.make_extended_operator(
        dia_from_numpy(np.ones((1, 4)), (5,), (4, 4))) is None


def _cg_problem(nx, jacobi):
    Aj = jgen.poisson2d(nx, dtype=np.float32)
    data = np.array(Aj.data)
    d = None
    if jacobi:
        # a non-trivial diagonal so Jacobi-PCG differs from CG
        k = Aj.offsets.index(0)
        data[k] *= (1.0 + 0.5 * np.abs(np.sin(np.arange(data.shape[1]))))
        d = data[k].astype(np.float32)
        Aj = Aj.with_data(jnp.asarray(data))
    x_true = np.random.default_rng(0).standard_normal(
        Aj.shape[0]).astype(np.float32)
    b = np.array(Aj @ jnp.asarray(x_true))
    dinv = None if d is None else (1.0 / d).astype(np.float32)
    return Aj, b, dinv


@pytest.mark.parametrize("jacobi", [False, True])
def test_fused_cg_block_reference_matches_jax_block(interpret_mode, jacobi):
    Aj, b, dinv = _cg_problem(40, jacobi)
    K = 8
    opj = jps.ExtendedStencilOperator(Aj)
    bj = opj.extend(jnp.asarray(b))
    dj = None if dinv is None else opj.extend_diag(jnp.asarray(dinv))
    pj = bj if dj is None else dj * bj
    xj, rj, pj, hj = jpcg._fused_cg_block(
        jnp.zeros_like(bj), bj, pj, opj.data_p, dj, offsets=opj.offsets,
        H=opj.H, C=opj.C, lo_chunks=opj.Wl // opj.C,
        hi_chunk=opj.Wl // opj.C + opj.n_pad // opj.C, K=K)

    opt = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    bt = opt.extend(torch.from_numpy(b))
    dt = None if dinv is None else opt.extend_diag(torch.from_numpy(dinv))
    pt = bt if dt is None else dt * bt
    xt, rt, pt, ht = cuda_cg.fused_cg_block_reference(
        opt, torch.zeros_like(bt), bt, pt, K, dinv=dt)
    for t, j in ((xt, xj), (rt, rj), (pt, pj)):
        np.testing.assert_allclose(opt.extract(t).numpy(),
                                   np.asarray(opj.extract(j)),
                                   rtol=1e-4, atol=1e-4 * float(
                                       np.max(np.abs(np.asarray(j)))))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj)[:, 0], rtol=1e-4)


@pytest.mark.parametrize("jacobi", [False, True])
def test_fused_cg_ext_plain_matches_jax(interpret_mode, jacobi):
    Aj, b, dinv = _cg_problem(40, jacobi)
    opj = jps.ExtendedStencilOperator(Aj)
    xj, ij, itj, _ = jpcg.fused_cg_ext(
        opj, jnp.asarray(b), tol=1e-5, maxiter=800, block_iters=8,
        dinv=None if dinv is None else jnp.asarray(dinv))
    opt = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    xt, it_, itt, rest = cuda_cg.fused_cg_ext(
        opt, torch.from_numpy(b), tol=1e-5, maxiter=800, block_iters=8,
        dinv=None if dinv is None else torch.from_numpy(dinv))
    assert int(it_) == int(ij) == 0
    assert abs(int(itt) - int(itj)) <= 1, (int(itt), int(itj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=5e-3,
                               atol=5e-4)
    assert float(rest) <= 10 * 1e-5 * float(np.linalg.norm(b))


@pytest.mark.parametrize("jacobi", [False, True])
def test_fused_state_machine_matches_block_reference(jacobi):
    """The two-launch iteration (kernels 2 and 3, here their plain
    versions) against the JAX-convention block reference: same x, r and
    history; the next direction is z + beta * p_last."""
    Aj, b, dinv = _cg_problem(24, jacobi)
    op = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    bt = op.extend(torch.from_numpy(b))
    dt = None if dinv is None else op.extend_diag(torch.from_numpy(dinv))
    state = cuda_cg.FusedCGState(op, bt, dt)
    hist = torch.empty(8)
    state.run(hist)
    p0 = bt if dt is None else dt * bt
    xr, rr, pr, hr = cuda_cg.fused_cg_block_reference(
        op, torch.zeros_like(bt), bt, p0, 8, dinv=dt)
    z = state.r if dt is None else dt * state.r
    p_next = z + state.scal[1].float() * state.direction
    torch.testing.assert_close(state.x, xr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(state.r, rr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(p_next, pr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(hist, hr, rtol=1e-4, atol=0)


def test_fused_cg_freeze_and_first_crossing():
    """A converged system survives extra iterations (alpha guarded to 0),
    and the count is the first crossing, not the block boundary."""
    Aj, b, _ = _cg_problem(12, False)
    op = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    bt = torch.from_numpy(b)
    x, info, it, res = cuda_cg.fused_cg_ext(op, bt, tol=1e-5, maxiter=4000,
                                            block_iters=64)
    x16, info16, it16, _ = cuda_cg.fused_cg_ext(op, bt, tol=1e-5,
                                                maxiter=4000, block_iters=16)
    assert int(info) == 0 and int(it) < 64
    assert int(it16) == int(it)
    assert torch.isfinite(x).all()
    assert float(torch.linalg.vector_norm(bt - op.matvec(x))) <= \
        10 * 1e-5 * float(torch.linalg.vector_norm(bt))


def test_fused_helpers():
    A32 = _carry(jgen.poisson2d(8, dtype=np.float32))
    assert cuda_cg.supports_fused_cg(cuda_cg.make_fused_operator(A32))
    assert cuda_cg.make_fused_operator(_carry(jgen.poisson2d(8))) is None
    assert not cuda_cg.supports_fused_cg(
        cuda_spmv.ExtendedStencilOperatorF64(_carry(jgen.poisson2d(8))))
    assert cuda_cg.pick_block_iters(92) == jpcg.pick_block_iters(92)
    assert cuda_cg.pick_block_iters(0) == jpcg.pick_block_iters(0)
    assert cuda_cg.grid_for(1) == 1 and cuda_cg.grid_for(10 ** 7) == 1024


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    A = _carry(jgen.poisson2d(6, dtype=np.float32))
    with pytest.raises(ValueError):
        cuda_spmv.dia_spmv_cuda(A, torch.zeros(36))
    op = cuda_spmv.ExtendedStencilOperator(A)
    with pytest.raises(ValueError):
        op.apply_cuda(torch.zeros(op.E))
    with pytest.raises(ValueError):
        cuda_spmv.ExtendedStencilOperator(
            dia_from_numpy(np.ones((1, 5)), (0,), (5, 6)))
