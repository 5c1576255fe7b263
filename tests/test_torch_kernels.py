"""tpu_sparse_torch kernels: the plain versions against the JAX package
(its Pallas kernels in interpret mode, as its own tests run them). The CUDA
kernels against their plain versions are in test_torch_cuda.py.

Tolerances: plain DIA SpMV against the JAX reference rel 1e-14 (f64) and
1e-6 (f32) — same products and summation order; extended operator against
the interpreted Pallas kernel rtol 1e-5 (f32), margins exactly zero; one
fused K=8 CG block rtol 1e-4 (f32 dot products summed in another order);
a whole fused CG solve |diters| <= 1 and x rtol 5e-3 / atol 5e-4 (the
bounds of tests/test_fused_cg.py). K10 (fused BiCGStab): one K=8 block
rtol 1e-4 against the interpreted Pallas block (f32 dot products summed in
another order; errors relative to max|v|), the three-launch state machine
rtol 1e-4 against the block reference, a whole solve |diters| <= 2 with
equal info and x rtol 2e-3 (the bounds of tests/test_fused_bicgstab.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_sparse.kernels.pallas_bicgstab as jpbi
import tpu_sparse.kernels.pallas_cg as jpcg
import tpu_sparse.kernels.pallas_spmv as jps
from tpu_sparse.kernels import reference as jref
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.kernels import cuda_bicgstab, cuda_cg, cuda_spmv
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.sparse.convert import dia_from_numpy
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jps, "_INTERPRET", True)
    monkeypatch.setattr(jps, "_HAS_PALLAS", True)
    monkeypatch.setattr(jpcg, "_INTERPRET", True)
    monkeypatch.setattr(jpcg, "_HAS_PALLAS", True)
    monkeypatch.setattr(jpbi, "_INTERPRET", True)
    monkeypatch.setattr(jpbi, "_HAS_PALLAS", True)
    yield


def _carry(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                          device="cpu")


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
        dia_from_numpy(np.ones((1, 4)), (5,), (4, 4), device="cpu")) is None


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
            dia_from_numpy(np.ones((1, 5)), (0,), (5, 6), device="cpu"))


def _bicgstab_problem(nx, singular=False):
    """The skewed (nonsymmetric) 2-D Poisson of tests/test_fused_bicgstab.py,
    or its singular variant (zero row sums) with a random right-hand side."""
    Aj = jgen.poisson2d(nx, dtype=np.float32)
    data = np.array(Aj.data)
    offs = list(Aj.offsets)
    rng = np.random.default_rng(0)
    if singular:
        data[offs.index(0)] = -(data.sum(axis=0) - data[offs.index(0)])
        Aj = Aj.with_data(jnp.asarray(data))
        return Aj, rng.standard_normal(Aj.shape[0]).astype(np.float32)
    data[offs.index(-1)] *= 1.3
    data[offs.index(1)] *= 0.7
    Aj = Aj.with_data(jnp.asarray(data))
    x_true = rng.standard_normal(Aj.shape[0]).astype(np.float32)
    return Aj, np.array(Aj @ jnp.asarray(x_true))


def test_fused_bicgstab_block_reference_matches_jax_block(interpret_mode):
    Aj, b = _bicgstab_problem(24)
    K = 8
    opj = jps.ExtendedStencilOperator(Aj)
    bj = opj.extend(jnp.asarray(b))
    xj, rj, pj, hj = jpbi._fused_bicgstab_block(
        jnp.zeros_like(bj), bj, bj, bj, opj.data_p, offsets=opj.offsets,
        H=opj.H, C=opj.C, lo_chunks=opj.Wl // opj.C,
        hi_chunk=opj.Wl // opj.C + opj.n_pad // opj.C, K=K)
    opt = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    bt = opt.extend(torch.from_numpy(b))
    xt, rt, pt, ht = cuda_bicgstab.fused_bicgstab_block_reference(
        opt, torch.zeros_like(bt), bt, bt, bt, K)
    for t, j in ((xt, xj), (rt, rj), (pt, pj)):
        np.testing.assert_allclose(opt.extract(t).numpy(),
                                   np.asarray(opj.extract(j)),
                                   rtol=1e-4, atol=1e-4 * float(
                                       np.max(np.abs(np.asarray(j)))))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj)[:, 0], rtol=1e-4)


def test_fused_bicgstab_state_machine_matches_block_reference():
    """The three-launch iteration (K10, here its plain versions) against
    the JAX-convention block reference: same x, r and history; the next
    direction is r + beta (p_last - omega q_last)."""
    Aj, b = _bicgstab_problem(24)
    op = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    bt = op.extend(torch.from_numpy(b))
    state = cuda_bicgstab.FusedBiCGStabState(op, bt)
    hist = torch.empty(8)
    state.run(hist)
    xr, rr, pr, hr = cuda_bicgstab.fused_bicgstab_block_reference(
        op, torch.zeros_like(bt), bt, bt, bt, 8)
    scal = state.scal.float()
    p_next = state.r + scal[cuda_bicgstab.BETA] * (
        state.direction - scal[cuda_bicgstab.OMEGA] * state.aq)
    for got, want in ((state.x, xr), (state.r, rr), (p_next, pr)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(hist, hr, rtol=1e-4, atol=0)
    assert float(state.x[:op.Wl].abs().max()) == 0.0
    assert float(state.r[op.Wl + op.n:].abs().max()) == 0.0


@pytest.mark.parametrize("singular", [False, True])
def test_fused_bicgstab_ext_plain_matches_jax(interpret_mode, singular):
    """A converging solve, and a singular system that must not report
    success: both fused_bicgstab_ext give the same info, iterations within
    2."""
    Aj, b = _bicgstab_problem(12 if singular else 24, singular)
    kw = (dict(tol=1e-10, maxiter=400, block_iters=8) if singular
          else dict(tol=1e-5, maxiter=600, block_iters=6))
    xj, ij, itj, _ = jpbi.fused_bicgstab_ext(
        jps.ExtendedStencilOperator(Aj), jnp.asarray(b), **kw)
    opt = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    xt, it_, itt, rest = cuda_bicgstab.fused_bicgstab_ext(
        opt, torch.from_numpy(b), **kw)
    assert int(it_) == int(ij)
    assert abs(int(itt) - int(itj)) <= 2, (int(itt), int(itj))
    if singular:
        assert int(it_) != 0
        return
    assert int(it_) == 0
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-3,
                               atol=2e-3)
    assert float(rest) <= 10 * 1e-5 * float(np.linalg.norm(b))


def test_fused_bicgstab_overshoot_freeze_and_breakdown_codes():
    """Iterations past convergence stay finite (the guards freeze them);
    the count is the first crossing in the last block; a forced breakdown
    freezes the state and surfaces its code in the history."""
    Aj, b = _bicgstab_problem(12)
    op = cuda_spmv.ExtendedStencilOperator(_carry(Aj))
    bt = torch.from_numpy(b)
    x, info, it, _ = cuda_bicgstab.fused_bicgstab_ext(
        op, bt, tol=1e-5, maxiter=3000, block_iters=48)
    x8, info8, it8, _ = cuda_bicgstab.fused_bicgstab_ext(
        op, bt, tol=1e-5, maxiter=3000, block_iters=8)
    assert int(info) == int(info8) == 0 and int(it) < 48
    assert abs(int(it8) - int(it)) <= 1
    assert torch.isfinite(x).all()
    assert float(torch.linalg.vector_norm(bt - op.matvec(x))) <= \
        2e-5 * float(torch.linalg.vector_norm(bt))
    # the 90-degree rotation [[0, -1], [1, 0]] with b = e1: A r0 is
    # orthogonal to r^ = r0, so <r^, q> collapses: code -11 from the first
    # iteration on, and the frozen state keeps x = 0, r = b
    rot = dia_from_numpy(np.array([[0.0, 1.0], [0.0, 0.0], [-1.0, 0.0]],
                                  dtype=np.float32), (-1, 0, 1), (2, 2),
                         device="cpu")
    rop = cuda_spmv.ExtendedStencilOperator(rot)
    st = cuda_bicgstab.FusedBiCGStabState(
        rop, rop.extend(torch.tensor([1.0, 0.0])))
    hist = torch.empty(3)
    st.run(hist)
    assert hist.tolist() == [-11.0, -11.0, -11.0]
    assert rop.extract(st.x).tolist() == [0.0, 0.0]
    assert rop.extract(st.r).tolist() == [1.0, 0.0]
    x, info, it, _ = cuda_bicgstab.fused_bicgstab_ext(
        rop, torch.tensor([1.0, 0.0]), tol=1e-6, maxiter=100, block_iters=4)
    assert int(info) == -11 and int(it) == 1


def test_fused_bicgstab_helpers_and_refusals():
    A32 = _carry(jgen.poisson2d(6, dtype=np.float32))
    op = cuda_spmv.ExtendedStencilOperator(A32)
    assert cuda_bicgstab.supports_fused_bicgstab(op)
    assert not cuda_bicgstab.supports_fused_bicgstab(
        cuda_spmv.ExtendedStencilOperatorF64(_carry(jgen.poisson2d(6))))
    with pytest.raises(ValueError):
        cuda_bicgstab.fused_bicgstab_ext(
            cuda_spmv.ExtendedStencilOperatorF64(_carry(jgen.poisson2d(6))),
            torch.ones(36, dtype=torch.float64))
    st = cuda_bicgstab.FusedBiCGStabState(op, op.extend(torch.ones(36)))
    assert st.part.shape == (cuda_bicgstab.N_PART, cuda_cg.grid_for(36))
    assert float(st.scal[cuda_bicgstab.RHO]) == 36.0
