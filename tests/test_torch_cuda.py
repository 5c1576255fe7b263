"""tpu_sparse_torch CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine that has only torch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)

Tolerances: SpMV rel 1e-5 (f32) / 1e-13 (f64) against the plain version
(the kernel fuses multiply-adds); fused CG iterations within 1 of the plain
fused loop (dot products accumulate in double in the kernels) and x
rtol 5e-3 / atol 5e-4. K10: each launch within 1e-5 of the vectors' scale
of its plain version on the same mid-solve state; a whole fused solve
with the plain loop's info, stopping between 2 iterations before and one
block of 12 after the loop's first crossing (the rule of the JAX
fused_bicgstab_ext). Solves on the card against the CPU: iterations
(GMRES: cycles) within 2, x rtol 1e-3 (f32) / 1e-6 (f64); gradients
through solve() rtol 5e-3 (f32: fused loops on the card, plain loops on
the CPU, both at tol 1e-5) / 1e-6 (f64). K4 / K5 (CWELL SpMV): 1e-5 /
1e-13 of max|y| against the plain version, exactly 0 where y is 0, and
bit-identical reruns; the card's pack byte-equal to the CPU's; solves on
CWELL as on DIA, but paths with float32 arithmetic within 5 iterations
or a fifth of the count (see the test). K6/K7 (CWELL SpMM) and K8 (BELL
SpMM): 1e-5 (f32) / 1e-12 (f64) of max|Y| against the plain version,
bit-identical reruns; multi-RHS solves on the card against the CPU with
the CWELL solves' iteration slack and x tolerances.
"""

import numpy as np
import pytest
import torch

import tpu_sparse_torch
from tpu_sparse_torch.kernels import (cuda_bell, cuda_bicgstab, cuda_cg,
                                      cuda_cwell, cuda_spmv)
from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse import generators as gen

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-5),
                                         (np.float64, 1e-13)])
@pytest.mark.parametrize("make", [
    lambda dt: gen.tridiagonal(1500, dtype=dt, device="cpu"),
    lambda dt: gen.poisson2d(40, dtype=dt, device="cpu"),
    lambda dt: gen.poisson3d_27pt(13, 11, 7, dtype=dt, device="cpu"),
], ids=["tridiagonal", "poisson2d", "poisson3d-odd"])
def test_dia_spmv_kernel_matches_plain(dev, make, dtype, bound):
    A = make(dtype).to(dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.shape[0]).astype(dtype)).to(dev)
    y0 = ref.dia_spmv(A, x)
    assert _rel(cuda_spmv.dia_spmv_cuda(A, x), y0) <= bound
    op = cuda_spmv.ExtendedStencilOperator(A)
    ye = op(op.extend(x))
    assert float(ye[:op.Wl].abs().max()) == 0.0
    assert float(ye[op.Wl + op.n:].abs().max()) == 0.0
    assert _rel(op.extract(ye), y0) <= bound


def test_dia_spmv_kernel_rectangular_and_refusals(dev):
    rng = np.random.default_rng(1)
    from tpu_sparse_torch.sparse.convert import dia_from_numpy

    A = dia_from_numpy(rng.standard_normal((3, 50)), (-4, 0, 7), (50, 41),
                       device=dev)
    x = torch.from_numpy(rng.standard_normal(41)).to(dev)
    assert _rel(cuda_spmv.dia_spmv_cuda(A, x), ref.dia_spmv(A, x)) <= 1e-13
    wide = dia_from_numpy(np.ones((65, 80)), tuple(range(-32, 33)), (80, 80),
                          device=dev)
    with pytest.raises(ValueError, match="exceed"):
        cuda_spmv.dia_spmv_cuda(wide, torch.ones(80, device=dev,
                                                 dtype=torch.float64))
    with pytest.raises(TypeError):
        cuda_spmv.dia_spmv_cuda(A.with_data(A.data.to(torch.bfloat16)),
                                x.to(torch.bfloat16))


@pytest.mark.parametrize("jacobi", [False, True])
def test_fused_cg_kernels_match_plain_loop(dev, jacobi):
    A = gen.poisson2d(64, dtype=np.float32, device="cpu")
    if jacobi:
        data = A.data.clone()
        k = A.offsets.index(0)
        data[k] *= 1.0 + 0.5 * torch.sin(torch.arange(data.shape[1])).abs()
        A = A.with_data(data)
    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.shape[0]).astype(np.float32))
    b = ref.dia_spmv(A, x_true)
    dinv = 1.0 / A.data[A.offsets.index(0)] if jacobi else None
    xc, ic, itc, _ = cuda_cg.fused_cg_ext(
        cuda_spmv.ExtendedStencilOperator(A), b, tol=1e-5, maxiter=2000,
        dinv=dinv)
    Ad = A.to(dev)
    before = dict(cuda_cg.LAUNCHES)
    xg, ig, itg, _ = cuda_cg.fused_cg_ext(
        cuda_spmv.ExtendedStencilOperator(Ad), b.to(dev), tol=1e-5,
        maxiter=2000, dinv=None if dinv is None else dinv.to(dev))
    assert cuda_cg.LAUNCHES["dia_cg_spmv_dot"] > before["dia_cg_spmv_dot"]
    assert int(ic) == int(ig) == 0
    assert abs(int(itc) - int(itg)) <= 1
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=5e-3,
                               atol=5e-4)
    # deterministic: a second run gives the same bits
    xg2, _, itg2, _ = cuda_cg.fused_cg_ext(
        cuda_spmv.ExtendedStencilOperator(Ad), b.to(dev), tol=1e-5,
        maxiter=2000, dinv=None if dinv is None else dinv.to(dev))
    assert int(itg2) == int(itg) and torch.equal(xg2, xg)


@pytest.mark.parametrize("dtype,precision,M", [
    (np.float32, "auto", None), (np.float32, "auto", "jacobi"),
    (np.float64, "auto", None), (np.float64, "full", None),
    (np.float64, "full", "jacobi"),
])
def test_solve_on_card_matches_cpu(dev, dtype, precision, M):
    A = gen.poisson3d_27pt(24, dtype=dtype, device="cpu")
    x_true = torch.from_numpy(np.random.default_rng(2).standard_normal(
        A.shape[0]).astype(dtype))
    b = ref.dia_spmv(A, x_true)
    tol = 1e-6 if dtype == np.float32 else 1e-9
    xc, rc = tpu_sparse_torch.solve(A, b, tol=tol, precision=precision, M=M)
    xg, rg = tpu_sparse_torch.solve(A.to(dev), b.to(dev), tol=tol,
                                    precision=precision, M=M)
    assert rc.converged and rg.converged
    assert abs(rc.iterations - rg.iterations) <= 2
    rtol = 1e-3 if dtype == np.float32 else 1e-6
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=rtol,
                               atol=rtol * float(xc.abs().max()))


def _skewed(nx):
    A = gen.poisson2d(nx, dtype=np.float32, device="cpu")
    data = A.data.clone()
    data[A.offsets.index(-1)] *= 1.3
    data[A.offsets.index(1)] *= 0.7
    return A.with_data(data)


def test_fused_bicgstab_launches_match_plain(dev):
    A = gen.convection_diffusion_3d_27pt(32, device=dev)
    b = ref.dia_spmv(A, torch.from_numpy(np.random.default_rng(0)
                                         .standard_normal(A.shape[0])
                                         .astype(np.float32)).to(dev))
    op = cuda_spmv.ExtendedStencilOperator(A)
    bx = op.extend(b)
    st = cuda_bicgstab.FusedBiCGStabState(op, bx)
    st.run(torch.empty(3, device=dev))
    pl = {k: v.clone() for k, v in dict(
        x=st.x, r=st.r, p=st.p[st.cur], q=st.q[st.cur], s=st.s, t=st.t,
        scal=st.scal, part=st.part).items()}
    z = [torch.zeros_like(bx) for _ in range(4)]
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    scale = float(bx.abs().max())
    cuda_bicgstab.dia_bicgstab_q(op, st.r, st.p[st.cur], st.q[st.cur],
                                 st.rhat, z[0], z[1], st.scal, st.part)
    cuda_bicgstab.dia_bicgstab_q_plain(op, pl["r"], pl["p"], pl["q"],
                                       st.rhat, z[2], z[3], pl["scal"],
                                       pl["part"])
    assert float((z[0] - z[2]).abs().max()) <= 1e-5 * scale
    assert _rel(z[1], z[3]) <= 1e-5
    cuda_bicgstab.dia_bicgstab_t(op, st.r, z[1], st.s, st.t, st.scal,
                                 st.part, st.counter)
    cuda_bicgstab.dia_bicgstab_t_plain(op, pl["r"], z[3], pl["s"], pl["t"],
                                       pl["scal"], pl["part"], cnt)
    assert _rel(st.s, pl["s"]) <= 1e-5 and _rel(st.t, pl["t"]) <= 1e-5
    assert _rel(st.scal, pl["scal"]) <= 1e-5
    hk = torch.zeros(1, device=dev)
    hp = torch.zeros(1, device=dev)
    cuda_bicgstab.dia_bicgstab_update(op, st.x, st.r, z[0], st.s, st.t,
                                      st.rhat, st.scal, st.part, st.counter,
                                      hk)
    cuda_bicgstab.dia_bicgstab_update_plain(op, pl["x"], pl["r"], z[2],
                                            pl["s"], pl["t"], st.rhat,
                                            pl["scal"], pl["part"], cnt, hp)
    assert _rel(st.x, pl["x"]) <= 1e-5 and _rel(st.r, pl["r"]) <= 1e-5
    assert _rel(hk, hp) <= 1e-5 and _rel(st.scal, pl["scal"]) <= 1e-5
    assert int(st.counter) == 0


def test_fused_bicgstab_solve_matches_plain_loop_and_repeats(dev):
    from tpu_sparse_torch.solvers import bicgstab_full

    A = _skewed(64)
    b = ref.dia_spmv(A, torch.from_numpy(np.random.default_rng(1)
                                         .standard_normal(A.shape[0])
                                         .astype(np.float32)))
    Ad, bd = A.to(dev), b.to(dev)
    before = dict(cuda_bicgstab.LAUNCHES)
    xg, ig, itg, _ = cuda_bicgstab.fused_bicgstab_ext(
        cuda_spmv.ExtendedStencilOperator(Ad), bd, tol=1e-5, maxiter=2000)
    assert cuda_bicgstab.LAUNCHES["dia_bicgstab_q"] > before["dia_bicgstab_q"]
    xp, ip, itp, _ = bicgstab_full(Ad, bd, tol=1e-5, maxiter=2000)
    assert int(ig) == int(ip) == 0
    # fused_bicgstab_ext counts the first crossing inside its final block
    # of 12 (the JAX rule), and BiCGStab's residual is not monotone:
    # it may stop up to one block after the loop's first crossing
    assert int(itp) - 2 <= int(itg) <= int(itp) + 12, (int(itg), int(itp))
    assert float(torch.linalg.vector_norm(bd - ref.dia_spmv(Ad, xg))) <= \
        10 * 1e-5 * float(torch.linalg.vector_norm(bd))
    xg2, _, itg2, _ = cuda_bicgstab.fused_bicgstab_ext(
        cuda_spmv.ExtendedStencilOperator(Ad), bd, tol=1e-5, maxiter=2000)
    assert int(itg2) == int(itg) and torch.equal(xg2, xg)


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
@pytest.mark.parametrize("dtype,precision,M", [
    (np.float32, "auto", None), (np.float32, "auto", "jacobi"),
    (np.float64, "auto", None), (np.float64, "full", None),
    (np.float64, "full", "jacobi"),
])
def test_nonsymmetric_solve_on_card_matches_cpu(dev, method, dtype,
                                                precision, M):
    A = gen.convection_diffusion_3d_27pt(24, dtype=dtype, device="cpu")
    x_true = torch.from_numpy(np.random.default_rng(2).standard_normal(
        A.shape[0]).astype(dtype))
    b = ref.dia_spmv(A, x_true)
    tol = 1e-6 if dtype == np.float32 else 1e-9
    kw = dict(method=method, tol=tol, precision=precision, M=M)
    xc, rc = tpu_sparse_torch.solve(A, b, **kw)
    xg, rg = tpu_sparse_torch.solve(A.to(dev), b.to(dev), **kw)
    assert rc.converged and rg.converged
    assert abs(rc.iterations - rg.iterations) <= 2
    rtol = 1e-3 if dtype == np.float32 else 1e-6
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=rtol,
                               atol=rtol * float(xc.abs().max()))


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_adjoint_on_card_matches_cpu(dev, method, dtype):
    make = gen.poisson3d_27pt if method == "cg" \
        else gen.convection_diffusion_3d_27pt
    A = make(16, dtype=dtype, device="cpu")
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]).astype(dtype))
    # float32 GMRES stagnates near 1e-6 on the adjoint system x_bar = 1
    tol = 1e-5 if dtype == np.float32 else 1e-10
    grads = []
    for where in ("cpu", dev):
        data = A.data.to(where, copy=True).requires_grad_()
        bb = b.to(where, copy=True).requires_grad_()
        x, r = tpu_sparse_torch.solve(A.with_data(data), bb, method=method,
                                      tol=tol, maxiter=500, precision="full")
        assert r.converged
        x.sum().backward()
        grads.append((data.grad.cpu(), bb.grad.cpu()))
    rtol = 5e-3 if dtype == np.float32 else 1e-6
    for got, want in zip(grads[1], grads[0]):
        assert _rel(got, want) <= rtol


def _random_csr(n, m, per_row, dtype, seed):
    import scipy.sparse as sp

    from tpu_sparse_torch.sparse.convert import csr_from_arrays

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    S = sp.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                       (rows, rng.integers(0, m, rows.size))), shape=(n, m))
    S.sort_indices()
    return csr_from_arrays(S.data, S.indices, S.indptr, (n, m), device="cpu")


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-5),
                                         (np.float64, 1e-13)])
@pytest.mark.parametrize("n,m,per_row,group", [
    (6000, 5000, 8, 1), (6000, 5000, 8, 2), (6000, 5000, 8, 4),
    (6000, 5000, 8, 8), (1000, 3001, 6, 1), (3001, 1000, 6, 1),
    (300, 200, 5, 1), (1001, 777, 7, 1), (300, 300, 0, 1), (5, 5, 0, 1),
])
def test_cwell_spmv_kernel_matches_plain(dev, n, m, per_row, group, dtype,
                                         bound):
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    W = csr_to_cwell(_random_csr(n, m, per_row, dtype, n + m).to(dev),
                     group=group)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(m).astype(
        dtype)).to(dev)
    before = dict(cuda_cwell.LAUNCHES)
    y0 = ref.cwell_spmv(W, x)
    y1 = cuda_cwell.cwell_spmv_cuda(W, x)
    y2 = tpu_sparse_torch.kernels.spmv(W, x)  # the dispatch runs the kernel
    sfx = "f32" if dtype == np.float32 else "f64"
    assert cuda_cwell.LAUNCHES["cwell_spmv_" + sfx] == \
        before["cwell_spmv_" + sfx] + 2
    assert float((y1 - y0).abs().max()) <= bound * float(y0.abs().max())
    assert torch.equal(y1, y2)  # reruns give the same bits


@pytest.mark.parametrize("group", [1, 4])
def test_cwell_pack_on_card_equals_cpu_pack(dev, group):
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A = to_csr(gen.poisson3d_27pt(24, device="cpu"))
    Wc = csr_to_cwell(A, group=group)
    Wg = csr_to_cwell(A.to(dev), group=group)
    for k in ("vals", "idx2", "srow"):
        assert torch.equal(getattr(Wg, k).cpu(), getattr(Wc, k)), k
    assert Wg.fill == Wc.fill
    Tg, Tc = Wg.tocsr(), Wc.tocsr()
    for k in ("data", "indices", "indptr"):
        assert torch.equal(getattr(Tg, k).cpu(), getattr(Tc, k)), k


def test_cwell_spmv_kernel_refusals(dev):
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    W = csr_to_cwell(_random_csr(300, 200, 5, np.float32, 0).to(dev))
    x = torch.ones(200, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cwell.cwell_spmv_cuda(W, x.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cwell.cwell_spmv_cuda(W.to("cpu"), x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cwell.cwell_spmv_cuda(W, torch.ones(400, device=dev)[::2])
    with pytest.raises(TypeError):
        cuda_cwell.cwell_spmv_cuda(W, x.double())
    with pytest.raises(ValueError, match="length"):
        cuda_cwell.cwell_spmv_cuda(W, torch.ones(201, device=dev))


def test_dense_to_csr_keeps_the_card(dev):
    from tpu_sparse_torch.sparse.convert import dense_to_csr

    Ad = torch.from_numpy(np.random.default_rng(4).standard_normal((30, 20)))
    Ad[Ad.abs() < 1.0] = 0.0
    Cg, Cc = dense_to_csr(Ad.to(dev)), dense_to_csr(Ad)
    for k in ("data", "indices", "indptr"):
        assert getattr(Cg, k).is_cuda
        assert torch.equal(getattr(Cg, k).cpu(), getattr(Cc, k))


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
@pytest.mark.parametrize("dtype,precision,M", [
    (np.float32, "auto", None), (np.float32, "auto", "jacobi"),
    (np.float64, "auto", None), (np.float64, "full", None),
    (np.float64, "full", "jacobi"),
])
def test_cwell_solve_on_card_matches_cpu(dev, method, dtype, precision, M):
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    make = gen.poisson3d_27pt if method == "cg" \
        else gen.convection_diffusion_3d_27pt
    W = csr_to_cwell(to_csr(make(16, dtype=dtype, device="cpu")))
    x_true = torch.from_numpy(np.random.default_rng(2).standard_normal(
        W.shape[0]).astype(dtype))
    b = ref.cwell_spmv(W, x_true)
    tol = 1e-6 if dtype == np.float32 else 1e-9
    kw = dict(method=method, tol=tol, precision=precision, M=M)
    sfx = "f32" if dtype == np.float32 else "f64"
    xc, rc = tpu_sparse_torch.solve(W, b, **kw)
    before = cuda_cwell.LAUNCHES["cwell_spmv_" + sfx]
    xg, rg = tpu_sparse_torch.solve(W.to(dev), b.to(dev), **kw)
    assert cuda_cwell.LAUNCHES["cwell_spmv_" + sfx] > before
    assert rc.converged and rg.converged
    # K4 sums each row's planes in order with fused multiply-adds, the
    # plain version by torch.sum: float32 BiCGStab, whose residual is not
    # monotone, then crosses tol some iterations apart, in a float32 solve
    # and in the float32 inner sweeps of 'auto' (there summed over sweeps)
    slack = 2 if precision == "full" else max(5, rc.iterations // 5)
    assert abs(rc.iterations - rg.iterations) <= slack
    rtol = 1e-3 if dtype == np.float32 else 1e-6
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=rtol,
                               atol=rtol * float(xc.abs().max()))


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_cwell_adjoint_on_card_matches_cpu(dev, method):
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    make = gen.poisson3d_27pt if method == "cg" \
        else gen.convection_diffusion_3d_27pt
    W = csr_to_cwell(to_csr(make(12, dtype=np.float64, device="cpu")))
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        W.shape[0]))
    grads = []
    for where in ("cpu", dev):
        vals = W.vals.to(where, copy=True).requires_grad_()
        bb = b.to(where, copy=True).requires_grad_()
        x, r = tpu_sparse_torch.solve(W.to(where).with_data(vals), bb,
                                      method=method, tol=1e-10, maxiter=500,
                                      precision="full")
        assert r.converged
        x.sum().backward()
        grads.append((vals.grad.cpu(), bb.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        assert _rel(got, want) <= 1e-6


_SPMM_BOUND = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3, 8, 33, 130])
@pytest.mark.parametrize("n,m,per_row,group", [
    (3000, 2500, 8, 1), (3000, 2500, 8, 4), (1001, 777, 7, 2),
    (300, 200, 5, 1), (300, 300, 0, 1),
])
def test_cwell_spmm_kernel_matches_plain(dev, n, m, per_row, group, k, dtype):
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    W = csr_to_cwell(_random_csr(n, m, per_row, dtype, n + m).to(dev),
                     group=group)
    B = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (m, k)).astype(dtype)).to(dev)
    sfx = "f32" if dtype == np.float32 else "f64"
    before = cuda_cwell.LAUNCHES["cwell_spmm_" + sfx]
    Y0 = ref.cwell_spmm(W, B)
    Y1 = cuda_cwell.cwell_spmm_cuda(W, B)
    Y2 = tpu_sparse_torch.kernels.spmm(W, B)  # the dispatch runs the kernel
    assert cuda_cwell.LAUNCHES["cwell_spmm_" + sfx] == before + 2
    assert float((Y1 - Y0).abs().max()) <= \
        _SPMM_BOUND[dtype] * float(Y0.abs().max())
    assert torch.equal(Y1, Y2)  # reruns give the same bits


def _block_dense(nb, bs, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((nb, nb)) < density
    np.fill_diagonal(mask, True)
    A = np.zeros((nb * bs, nb * bs))
    for i, j in zip(*np.nonzero(mask)):
        A[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.standard_normal(
            (bs, bs))
    return A


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 5, 130, 300])
@pytest.mark.parametrize("nb,bs,pad", [(40, 8, 0), (40, 8, 4), (30, 3, 1),
                                       (6, 64, 1)])
def test_bell_spmm_kernel_matches_plain(dev, nb, bs, pad, k, dtype):
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import dense_to_csr

    Ad = torch.from_numpy(_block_dense(nb, bs, 0.3, nb + bs).astype(dtype))
    S = csr_to_bsr(dense_to_csr(Ad.to(dev)), bs)
    A = bsr_to_bell(S, ell_width=int(torch.diff(S.indptr.long()).max())
                    + pad)
    B = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (nb * bs, k)).astype(dtype)).to(dev)
    sfx = "f32" if dtype == np.float32 else "f64"
    before = cuda_bell.LAUNCHES["bell_spmm_" + sfx]
    Y0 = ref.bell_spmm(A, B)
    Y1 = cuda_bell.bell_spmm_cuda(A, B)
    Y2 = A @ B
    assert cuda_bell.LAUNCHES["bell_spmm_" + sfx] == before + 2
    assert float((Y1 - Y0).abs().max()) <= \
        _SPMM_BOUND[dtype] * float(Y0.abs().max())
    assert torch.equal(Y1, Y2)
    torch.testing.assert_close(Y1.cpu(), Ad @ B.cpu(), rtol=1e-4, atol=1e-4)


def test_spmm_kernel_refusals(dev):
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import dense_to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    W = csr_to_cwell(_random_csr(300, 200, 5, np.float32, 0).to(dev))
    A = bsr_to_bell(csr_to_bsr(dense_to_csr(torch.eye(64, device=dev)), 8))
    for fn, op, m in ((cuda_cwell.cwell_spmm_cuda, W, 200),
                      (cuda_bell.bell_spmm_cuda, A, 64)):
        B = torch.ones(m, 3, device=dev)
        with pytest.raises(ValueError, match="CUDA"):
            fn(op, B.cpu())
        with pytest.raises(ValueError, match="CUDA"):
            fn(op.to("cpu"), B)
        with pytest.raises(TypeError):
            fn(op, B.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(op, torch.ones(m, 6, device=dev)[:, ::2])
        with pytest.raises(ValueError, match="shape"):
            fn(op, torch.ones(m + 1, 3, device=dev))
    big = A.with_data(torch.ones(8, 1, 72, 72, device=dev))
    with pytest.raises(ValueError, match="exceeds"):
        cuda_bell.bell_spmm_cuda(big, torch.ones(64, 3, device=dev))


def test_bell_spmv_on_card_runs_k4_on_the_repack(dev):
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.bell import block_cwell
    from tpu_sparse_torch.sparse.convert import dense_to_csr

    Ad = torch.from_numpy(_block_dense(40, 8, 0.3, 5))
    A = bsr_to_bell(csr_to_bsr(dense_to_csr(Ad.to(dev)), 8))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(320)).to(dev)
    before = dict(cuda_cwell.LAUNCHES)
    y = tpu_sparse_torch.kernels.spmv(A, x)
    assert cuda_cwell.LAUNCHES["cwell_spmv_f64"] == \
        before["cwell_spmv_f64"] + 1
    assert block_cwell(A) is block_cwell(A)  # repacked once
    assert _rel(y, ref.bell_spmv(A, x)) <= 1e-13


@pytest.mark.parametrize("operand", ["dia", "cwell", "bell"])
@pytest.mark.parametrize("method,multi_rhs", [("cg", "auto"),
                                              ("cg", "block"),
                                              ("bicgstab", "auto"),
                                              ("gmres", "auto")])
@pytest.mark.parametrize("dtype,precision", [(np.float32, "full"),
                                             (np.float64, "full"),
                                             (np.float64, "auto")])
def test_multirhs_solve_on_card_matches_cpu(dev, operand, method, multi_rhs,
                                            dtype, precision):
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import dense_to_csr, to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    make = gen.poisson3d_27pt if method == "cg" \
        else gen.convection_diffusion_3d_27pt
    A = make(12, dtype=dtype, device="cpu")
    if operand == "cwell":
        A = csr_to_cwell(to_csr(A))
    elif operand == "bell":
        # diagonally dominant (and symmetric for cg) 8 x 8 block matrix
        Ad = _block_dense(24, 8, 0.2, 7)
        if method == "cg":
            Ad = Ad + Ad.T
        Ad = torch.from_numpy((Ad + 2 * 192 * np.eye(192)).astype(dtype))
        A = bsr_to_bell(csr_to_bsr(dense_to_csr(Ad), 8))
    B = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (A.shape[0], 3)).astype(dtype))
    tol = 1e-6 if dtype == np.float32 else 1e-9
    kw = dict(method=method, multi_rhs=multi_rhs, tol=tol,
              precision=precision, maxiter=500)
    Xc, rc = tpu_sparse_torch.solve(A, B, **kw)
    before = {**cuda_cwell.LAUNCHES, **cuda_bell.LAUNCHES}
    Xg, rg = tpu_sparse_torch.solve(A.to(dev), B.to(dev), **kw)
    after = {**cuda_cwell.LAUNCHES, **cuda_bell.LAUNCHES}
    carrier = {"cwell": "cwell_spmm_", "bell": "bell_spmm_"}.get(operand)
    # 'auto' stays full precision under multi_rhs='block'
    full64 = dtype == np.float64 and (precision == "full"
                                      or multi_rhs == "block")
    if carrier is not None:
        sfx = "f64" if full64 else "f32"
        assert after[carrier + sfx] > before[carrier + sfx]
    assert rc.converged and rg.converged
    # float32 arithmetic (a float32 solve, the float32 sweeps of 'auto')
    # sums in another order on the card: see test_cwell_solve_on_card
    slack = 2 if full64 else max(5, rc.iterations // 5)
    assert abs(rc.iterations - rg.iterations) <= slack
    rtol = 1e-3 if dtype == np.float32 else 1e-6
    np.testing.assert_allclose(Xg.cpu().numpy(), Xc.numpy(), rtol=rtol,
                               atol=rtol * float(Xc.abs().max()))
