"""tpu_sparse_torch CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine that has only torch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)

Tolerances: SpMV rel 1e-5 (f32) / 1e-13 (f64) against the plain version
(the kernel fuses multiply-adds); fused CG iterations within 1 of the plain
fused loop (dot products accumulate in double in the kernels) and x
rtol 5e-3 / atol 5e-4.
"""

import numpy as np
import pytest
import torch

import tpu_sparse_torch
from tpu_sparse_torch.kernels import cuda_cg, cuda_spmv
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
    lambda dt: gen.tridiagonal(1500, dtype=dt),
    lambda dt: gen.poisson2d(40, dtype=dt),
    lambda dt: gen.poisson3d_27pt(13, 11, 7, dtype=dt),
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
    A = gen.poisson2d(64, dtype=np.float32)
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
    A = gen.poisson3d_27pt(24, dtype=dtype)
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
