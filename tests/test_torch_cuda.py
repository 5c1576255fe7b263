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
the CPU, both at tol 1e-5) / 1e-6 (f64). K4 / K5 (CWELL SpMV on the
row-compact plan): 1e-5 / 1e-13 of max|y| against the plain version,
exactly 0 where y is 0, and bit-identical reruns; one plan per pack
structure and one value gather per values tensor, exactly; the card's
pack byte-equal to the CPU's; solves on
CWELL as on DIA, but paths with float32 arithmetic within 5 iterations
or a fifth of the count (see the test). K6/K7 (CWELL SpMM) and K8 (BELL
SpMM): 1e-5 (f32) / 1e-12 (f64) of max|Y| against the plain version,
bit-identical reruns; multi-RHS solves on the card against the CPU with
the CWELL solves' iteration slack and x tolerances. AMG: the card's
V-cycle against the same cycle on the plain versions and the block cycle
against the single ones within 1e-5 (f32) / 1e-12 (f64) of max|y|;
preconditioned solves on the card against the CPU with the slack and x
tolerances above (f64 rtol 1e-8); the lid-driven cavity's fields on the
card within 1e-8 of the CPU's after 20 steps. Direct solves: PCR and
block PCR on the card within 1e-10 (f64) / 1e-4 (f32) of the CPU's
Thomas and banded LU; the supernodal router path and SparseLU to a true
relative residual of 1e-10 (f64) / 1e-5 (f32) on a consistent b, as the
CPU's host SuperLU; gradients within 1e-10 / 1e-4 of the CPU's. ILU(0):
the card's factor equal to the CPU's (the same host code), one apply
(K4 / K5 per level pack) and a block apply (K6/K7) within 1e-12 (f64) /
1e-5 (f32) of the CPU's plain sweeps; ILU-preconditioned solves on the
card against the CPU with the slack and x tolerances above. bf16 builds
(kernel 1 both modes, K4, K6/K7, K8): a float32 output within 1e-5 of
max|y| of the plain version (``reference.dia_spmv_wide`` / the compact
versions / ``bell_spmm_wide``), a bf16 output within one bf16 ulp of |y|
element-wise plus 1e-6 of max|y| (the float32 sums round differently
near ties); on bf16-exact values with a float32 operand equal to the
float32 build bit for bit; K6/K7 columns equal to K4 bit for bit.
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
        cuda_spmv.dia_spmv_cuda(A.with_data(A.data.to(torch.float16)),
                                x.to(torch.float16))


# ---- kernel 1's plain mode against the first design (v1), every build -----

_KERNEL1_BUILDS = {"f32": (torch.float32, torch.float32),
                   "f64": (torch.float64, torch.float64),
                   "c64": (torch.complex64, torch.complex64),
                   "c128": (torch.complex128, torch.complex128),
                   "bf16": (torch.bfloat16, torch.bfloat16),
                   "bf16_f32": (torch.bfloat16, torch.float32)}
# rows enough for two CTAs a SM at 8 rows a thread on 132 SMs, so the
# shipped designs' R-row paths run; not a multiple of any R
_KERNEL1_N = 786_435


def _bits(t):
    """t's bit pattern as integers (NaNs compare by their bits)."""
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _kernel1_case(case, sfx, dev):
    """(A, x) of a kernel-1 edge case in build ``sfx``, on the card."""
    rng = np.random.default_rng(100 * _KERNEL1_CASES.index(case)
                                + list(_KERNEL1_BUILDS).index(sfx))
    vdt, xdt = _KERNEL1_BUILDS[sfx]
    n, m, ld = _KERNEL1_N, _KERNEL1_N, _KERNEL1_N
    offsets = (-700, -1, 0, 1, 700)
    if case == "below one tile":
        n = m = ld = 37
        offsets = (-3, 0, 1, 5)
    elif case == "rectangular, more rows":
        m = 500_001
    elif case == "rectangular, more columns":
        m = 1_000_003
    elif case == "ld > n":
        ld = _KERNEL1_N + 5   # a multiple of 8
    elif case == "ndiag 1":
        offsets = (7,)
    elif case == "ndiag 64":
        n = m = ld = 300_003
        offsets = tuple(range(-40, 24))
    elif case == "a diagonal outside":
        offsets = (-(n + 3), -2, 0, 3, m + 10)

    def rand(shape):
        v = torch.from_numpy(rng.standard_normal(shape))
        if vdt.is_complex:
            v = v + 1j * torch.from_numpy(rng.standard_normal(shape))
        return v

    flat = rand(len(offsets) * ld + 1).to(dev, vdt)
    if case == "unaligned data":  # one value past an aligned start
        data = flat[1:].view(len(offsets), ld)
    else:
        data = flat[:-1].view(len(offsets), ld)
    x = rand(m).to(dev, xdt)
    if case == "non-finite x":
        x[[0, 5, m // 2, m - 1]] = torch.tensor(
            [float("nan"), float("inf"), float("-inf"), float("nan")],
            dtype=torch.float64).to(dev, xdt)
    if case == "non-finite data out of range":
        rows = torch.arange(n, device=dev)
        for d, o in enumerate(offsets):
            out = (rows + o < 0) | (rows + o >= m)
            data[d, :n][out] = float("nan") if d % 2 else float("inf")
    from tpu_sparse_torch.sparse.containers import DIA

    return DIA(data, offsets, (n, m)), x


_KERNEL1_CASES = ["below one tile", "n not a multiple of R",
                  "rectangular, more rows", "rectangular, more columns",
                  "ld > n", "unaligned data", "ndiag 1", "ndiag 64",
                  "a diagonal outside", "non-finite x",
                  "non-finite data out of range"]


@pytest.mark.parametrize("sfx", list(_KERNEL1_BUILDS))
@pytest.mark.parametrize("case", _KERNEL1_CASES)
def test_kernel1_plain_equals_v1_and_plain(dev, case, sfx):
    """The shipped plain mode equals the first design (v1) bit for bit and meets
    the plain version's limits; one counted launch."""
    A, x = _kernel1_case(case, sfx, dev)
    if case == "unaligned data":  # c128: one value is 16 bytes
        assert A.data.data_ptr() % 16 != 0 or sfx == "c128"
    before = cuda_spmv.LAUNCHES["dia_spmv_" + sfx]
    y = cuda_spmv.dia_spmv_cuda(A, x)
    assert cuda_spmv.LAUNCHES["dia_spmv_" + sfx] == before + 1
    y_v1 = cuda_spmv.dia_spmv_v1_cuda(A, x)
    assert cuda_spmv.LAUNCHES["dia_spmv_" + sfx] == before + 1
    torch.cuda.synchronize()
    assert y.shape == (A.shape[0],) and y.dtype == x.dtype
    assert torch.equal(_bits(y), _bits(y_v1))
    Ap = A.with_data(A.data[:, :A.shape[0]])
    y0 = (ref.dia_spmv_wide if sfx.startswith("bf16") else
          ref.dia_spmv)(Ap, x)
    bad = ~torch.isfinite(y0)
    assert torch.equal(bad, ~torch.isfinite(y))
    if case == "non-finite data out of range":
        assert not bool(bad.any())
    y, y0 = y[~bad], y0[~bad]
    if sfx == "bf16":
        assert _bf16_close(y, y0)
    else:
        tol = {"f64": 1e-13, "c128": 1e-12}.get(sfx, 1e-5)
        assert float((y - y0).abs().max()) <= \
            tol * float(y0.abs().max())


@pytest.mark.parametrize("sfx", list(_KERNEL1_BUILDS))
def test_kernel1_geometry_host_entry_equals_mirror(dev, sfx):
    """The C host entry's launch geometry equals cuda_spmv.plain_geometry
    on the main-path shapes and the edge cases."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    offsets_27 = [dz * 25600 + dy * 160 + dx for dz in (-1, 0, 1)
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    shapes = [(offsets_27, 160 ** 3, 160 ** 3, 160 ** 3),
              ([-256, -1, 0, 1, 256], 65536, 65536, 65536),
              ([-3, 0, 1, 5], 37, 37, 37), ([7], 786_435, 786_435, 786_440),
              ([-900, 0, 2000], 786_432, 500_001, 786_432), ([], 10, 10, 10)]
    for offsets, n, m, ld in shapes:
        for ptr in (1 << 20, (1 << 20) + 2, (1 << 20) + 8):
            assert cuda_spmv.plain_geometry_cuda(
                sfx, offsets, n, m, ld, ptr, sms) == \
                cuda_spmv.plain_geometry(sfx, offsets, n, m, ld, ptr, sms)


def test_kernel1_probe_designs_equal_v1(dev):
    """Every design the kernel-1 probe instantiates equals v1 bit for bit
    on a 27-point stencil and a ragged 5-point one, in f32 and bf16_f32."""
    import tempfile
    from pathlib import Path

    from tpu_sparse_torch.kernels import _build, dia_spmv_probe

    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        lib, _ = dia_spmv_probe.build_designs(Path(tmp))
        for sfx in ("f32", "bf16_f32"):
            for A in (gen.poisson3d_27pt(40, device="cpu"),
                      gen.poisson2d(700, dtype=np.float32, device="cpu")):
                vdt = torch.bfloat16 if sfx == "bf16_f32" else torch.float32
                A = A.with_data(A.data.to(vdt)).to(dev)
                n = A.shape[0]
                x = torch.from_numpy(np.random.default_rng(3)
                                     .standard_normal(n)).to(dev,
                                                             torch.float32)
                y_v1 = cuda_spmv.dia_spmv_v1_cuda(A, x)
                offs, offs_ptr = _build.int_array(A.offsets)
                for spec in dia_spmv_probe.designs(sfx).values():
                    y = torch.empty_like(y_v1)
                    fn = getattr(lib, dia_spmv_probe.symbol(spec, sfx))
                    assert fn(A.data.data_ptr(), A.data.shape[1], offs_ptr,
                              len(A.offsets), x.data_ptr(), y.data_ptr(), n,
                              n, stream) == 0
                    assert torch.equal(y, y_v1), spec


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


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-5),
                                         (np.float64, 1e-13)])
def test_cwell_spmv_kernel_wide_plan(dev, dtype, bound):
    """A pack of more than 256 planes runs the int32-column instance."""
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse.convert import dense_to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A = _random_csr(300, 600, 4, dtype, 3).todense()
    A[5] = torch.arange(1, 601, dtype=A.dtype)  # one row over 3 windows
    W = csr_to_cwell(dense_to_csr(A.to(dev)))
    assert W.planes > 256
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(600).astype(
        dtype)).to(dev)
    y0, y1 = ref.cwell_spmv(W, x), cuda_cwell.cwell_spmv_cuda(W, x)
    assert cwell_compact.compact(W)[0].wide
    assert float((y1 - y0).abs().max()) <= bound * float(y0.abs().max())
    assert torch.equal(y1, cuda_cwell.cwell_spmv_cuda(W, x))


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-5),
                                         (np.float64, 1e-13)])
def test_cwell_spmv_kernel_alternating_packs(dev, dtype, bound):
    """Launches that alternate between packs of different plane counts
    (so different shared-memory sizes for the float ring) all run and
    agree with the plain version."""
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    packs = [csr_to_cwell(_random_csr(n, m, k, dtype, n + m).to(dev))
             for n, m, k in ((2000, 9000, 12), (700, 300, 3), (1500, 2600, 7))]
    assert len({W.planes for W in packs}) == 3
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal(W.shape[1]).astype(dtype)).to(
        dev) for W in packs]
    for i in (0, 1, 0, 2, 1, 2, 0):
        W, x = packs[i], xs[i]
        y0, y1 = ref.cwell_spmv(W, x), cuda_cwell.cwell_spmv_cuda(W, x)
        assert float((y1 - y0).abs().max()) <= bound * float(y0.abs().max())


def test_cwell_spmv_plan_counts_and_nan(dev):
    """One plan per pack structure, one value gather per values tensor;
    a NaN in a column no nonzero names stays out of y."""
    from tpu_sparse_torch.sparse.convert import dense_to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A = _random_csr(1000, 900, 6, np.float32, 4).todense()
    A[:, 0] = 0.0  # column 0 is empty
    W = csr_to_cwell(dense_to_csr(A.to(dev)))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(900).astype(
        np.float32)).to(dev)
    cuda_cwell.reset_launch_counts()
    y1 = cuda_cwell.cwell_spmv_cuda(W, x)
    y2 = cuda_cwell.cwell_spmv_cuda(W, x)
    y3 = cuda_cwell.cwell_spmv_cuda(W.with_data(W.vals * 2.0), x)
    y4 = cuda_cwell.cwell_spmv_cuda(W.with_data(W.vals.double()), x.double())
    assert cuda_cwell.PLAN_COUNTS == {"plan_builds": 1, "value_gathers": 3}
    assert cuda_cwell.LAUNCHES["cwell_spmv_f32"] == 3
    assert cuda_cwell.LAUNCHES["cwell_spmv_f64"] == 1
    assert torch.equal(y1, y2) and torch.equal(y3, 2.0 * y1)
    assert float((y4 - ref.cwell_spmv(W, x).double()).abs().max()) <= \
        1e-5 * float(y4.abs().max())
    x[0] = float("nan")
    assert torch.equal(cuda_cwell.cwell_spmv_cuda(W, x), y1)


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


def _spmm_edge_csr(case, dtype):
    """(CSR on the CPU, m) of one edge case of K6/K7."""
    from tpu_sparse_torch.sparse.convert import dense_to_csr

    if case == "grouped 3000x2500":
        return _random_csr(3000, 2500, 8, dtype, 61), 2500
    if case == "n, m not x128":
        return _random_csr(1001, 777, 7, dtype, 62), 777
    Ad = _random_csr(300, 600 if case == "wide" else 2500, 4, dtype,
                     63).todense()
    if case == "wide":  # a row over 600 columns: more than 256 planes
        Ad[5] = torch.arange(1, 601, dtype=Ad.dtype)
    elif case == "a row of 150":  # narrow, streamed in pieces
        Ad[5, torch.from_numpy(np.random.default_rng(3).choice(
            2500, 150, replace=False))] = 1.5
    else:  # empty rows and columns
        Ad[100:200] = 0
        Ad[:, 50:400] = 0
    return dense_to_csr(Ad), Ad.shape[1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 7, 8, 33, 129])
@pytest.mark.parametrize("case", ["grouped 3000x2500", "n, m not x128",
                                  "wide", "a row of 150",
                                  "empty rows and columns"])
def test_cwell_spmm_kernel_on_the_plan_edge_cases(dev, case, k, dtype):
    """K6/K7 against its plain version on the compact plan (1e-5 / 1e-12
    of max|Y|), and every column against K4/K5 bit for bit."""
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A, m = _spmm_edge_csr(case, dtype)
    W = csr_to_cwell(A.to(dev), group=2 if case.startswith("grouped")
                     else 1)
    plan, cv = cwell_compact.compact(W)
    assert plan.wide == (case == "wide")
    B = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (m, k)).astype(dtype)).to(dev)
    Y0 = ref.cwell_compact_spmm(plan, cv, B)
    Y1 = cuda_cwell.cwell_spmm_cuda(W, B)
    assert float((Y1 - Y0).abs().max()) <= \
        _SPMM_BOUND[dtype] * float(Y0.abs().max())
    for j in range(k):
        assert torch.equal(Y1[:, j], cuda_cwell.cwell_spmv_cuda(
            W, B[:, j].contiguous()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cwell_spmm_kernel_on_segments(dev, dtype):
    from tpu_sparse_torch.kernels import _cwellseg_apply
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell_segments

    Seg = csr_to_cwell_segments(_random_csr(600, 1500, 9, dtype, 64).to(dev),
                                seg_cols=256)
    B = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1500, 8)).astype(dtype)).to(dev)
    sfx = "f32" if dtype == np.float32 else "f64"
    before = cuda_cwell.LAUNCHES["cwell_spmm_" + sfx]
    Y = tpu_sparse_torch.kernels.spmm(Seg, B)
    assert cuda_cwell.LAUNCHES["cwell_spmm_" + sfx] == \
        before + len(Seg.segments)
    Y0 = _cwellseg_apply(Seg, B, lambda W, X: ref.cwell_compact_spmm(
        *cwell_compact.compact(W), X))
    assert float((Y - Y0).abs().max()) <= \
        _SPMM_BOUND[dtype] * float(Y0.abs().max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [7, 8, 33])
@pytest.mark.parametrize("nb,bs,pad", [(50, 1, 3), (30, 3, 2), (40, 8, 5),
                                       (12, 16, 1), (6, 64, 1)])
def test_bell_spmm_kernel_block_sizes(dev, nb, bs, pad, k, dtype):
    """K8 at bs 1, 3, 8, 16, 64 with padding blocks, against its plain
    version."""
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import dense_to_csr

    Ad = torch.from_numpy(_block_dense(nb, bs, 0.3, nb + bs + 1).astype(
        dtype))
    S = csr_to_bsr(dense_to_csr(Ad.to(dev)), bs)
    A = bsr_to_bell(S, ell_width=int(torch.diff(S.indptr.long()).max())
                    + pad)
    B = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (nb * bs, k)).astype(dtype)).to(dev)
    Y0 = ref.bell_spmm(A, B)
    Y1 = cuda_bell.bell_spmm_cuda(A, B)
    assert float((Y1 - Y0).abs().max()) <= \
        _SPMM_BOUND[dtype] * float(Y0.abs().max())
    assert torch.equal(Y1, cuda_bell.bell_spmm_cuda(A, B))


@pytest.mark.parametrize("operand", ["cwell", "bell"])
def test_nan_read_only_by_zero_values_on_card(dev, operand):
    """A NaN in x at a column that only padding or zero values read:
    ``W @ x`` (K4) and ``(W @ x[:, None])[:, 0]`` (K6/K7 or K8) are finite
    and agree (bit for bit on CWELL, where both sum in slot order)."""
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import dense_to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    if operand == "cwell":
        Ad = _random_csr(400, 300, 4, np.float64, 65).todense()
        Ad[:, 0] = 0  # column 0 empty: only padding slots read it
        W = csr_to_cwell(dense_to_csr(Ad).to(dev))
        assert bool(((W.gcols() == 0) & (W.vals == 0)).any())
    else:
        Ad = torch.from_numpy(_block_dense(10, 4, 0.3, 66))
        Ad[:, :4] = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (40, 4)))
        Ad[:, 0] = 0  # stored in every block row's block column 0, as 0
        S = csr_to_bsr(dense_to_csr(Ad.to(dev)), 4)
        W = bsr_to_bell(S, ell_width=int(torch.diff(S.indptr.long()).max())
                        + 2)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        Ad.shape[1])).to(dev)
    x[0] = float("nan")
    y1 = W @ x
    y2 = (W @ x[:, None].contiguous())[:, 0]
    assert bool(torch.isfinite(y1).all()) and bool(torch.isfinite(y2).all())
    if operand == "cwell":
        assert torch.equal(y1, y2)
    else:
        assert _rel(y2, y1) <= 1e-13
    x[0] = 0.0
    assert torch.equal(y1, W @ x)


def test_spmm_probe_designs_agree(dev):
    """Every design the SpMM probe instantiates agrees with the shipped
    kernels: K6/K7's bit for bit on a pack at k = 8 and 33, K8's within
    1e-5 of max|Y| at bs = 8."""
    import tempfile
    from pathlib import Path

    from tpu_sparse_torch.kernels import spmm_probe
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr, cwell_compact
    from tpu_sparse_torch.sparse.convert import dense_to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        lib, _ = spmm_probe.build_designs(Path(tmp))
        W = csr_to_cwell(_random_csr(3000, 2500, 8, np.float32, 67).to(dev))
        plan, cv = cwell_compact.compact(W)
        for k in (8, 33):
            B = torch.from_numpy(np.random.default_rng(k).standard_normal(
                (2500, k)).astype(np.float32)).to(dev)
            Y = cuda_cwell.cwell_spmm_cuda(W, B)
            for d in spmm_probe.CWELL_DESIGNS.values():
                Yd = torch.empty_like(Y)
                fn = getattr(lib, spmm_probe._cwell_symbol(d, "f32"))
                if d is None:
                    rc = fn(W.vals.data_ptr(), W.idx2.data_ptr(),
                            W.srow.data_ptr(), B.data_ptr(), Yd.data_ptr(),
                            W.n_blocks, W.planes, 3000, 2500, k, stream)
                else:
                    rc = fn(cv.data_ptr(), plan.idx.data_ptr(),
                            plan.srow.data_ptr(), plan.boff.data_ptr(),
                            B.data_ptr(), Yd.data_ptr(), plan.n_blocks,
                            plan.planes, 3000, k, plan.depth, 0, stream)
                assert rc == 0
                assert torch.equal(Yd, Y) if d is not None else \
                    _rel(Yd, Y) <= 1e-5
        Ad = torch.from_numpy(_block_dense(40, 8, 0.3, 68).astype(
            np.float32))
        A = bsr_to_bell(csr_to_bsr(dense_to_csr(Ad.to(dev)), 8))
        B = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (320, 8)).astype(np.float32)).to(dev)
        Y = cuda_bell.bell_spmm_cuda(A, B)
        for d in spmm_probe.BELL_DESIGNS.values():
            Yd = torch.empty_like(Y)
            fn = getattr(lib, spmm_probe._bell_symbol(d, "f32"))
            assert fn(A.blocks.data_ptr(), A.indices.data_ptr(),
                      B.data_ptr(), Yd.data_ptr(), A.n_block_rows,
                      A.ell_width, 8, 320, 8, stream) == 0
            assert _rel(Yd, Y) <= 1e-5


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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_amg_hierarchy_on_card_runs_kernels_and_matches_plain(dev, dtype):
    """The card's hierarchy (DIA fine level: kernel 1 / K3; CWELL R and
    tentative P: K4 / K5; dense small levels) against the same cycle with
    the plain versions, within 1e-5 (f32) / 1e-12 (f64) of max|y|; the
    block cycle's columns against the single cycles (gemm against gemv on
    the dense levels: same bounds)."""
    from tpu_sparse_torch.precond import amg as tamg
    from tpu_sparse_torch.sparse.cwell import CWELL

    A = gen.poisson3d_27pt(40, dtype=dtype, device=dev)
    M = tamg.amg_preconditioner(A)
    lv0 = M.hier.levels[0]
    assert isinstance(lv0.R, CWELL) and isinstance(lv0.P, CWELL)
    assert any(isinstance(lv.A, torch.Tensor) for lv in M.hier.levels)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        A.shape[0]).astype(dtype)).to(dev)
    sfx = "f32" if dtype == np.float32 else "f64"
    before = {**cuda_spmv.LAUNCHES, **cuda_cwell.LAUNCHES}
    y = M(b)
    assert cuda_spmv.LAUNCHES["dia_spmv_" + sfx] > before["dia_spmv_" + sfx]
    assert cuda_cwell.LAUNCHES["cwell_spmv_" + sfx] > \
        before["cwell_spmv_" + sfx]
    y0 = tamg.v_cycle(M.hier, b, pre_sweeps=1, post_sweeps=1, omega=0.9,
                      plain=True)
    bound = 1e-5 if dtype == np.float32 else 1e-12
    assert _rel(y, y0) <= bound
    B = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (A.shape[0], 4)).astype(dtype)).to(dev)
    Y = M.matmat(B)
    for j in range(4):
        assert _rel(Y[:, j], M(B[:, j].contiguous())) <= bound


@pytest.mark.parametrize("kw", [dict(backend="amg"),
                                dict(backend="amg", accelerant=None),
                                dict(M="amg"), dict(M="chebyshev"),
                                dict(M="neumann"), dict(M="fsai"),
                                dict(M="fsai2")],
                         ids=["amg", "stationary", "M-amg", "chebyshev",
                              "neumann", "fsai", "fsai2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_preconditioned_solve_on_card_matches_cpu(dev, kw, dtype):
    A = gen.poisson3d_27pt(16, dtype=dtype, device="cpu")
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        A.shape[0]).astype(dtype))
    tol = 1e-6 if dtype == np.float32 else 1e-10
    kw = dict(kw, tol=tol, precision="full", maxiter=500)
    xc, rc = tpu_sparse_torch.solve(A, b, **kw)
    xg, rg = tpu_sparse_torch.solve(A.to(dev), b.to(dev), **kw)
    assert rc.converged and rg.converged
    slack = 2 if dtype == np.float64 else max(5, rc.iterations // 5)
    assert abs(rc.iterations - rg.iterations) <= slack
    rtol = 1e-3 if dtype == np.float32 else 1e-8
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=rtol,
                               atol=rtol * float(xc.abs().max()))


def test_block_amg_solve_on_card_runs_spmm(dev):
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    W = csr_to_cwell(to_csr(gen.poisson3d_27pt(24, device=dev)))
    B = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (W.shape[0], 4)).astype(np.float32)).to(dev)
    before = cuda_cwell.LAUNCHES["cwell_spmm_f32"]
    X, res = tpu_sparse_torch.solve(W, B, backend="amg", tol=1e-6)
    assert res.converged and res.backend == "amg"
    assert cuda_cwell.LAUNCHES["cwell_spmm_f32"] > before
    r = B - ref.cwell_spmm(W, X)
    assert float((r.norm(dim=0) / B.norm(dim=0)).max()) <= 1e-5


@pytest.mark.parametrize("precond", ["jacobi", "amg", "fsai"])
def test_ldc_on_card_matches_cpu(dev, precond):
    from tpu_sparse_torch.apps import ldc

    kw = dict(nx=24, Re=400.0, precond=precond)
    card = ldc.LDCSolver(ldc.LDCConfig(device="cuda", **kw))
    cpu = ldc.LDCSolver(ldc.LDCConfig(device="cpu", **kw))
    before = cuda_spmv.LAUNCHES["dia_spmv_f64"]
    card.run(20)
    cpu.run(20)
    assert cuda_spmv.LAUNCHES["dia_spmv_f64"] > before
    for name in ("u", "v", "p"):
        assert float((getattr(card, name).cpu()
                      - getattr(cpu, name)).abs().max()) <= 1e-8


def _shift_27pt(A, nx):
    """A - sigma I for A = poisson3d_27pt(nx) = 27 I - J (x) J (x) J, sigma
    halfway between its two smallest eigenvalues 27 - prod(1 + 2 cos(pi
    k_i / (nx + 1))): symmetric with one negative mode."""
    c = [1 + 2 * np.cos(np.pi * k / (nx + 1)) for k in (1, 2)]
    sigma = 27 - c[0] ** 2 * (c[0] + c[1]) / 2
    data = A.data.clone()
    data[A.offsets.index(0)] -= sigma
    return A.with_data(data)


def _more_system(method, nx, dtype, device="cpu"):
    if method == "fgmres":
        return gen.convection_diffusion_3d_27pt(nx, dtype=dtype,
                                                device=device)
    A = gen.poisson3d_27pt(nx, dtype=dtype, device=device)
    return _shift_27pt(A, nx) if method == "minres" else A


@pytest.mark.parametrize("operand", ["dia", "cwell"])
@pytest.mark.parametrize("method,dtype,precision,M", [
    (m, *case) for m in ("cg_sr", "fcg", "minres", "fgmres")
    for case in ((np.float32, "auto", None), (np.float32, "auto", "jacobi"),
                 (np.float64, "auto", None), (np.float64, "full", None))
    # MINRES with M stops on the M-norm residual estimate, whose true
    # residual a float32 solve does not hold to tol
    if not (m == "minres" and case[2] == "jacobi")])
def test_more_solvers_on_card_match_cpu(dev, method, operand, dtype,
                                        precision, M):
    """Single-reduction CG, FCG, MINRES (on the shifted, indefinite
    system) and FGMRES: the general path on the card (kernel 1 or K4; the
    fp64 kernel and the extended kernel 1 in the f64 'auto' sweeps)
    against the CPU, with the CWELL solves' iteration slack."""
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A = _more_system(method, 12, dtype)
    if operand == "cwell":
        A = csr_to_cwell(to_csr(A))
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        A.shape[0]).astype(dtype))
    tol = 1e-5 if dtype == np.float32 else 1e-9
    kw = dict(method=method, tol=tol, precision=precision, M=M,
              maxiter=3000)
    xc, rc = tpu_sparse_torch.solve(A, b, **kw)
    before = {**cuda_spmv.LAUNCHES, **cuda_cwell.LAUNCHES}
    xg, rg = tpu_sparse_torch.solve(A.to(dev), b.to(dev), **kw)
    after = {**cuda_spmv.LAUNCHES, **cuda_cwell.LAUNCHES}
    grew = {k for k in after if after[k] > before[k]}
    if operand == "cwell":
        assert ("cwell_spmv_f32" if dtype == np.float32 or precision == "auto"
                else "cwell_spmv_f64") in grew
    elif dtype == np.float64 and precision == "auto":
        assert {"dia_spmv_ext_f64", "dia_spmv_ext_f32"} <= grew
    else:
        assert ("dia_spmv_f32" if dtype == np.float32
                else "dia_spmv_f64") in grew
    assert rc.converged and rg.converged
    full64 = dtype == np.float64 and precision == "full"
    slack = 2 if full64 else max(5, rc.iterations // 5)
    assert abs(rc.iterations - rg.iterations) <= slack
    rtol = 1e-3 if dtype == np.float32 else 1e-6
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=rtol,
                               atol=rtol * float(xc.abs().max()))


@pytest.mark.parametrize("method,M", [("fcg", "jacobi"), ("minres", None),
                                      ("fgmres", None)])
def test_more_batched_on_card_match_singles(dev, method, M):
    """batch_fcg / batch_minres / batch_fgmres on a CWELL: every matvec one
    K6/K7 launch, every column within the CWELL slack of its single-RHS
    solve on the card (K6/K7 column j equals K4 bit for bit)."""
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    W = csr_to_cwell(to_csr(_more_system(method, 12, np.float32, dev)))
    B = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (W.shape[0], 3)).astype(np.float32)).to(dev)
    kw = dict(method=method, tol=1e-5, maxiter=3000, M=M)
    before = dict(cuda_cwell.LAUNCHES)
    X, res = tpu_sparse_torch.solve(W, B, **kw)
    assert res.converged
    assert cuda_cwell.LAUNCHES["cwell_spmm_f32"] > before["cwell_spmm_f32"]
    assert cuda_cwell.LAUNCHES["cwell_spmv_f32"] == \
        before["cwell_spmv_f32"]
    for j in range(3):
        x, r = tpu_sparse_torch.solve(W, B[:, j].contiguous(), **kw)
        assert r.converged
        np.testing.assert_allclose(X[:, j].cpu().numpy(), x.cpu().numpy(),
                                   rtol=1e-3,
                                   atol=1e-3 * float(x.abs().max()))


@pytest.mark.parametrize("operand", ["dia", "cwell"])
@pytest.mark.parametrize("method", ["cg_sr", "fcg", "minres", "fgmres"])
def test_more_adjoint_on_card_matches_cpu(dev, method, operand):
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A = _more_system(method, 10, np.float64)
    if operand == "cwell":
        A = csr_to_cwell(to_csr(A))
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(
        A.shape[0]))
    grads = []
    for where in ("cpu", dev):
        vals = (A.vals if operand == "cwell" else A.data).to(
            where, copy=True).requires_grad_()
        bb = b.to(where, copy=True).requires_grad_()
        x, r = tpu_sparse_torch.solve(A.to(where).with_data(vals), bb,
                                      method=method, tol=1e-10,
                                      maxiter=3000, precision="full")
        assert r.converged
        x.sum().backward()
        grads.append((vals.grad.cpu(), bb.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "fgmres"])
def test_callable_adjoint_on_card(dev, method):
    """A callable that launches K4 has no backward: with A_transpose (K4
    on the transposed pack) b.grad equals the matrix path's; without it
    the backward raises naming A_transpose=."""
    from tpu_sparse_torch import autodiff, kernels
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    C = to_csr(gen.convection_diffusion_3d_27pt(12, dtype=np.float32,
                                                device=dev))
    W = csr_to_cwell(C)
    Wt = csr_to_cwell(to_csr(C.tocoo().T))
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(
        W.shape[0]).astype(np.float32)).to(dev)
    fn = getattr(autodiff, f"{method}_diff")
    kw = dict(tol=1e-6, maxiter=500)
    grads = []
    for A, At in ((lambda v: kernels.spmv(W, v),
                   lambda v: kernels.spmv(Wt, v)), (W, None)):
        bb = b.clone().requires_grad_()
        before = cuda_cwell.LAUNCHES["cwell_spmv_f32"]
        x, info, _, _ = fn(A, bb, A_transpose=At, **kw)
        x.sum().backward()
        assert int(info) == 0
        assert cuda_cwell.LAUNCHES["cwell_spmv_f32"] > before
        grads.append(bb.grad)
    assert _rel(grads[0], grads[1]) <= 1e-3
    bb = b.clone().requires_grad_()
    x = fn(lambda v: kernels.spmv(W, v), bb, **kw)[0]
    with pytest.raises(RuntimeError, match="A_transpose="):
        x.sum().backward()


@pytest.mark.parametrize("method", ["fcg", "fgmres"])
def test_flexible_amg_v03_on_card_matches_cpu(dev, method):
    from tpu_sparse_torch.precond import amg_preconditioner

    A = _more_system(method, 16, np.float32)
    b = torch.from_numpy(np.random.default_rng(10).standard_normal(
        A.shape[0]).astype(np.float32))
    out = []
    for where in ("cpu", dev):
        Aw = A.to(where)
        M = amg_preconditioner(Aw, pre_sweeps=0, post_sweeps=3)
        x, r = tpu_sparse_torch.solve(Aw, b.to(where), method=method, M=M,
                                      tol=1e-5, maxiter=500)
        assert r.converged
        out.append((x.cpu(), r.iterations))
    assert abs(out[0][1] - out[1][1]) <= max(2, out[0][1] // 5)
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(),
                               rtol=1e-3,
                               atol=1e-3 * float(out[0][0].abs().max()))


def _skewed_csr(nx, dtype, device):
    """poisson2d(nx) + 0.1 triu as a general CSR (the JAX bench's
    general-direct system) and its scipy matrix. It is ill-conditioned
    (~8e4 at nx = 64, ~4e7 at 128), so right-hand sides are b = A x_true,
    as in the JAX bench."""
    import scipy.sparse as sp

    from tpu_sparse_torch.sparse.convert import csr_from_arrays, to_scipy_csr

    S = to_scipy_csr(gen.poisson2d(nx, dtype=np.float64, device="cpu"))
    S = (S + 0.1 * sp.triu(S, k=1)).tocsr().astype(dtype)
    S.sort_indices()
    return csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                           device=device), S


def _consistent_rhs(S, dtype, shape, seed):
    """b = S x_true for x_true from default_rng(seed), as a tensor."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    return torch.from_numpy((S.astype(np.float64) @ x).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_banded_direct_on_card_matches_cpu(dev, dtype):
    """PCR (tridiagonal, n >= 64) and block PCR (n >= 512) on the card
    against the CPU's Thomas and banded LU; f64 within 1e-10, f32 1e-4."""
    from tpu_sparse_torch import direct

    tol = 1e-10 if dtype == np.float64 else 1e-4
    for A in (gen.tridiagonal(500, dtype=dtype, device="cpu"),
              gen.poisson2d(40, dtype=dtype, device="cpu")):
        B = torch.from_numpy(np.random.default_rng(11).standard_normal(
            (A.shape[0], 2)).astype(dtype))
        for b in (B[:, 0].contiguous(), B):
            x_cpu = direct.banded_solve(A, b)
            x = direct.banded_solve(A.to(dev), b.to(dev))
            assert x.is_cuda and _rel(x.cpu(), x_cpu) <= tol


def _true_rel(S, b, x):
    """Largest ||b - S x|| / ||b|| over the columns, in float64 on the
    host."""
    bb = b.double().cpu().numpy()
    R = bb - S.astype(np.float64) @ x.double().cpu().numpy()
    return float(np.max(np.linalg.norm(np.atleast_2d(R.T), axis=-1)
                        / np.linalg.norm(np.atleast_2d(bb.T), axis=-1)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_supernodal_direct_on_card(dev, dtype):
    """solve(A, b, method='direct') on a general CSR past the densify
    limit: the supernodal LU on the card (K4 in f32, K5 in f64 on every
    level), one refinement step, true residual 1e-5 (f32) / 1e-10 (f64),
    as the CPU's host SuperLU; an (n, 4) b through K6/K7, every column
    and its single solve to the same residual; TF32 switched on by the
    caller keeps the bound; gradients in b and A's values on a
    well-conditioned CSR (convection-diffusion) against the CPU's."""
    tol = 1e-10 if dtype == np.float64 else 1e-5
    A, S = _skewed_csr(80, dtype, dev)
    n = A.shape[0]
    b = _consistent_rhs(S, dtype, n, 12).to(dev)
    solver = tpu_sparse_torch.SparseSolver()
    cuda_cwell.reset_launch_counts()
    x, r = solver.solve(A, b, method="direct")
    sfx = "f32" if dtype == np.float32 else "f64"
    assert r.converged and _true_rel(S, b, x) <= tol
    assert cuda_cwell.LAUNCHES[f"cwell_spmv_{sfx}"] > 0
    x_cpu, r_cpu = tpu_sparse_torch.solve(A.to("cpu"), b.cpu(),
                                          method="direct")
    assert r_cpu.converged and _true_rel(S, b, x_cpu) <= tol
    # TF32 switched on by the caller: the solve pins full fp32 and keeps
    # the bound (the refinement's CSR residual sums by atomics, so repeat
    # solves agree to the residual, not bit for bit)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x_tf32 = solver.solve(A, b, method="direct")[0]
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert _true_rel(S, b, x_tf32) <= tol
    B = _consistent_rhs(S, dtype, (n, 4), 13).to(dev)
    before = cuda_cwell.LAUNCHES[f"cwell_spmm_{sfx}"]
    X, rB = solver.solve(A, B, method="direct")
    assert rB.converged and cuda_cwell.LAUNCHES[f"cwell_spmm_{sfx}"] > before
    assert _true_rel(S, B, X) <= tol
    for j in range(4):
        xj = solver.solve(A, B[:, j].contiguous(), method="direct")[0]
        assert _true_rel(S, B[:, j], xj) <= tol
    from tpu_sparse_torch.sparse.convert import to_csr

    C = to_csr(gen.convection_diffusion_3d_27pt(17, dtype=dtype,
                                                device="cpu"))
    bc = torch.from_numpy(np.random.default_rng(15).standard_normal(
        C.shape[0]).astype(dtype))
    grads = []
    for where in (dev, "cpu"):
        Cw = C.to(where)
        vals = Cw.data.clone().requires_grad_()
        bb = bc.to(where, copy=True).requires_grad_()
        xw = solver.solve(Cw.with_data(vals), bb, method="direct")[0]
        xw.sum().backward()
        grads.append((vals.grad.cpu(), bb.grad.cpu()))
    gtol = 1e-10 if dtype == np.float64 else 1e-4
    assert _rel(grads[0][0], grads[1][0]) <= gtol
    assert _rel(grads[0][1], grads[1][1]) <= gtol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sparse_lu_on_card_matches_cpu(dev, dtype):
    """SparseLU's block sweeps on the card (K4 / K5) and on the CPU,
    solve and solve_transpose, each to the true residual bound."""
    from tpu_sparse_torch.direct import SparseLU

    tol = 1e-10 if dtype == np.float64 else 1e-4
    A, S = _skewed_csr(48, dtype, "cpu")
    b = _consistent_rhs(S, dtype, A.shape[0], 14)
    lu_cpu, lu = SparseLU.factor(A), SparseLU.factor(A.to(dev))
    for name, M in (("solve", S), ("solve_transpose", S.T)):
        x = getattr(lu, name)(b.to(dev))
        assert _true_rel(M, b, x) <= tol
        assert _true_rel(M, b, getattr(lu_cpu, name)(b)) <= tol


def test_ldc_direct_on_card_matches_cpu(dev):
    """The LDC with solver='direct': block PCR on the card against the
    banded LU on the CPU, fields within 1e-8 after 20 steps."""
    from tpu_sparse_torch.apps import ldc

    kw = dict(nx=32, Re=400.0, solver="direct")
    card = ldc.LDCSolver(ldc.LDCConfig(device="cuda", **kw))
    cpu = ldc.LDCSolver(ldc.LDCConfig(device="cpu", **kw))
    card.run(20)
    cpu.run(20)
    for name in ("u", "v", "p"):
        assert float((getattr(card, name).cpu()
                      - getattr(cpu, name)).abs().max()) <= 1e-8


@pytest.fixture
def nccl_mesh(dev):
    """A world-size-1 NCCL group on this process's card (torch.distributed
    needs an address: a free localhost port), destroyed after the test."""
    import datetime
    import socket

    import torch.distributed as dist

    from tpu_sparse_torch.dist import make_row_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_row_mesh("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dist_halo_spmv_world1_nccl(nccl_mesh, dtype):
    """The halo SpMV of a one-rank NCCL group: kernel 1 in extended mode on
    the rank's rows, bit for bit the single-device ExtendedStencilOperator,
    and no halo bytes recorded (no neighbour)."""
    from tpu_sparse_torch.dist import comm_model, distributed_matvec_op

    A = gen.poisson3d_27pt(24, dtype=dtype, device="cuda")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]).astype(dtype)).cuda()
    _, mv = distributed_matvec_op(A, nccl_mesh, "halo")
    before = cuda_spmv.LAUNCHES["dia_spmv_ext_" + ("f32" if dtype ==
                                                   np.float32 else "f64")]
    st = comm_model.measure_collectives(mv, x)
    after = cuda_spmv.LAUNCHES["dia_spmv_ext_" + ("f32" if dtype ==
                                                  np.float32 else "f64")]
    op = cuda_spmv.ExtendedStencilOperator(A)
    assert mv.mode == "halo" and after == before + 1
    assert torch.equal(st.result, op.matvec(x))
    assert "collective-permute" not in st.summary()
    # a block takes the plain DIA SpMM (no fused multiply-adds): within
    # 1e-5 of max|y| of the kernel's columns
    X = torch.stack([x, 2 * x], dim=1)
    y = op.matvec(x)
    bound = 1e-5 * float(y.abs().max())
    assert float((mv(X) - torch.stack([y, 2 * y], 1)).abs().max()) <= bound


def test_dist_device_mismatch_raises(nccl_mesh):
    """A CPU tensor on the NCCL mesh raises, a gloo mesh refuses a CUDA
    tensor, and a CPU mesh on an NCCL group is refused: no fallback."""
    import torch.distributed as dist

    from tpu_sparse_torch.dist import distributed_cg, make_row_mesh
    from tpu_sparse_torch.dist.mesh import RowMesh

    A = gen.poisson2d(16, device="cuda")
    with pytest.raises(ValueError, match="cpu tensor"):
        distributed_cg(A, torch.ones(256, dtype=torch.float64),
                       mesh=nccl_mesh)
    with pytest.raises(ValueError, match="gloo"):
        make_row_mesh("cpu")
    gloo = RowMesh(dist.new_group(backend="gloo"), 0, 1,
                   torch.device("cpu"))
    with pytest.raises(ValueError, match="cuda tensor"):
        gloo.all_reduce(torch.ones((), device="cuda"))


def test_dist_solves_world1_nccl(nccl_mesh):
    """Halo CG, CWELL CG and block CG of a one-rank NCCL group equal the
    single-device solves (same kernels, identity reductions)."""
    from tpu_sparse_torch.dist import distributed_block_cg, distributed_cg
    from tpu_sparse_torch.solvers import block_cg, cg_full
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A = gen.poisson3d_27pt(32, device="cuda")
    rng = np.random.default_rng(5)
    b = A @ torch.from_numpy(rng.standard_normal(A.shape[0]).astype(
        np.float32)).cuda()
    x, info, it, _ = distributed_cg(A, b, mesh=nccl_mesh, mode="halo",
                                    tol=1e-6)
    xs, _, its, _ = cg_full(A, b, tol=1e-6)
    assert int(info) == 0 and int(it) == int(its)
    assert torch.equal(x, xs)
    Ac = to_csr(A)
    xg, info, itg, _ = distributed_cg(Ac, b, mesh=nccl_mesh, tol=1e-6)
    xgs, _, itgs, _ = cg_full(csr_to_cwell(Ac), b, tol=1e-6)
    assert int(info) == 0 and int(itg) == int(itgs)
    assert torch.equal(xg, xgs)
    B = torch.from_numpy(rng.standard_normal((A.shape[0], 4)).astype(
        np.float32)).cuda()
    X, infos, itb, _ = distributed_block_cg(Ac, B, mesh=nccl_mesh, tol=1e-6)
    Xs, _, itbs, _ = block_cg(csr_to_cwell(Ac), B, tol=1e-6)
    assert bool((infos == 0).all()) and int(itb) == int(itbs)
    assert float((X - Xs).abs().max() / Xs.abs().max()) <= 1e-5


@pytest.mark.parametrize("make", [
    lambda: gen.poisson3d_27pt(12, dtype=np.float64, device="cpu"),
    lambda: gen.convection_diffusion_3d_27pt(12, dtype=np.float64,
                                             device="cpu"),
    lambda: gen.poisson3d_27pt(12, device="cpu"),
], ids=["poisson3d-f64", "convdiff3d-f64", "poisson3d-f32"])
def test_ilu0_on_card_matches_cpu(dev, make):
    """ILU(0): the card's factor equals the CPU port's (the same host
    code), and one apply (K4 / K5 per level pack) and a block apply
    (K6/K7) match the CPU's plain level sweeps within 1e-12 (f64) /
    1e-5 (f32) of max|y|."""
    from tpu_sparse_torch import precond as tpre

    A = make()
    f64 = A.dtype == torch.float64
    bound = 1e-12 if f64 else 1e-5
    (Lc, Uc), (Lg, Ug) = tpre.ilu0_factor(A), tpre.ilu0_factor(A.to(dev))
    assert Lg.data.is_cuda
    assert torch.equal(Lg.data.cpu(), Lc.data)
    assert torch.equal(Ug.data.cpu(), Uc.data)
    Mc, Mg = tpre.ilu0_preconditioner(A), tpre.ilu0_preconditioner(A.to(dev))
    assert Mg.levels == Mc.levels == (78, 78)
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.standard_normal(A.shape[0])).to(A.dtype)
    V = torch.from_numpy(rng.standard_normal((A.shape[0], 8))).to(A.dtype)
    key = "f64" if f64 else "f32"
    before = dict(cuda_cwell.LAUNCHES)
    y = Mg(v.to(dev))
    Y = Mg.matmat(V.to(dev))
    assert cuda_cwell.LAUNCHES[f"cwell_spmv_{key}"] - before[
        f"cwell_spmv_{key}"] == len(Mg.fwd.operators()) + len(
        Mg.bwd.operators())
    assert cuda_cwell.LAUNCHES[f"cwell_spmm_{key}"] > before[
        f"cwell_spmm_{key}"]
    assert _rel(y.cpu(), Mc(v)) <= bound
    assert _rel(Y.cpu(), Mc.matmat(V)) <= bound


@pytest.mark.parametrize("method,dtype,precision", [
    ("cg", np.float32, "full"), ("bicgstab", np.float32, "full"),
    ("cg", np.float64, "full"), ("gmres", np.float64, "auto"),
    ("minres", np.float64, "full")])
def test_ilu0_solve_on_card_matches_cpu(dev, method, dtype, precision):
    A = gen.poisson3d_27pt(16, dtype=dtype, device="cpu")
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        A.shape[0]).astype(dtype))
    tol = 1e-6 if dtype == np.float32 else 1e-10
    kw = dict(method=method, M="ilu0", tol=tol, precision=precision,
              maxiter=500)
    xc, rc = tpu_sparse_torch.solve(A, b, **kw)
    xg, rg = tpu_sparse_torch.solve(A.to(dev), b.to(dev), **kw)
    assert rc.converged and rg.converged
    slack = 2 if dtype == np.float64 else max(5, rc.iterations // 5)
    assert abs(rc.iterations - rg.iterations) <= slack
    rtol = 1e-3 if dtype == np.float32 else 1e-8
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=rtol,
                               atol=rtol * float(xc.abs().max()))


# ---- native complex: the complex64 / complex128 builds of kernel 1, K4 /
# K5, K6/K7 and K8 against their plain versions (1e-5 / 1e-12 of max|y|),
# and complex solves on the card against the CPU ----------------------------

_C_BOUND = {torch.complex64: 1e-5, torch.complex128: 1e-12}
_C_SFX = {torch.complex64: "c64", torch.complex128: "c128"}


def _crandn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)).to(dtype)


def _complex_csr(n, m, per_row, dtype, seed):
    """_random_csr's pattern with complex values (a tenth of them real,
    a tenth imaginary, so both halves of the zero test are reached)."""
    C = _random_csr(n, m, per_row, np.float64, seed)
    rng = np.random.default_rng(seed + 1)
    v = rng.standard_normal(C.nnz) + 1j * rng.standard_normal(C.nnz)
    pick = rng.random(C.nnz)
    v[pick < 0.1] = v[pick < 0.1].real
    v[(pick >= 0.1) & (pick < 0.2)] = 1j * v[(pick >= 0.1) & (pick < 0.2)].imag
    return C.with_data(torch.from_numpy(v).to(dtype))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_dia_spmv_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(20)
    A = gen.poisson3d_27pt(13, 11, 7, dtype=np.float64, device="cpu")
    A = A.with_data(_crandn(rng, tuple(A.data.shape), dtype)).to(dev)
    x = _crandn(rng, A.shape[1], dtype).to(dev)
    key = "dia_spmv_" + _C_SFX[dtype]
    before = cuda_spmv.LAUNCHES[key]
    y = cuda_spmv.dia_spmv_cuda(A, x)
    assert cuda_spmv.LAUNCHES[key] == before + 1
    assert y.dtype == dtype
    assert _rel(y, ref.dia_spmv(A, x)) <= _C_BOUND[dtype]
    assert torch.equal(y, A @ x)
    # conjugate views are read as their values, not as raw memory
    yc = cuda_spmv.dia_spmv_cuda(A.with_data(A.data.conj()), x.conj())
    assert torch.equal(yc, cuda_spmv.dia_spmv_cuda(
        A.with_data(A.data.conj().resolve_conj()), x.conj().resolve_conj()))
    assert _rel(yc, y.conj()) <= _C_BOUND[dtype]
    with pytest.raises(TypeError):
        cuda_spmv.dia_spmv_cuda(A, x.real.contiguous())
    with pytest.raises(TypeError):
        cuda_spmv.ExtendedStencilOperator(A).apply_cuda(
            torch.zeros(cuda_spmv.ExtendedStencilOperator(A).E, dtype=dtype,
                        device=dev))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,m,per_row,group,wide", [
    (3000, 2500, 8, 1, False), (1001, 777, 7, 2, False),
    (300, 600, 4, 1, True)])
def test_complex_cwell_kernels_match_plain(dev, n, m, per_row, group, wide,
                                           dtype):
    """K4 / K5 and K6/K7 in complex on the compact plan against its plain
    versions; every column of K6/K7 equal to K4 / K5 bit for bit."""
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse.convert import dense_to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    C = _complex_csr(n, m, per_row, dtype, 21)
    if wide:  # a row over 600 columns: more than 256 planes
        Ad = C.todense()
        Ad[5] = torch.arange(1, m + 1).to(dtype) * (1 - 0.5j)
        C = dense_to_csr(Ad)
    W = csr_to_cwell(C.to(dev), group=group)
    plan, cvals = cwell_compact.compact(W)
    assert plan.wide == wide and cvals.dtype == dtype
    assert cvals.device == W.vals.device  # gathered on the card
    rng = np.random.default_rng(22)
    x = _crandn(rng, m, dtype).to(dev)
    sfx = _C_SFX[dtype]
    before = dict(cuda_cwell.LAUNCHES)
    y = cuda_cwell.cwell_spmv_cuda(W, x)
    assert cuda_cwell.LAUNCHES["cwell_spmv_" + sfx] == \
        before["cwell_spmv_" + sfx] + 1
    assert _rel(y, ref.cwell_compact_spmv(plan, cvals, x)) <= _C_BOUND[dtype]
    assert torch.equal(y, cuda_cwell.cwell_spmv_cuda(W, x))
    yc = cuda_cwell.cwell_spmv_cuda(W.with_data(W.vals.conj()), x.conj())
    assert _rel(yc, y.conj()) <= _C_BOUND[dtype]
    for k in (1, 3, 8):
        B = _crandn(rng, (m, k), dtype).to(dev)
        Y = cuda_cwell.cwell_spmm_cuda(W, B)
        assert _rel(Y, ref.cwell_compact_spmm(plan, cvals, B)) <= \
            _C_BOUND[dtype]
        for j in range(k):
            assert torch.equal(Y[:, j], cuda_cwell.cwell_spmv_cuda(
                W, B[:, j].contiguous()))
    assert cuda_cwell.LAUNCHES["cwell_spmm_" + sfx] == \
        before["cwell_spmm_" + sfx] + 3
    with pytest.raises(TypeError):
        cuda_cwell.cwell_spmv_cuda(W, x.real.contiguous())


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nb,bs,pad,k", [(40, 8, 0, 8), (30, 3, 1, 5),
                                         (12, 16, 2, 2), (6, 64, 1, 3)])
def test_complex_bell_spmm_kernel_matches_plain(dev, nb, bs, pad, k, dtype):
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import dense_to_csr

    rng = np.random.default_rng(nb + bs)
    Ad = torch.from_numpy(_block_dense(nb, bs, 0.3, nb + bs)).to(dtype)
    Ad = Ad * (1 + 0.2j) + 1j * (Ad != 0).to(dtype) * 0.1
    S = csr_to_bsr(dense_to_csr(Ad.to(dev)), bs)
    A = bsr_to_bell(S, ell_width=int(torch.diff(S.indptr.long()).max())
                    + pad)
    B = _crandn(rng, (nb * bs, k), dtype).to(dev)
    key = "bell_spmm_" + _C_SFX[dtype]
    before = cuda_bell.LAUNCHES[key]
    Y0 = ref.bell_spmm(A, B)
    Y1 = cuda_bell.bell_spmm_cuda(A, B)
    assert cuda_bell.LAUNCHES[key] == before + 1
    assert _rel(Y1, Y0) <= _C_BOUND[dtype]
    assert torch.equal(Y1, cuda_bell.bell_spmm_cuda(A, B))
    Yc = cuda_bell.bell_spmm_cuda(A.with_data(A.blocks.conj()), B.conj())
    assert _rel(Yc, Y1.conj()) <= _C_BOUND[dtype]
    with pytest.raises(TypeError):
        cuda_bell.bell_spmm_cuda(A, B.real.contiguous())


def _hermitian_dia(A, seed=0):
    """D^H A D with D = diag(exp(i theta)), theta uniform on [0, 2 pi) from
    default_rng(seed), as a complex128 DIA on A's device."""
    n = A.shape[0]
    th = np.random.default_rng(seed).uniform(0, 2 * np.pi, n)
    D = torch.from_numpy(np.exp(1j * th)).to(A.data.device)
    data = A.data.to(torch.complex128).clone()
    for d, o in enumerate(A.offsets):
        i = torch.arange(max(0, -o), min(n, n - o), device=D.device)
        data[d, i] = D[i].conj() * data[d, i] * D[i + o]
    return A.with_data(data)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("fmt,method,M", [
    (fmt, method, M) for fmt in ("dia", "cwell")
    for method, M in (("cg", None), ("cg", "jacobi"), ("gmres", None),
                      ("bicgstab", "ilu0"), ("minres", None), ("cg", "amg"))
    if not (fmt == "cwell" and M == "ilu0")])  # ILU(0) takes a DIA (JAX's)
def test_complex_solve_on_card_matches_cpu(dev, method, M, fmt, dtype):
    """Complex solves on the card (every matvec a complex kernel) against
    the CPU: iterations within the slack above, x rtol 1e-3 (complex64)
    / 1e-8 (complex128)."""
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A = _hermitian_dia(gen.poisson3d_27pt(12, dtype=np.float64,
                                          device="cpu")).to(dtype)
    if fmt == "cwell":
        A = csr_to_cwell(to_csr(A))
    rng = np.random.default_rng(7)
    b = _crandn(rng, A.shape[0], dtype)
    tol = 1e-5 if dtype == torch.complex64 else 1e-10
    kw = dict(method=method, M=M, tol=tol, maxiter=500)
    xc, rc = tpu_sparse_torch.solve(A, b, **kw)
    before = {**cuda_spmv.LAUNCHES, **cuda_cwell.LAUNCHES}
    xg, rg = tpu_sparse_torch.solve(A.to(dev), b.to(dev), **kw)
    after = {**cuda_spmv.LAUNCHES, **cuda_cwell.LAUNCHES}
    assert rc.converged and rg.converged
    key = ("dia_spmv_" if fmt == "dia" else "cwell_spmv_") + _C_SFX[dtype]
    if M != "ilu0":
        assert after[key] > before[key]
    if M == "ilu0":
        assert after["cwell_spmv_" + _C_SFX[dtype]] > \
            before["cwell_spmv_" + _C_SFX[dtype]]
    slack = 2 if dtype == torch.complex128 else max(5, rc.iterations // 5)
    assert abs(rc.iterations - rg.iterations) <= slack
    rtol = 1e-3 if dtype == torch.complex64 else 1e-8
    assert _rel(xg.cpu(), xc) <= rtol


def test_complex_multirhs_mixed_and_bell_on_card(dev):
    """(n, k) complex solves on the card: batched CG on a CWELL (K6/K7
    c64), the mixed precision (complex64 inner sweeps, complex128
    residuals), and batched CG on a complex kron BELL (K8 c128)."""
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    rng = np.random.default_rng(8)
    Ah = _hermitian_dia(gen.poisson3d_27pt(12, dtype=np.float64,
                                           device="cpu"))
    W = csr_to_cwell(to_csr(Ah)).to(dev)
    B = _crandn(rng, (Ah.shape[0], 4), torch.complex128).to(dev)
    cuda_cwell.reset_launch_counts()
    X, r = tpu_sparse_torch.solve(W.with_data(W.vals.to(torch.complex64)),
                                  B.to(torch.complex64), tol=1e-5,
                                  maxiter=500)
    assert r.converged and cuda_cwell.LAUNCHES["cwell_spmm_c64"] > 0
    X, r = tpu_sparse_torch.solve(W, B, tol=1e-10, precision="mixed")
    assert r.converged
    assert cuda_cwell.LAUNCHES["cwell_spmm_c64"] > 0
    assert cuda_cwell.LAUNCHES["cwell_spmm_c128"] > 0
    R = B - W @ X
    assert float(torch.linalg.vector_norm(R, dim=0).max()
                 / torch.linalg.vector_norm(B, dim=0).min()) <= 1e-9
    import scipy.sparse as sp

    from tpu_sparse_torch.sparse.convert import csr_from_arrays, to_scipy_csr

    S = sp.kron(to_scipy_csr(gen.poisson3d_27pt(6, dtype=np.float64,
                                                device="cpu")),
                sp.eye(8) * 4 + sp.eye(8, k=1) - sp.eye(8, k=-1)) * (1 + 0.2j)
    S = S.tocsr()
    S.sort_indices()
    bell = bsr_to_bell(csr_to_bsr(csr_from_arrays(
        S.data, S.indices, S.indptr, S.shape, device=dev), 8))
    Bb = _crandn(rng, (S.shape[0], 4), torch.complex128).to(dev)
    cuda_bell.reset_launch_counts()
    X, r = tpu_sparse_torch.solve(bell, Bb, method="gmres", tol=1e-10)
    assert r.converged and cuda_bell.LAUNCHES["bell_spmm_c128"] > 0
    Xc = torch.from_numpy(sp.linalg.spsolve(S.tocsc(), Bb.cpu().numpy()))
    assert _rel(X.cpu(), Xc) <= 1e-8


def test_complex_banded_direct_on_card_matches_cpu(dev):
    """PCR (tridiagonal) and block PCR (banded) on complex128 on the card
    against the CPU's Thomas and banded LU, within 1e-10."""
    rng = np.random.default_rng(11)
    for A in (gen.tridiagonal(500, dtype=np.float64, device="cpu"),
              gen.poisson2d(40, dtype=np.float64, device="cpu")):
        A = A.with_data(A.data * (1 + 0.3j))
        b = _crandn(rng, A.shape[0], torch.complex128)
        xc, rc = tpu_sparse_torch.solve(A, b, method="direct")
        xg, rg = tpu_sparse_torch.solve(A.to(dev), b.to(dev),
                                        method="direct")
        assert rc.converged and rg.converged and xg.dtype == xc.dtype
        assert _rel(xg.cpu(), xc) <= 1e-10


def test_complex_direct_and_gradient_on_card(dev):
    """The supernodal LU of a complex general CSR on the card (K5 c128 on
    its level packs): the true residual within 10x of host SuperLU's
    complex128 solve; gradients in b and A's values against the CPU's
    within 1e-10."""
    import scipy.sparse.linalg as spl

    from tpu_sparse_torch.sparse.convert import csr_from_arrays

    _, S = _skewed_csr(80, np.float64, "cpu")
    S = (S * (1 + 0.3j)).tocsr()
    A = csr_from_arrays(S.data, S.indices, S.indptr, S.shape, device=dev)
    rng = np.random.default_rng(9)
    xt = rng.standard_normal(S.shape[0]) + 1j * rng.standard_normal(
        S.shape[0])
    b = torch.from_numpy(S @ xt).to(dev)
    cuda_cwell.reset_launch_counts()
    x, r = tpu_sparse_torch.solve(A, b, method="direct")
    assert r.converged and cuda_cwell.LAUNCHES["cwell_spmv_c128"] > 0
    bb = b.cpu().numpy()
    rel = np.linalg.norm(bb - S @ x.cpu().numpy()) / np.linalg.norm(bb)
    xs = spl.splu(S.tocsc()).solve(bb)
    rel_s = np.linalg.norm(bb - S @ xs) / np.linalg.norm(bb)
    assert rel <= 10 * max(rel_s, 1e-15)
    Ah = _hermitian_dia(gen.poisson3d_27pt(8, dtype=np.float64,
                                           device="cpu"))
    w = _crandn(rng, Ah.shape[0], torch.complex128)
    grads = []
    for where in (dev, "cpu"):
        vals = Ah.data.to(where, copy=True).requires_grad_()
        bw = (Ah @ w).to(where, copy=True).requires_grad_()
        xw = tpu_sparse_torch.solve(Ah.to(where).with_data(vals), bw,
                                    method="gmres", tol=1e-12)[0]
        (xw * w.to(where)).sum().abs().backward()
        grads.append((vals.grad.cpu(), bw.grad.cpu()))
    assert _rel(grads[0][0], grads[1][0]) <= 1e-8
    assert _rel(grads[0][1], grads[1][1]) <= 1e-8


# ---- bf16: kernel 1 (both modes), K4, K6/K7 and K8 on bf16 values with a
# float32 or a bf16 operand, and bf16 solves on the card -----------------


def _bf16_close(y, y0, scale=None):
    """A bf16 output against its plain version: within one bf16 ulp of
    |y0| element-wise, plus 1e-6 of max|y0| where sums cancel."""
    y, y0 = y.float(), y0.float()
    scale = float(y0.abs().max()) if scale is None else scale
    return bool(torch.all((y - y0).abs()
                          <= 2.0 ** -7 * y0.abs() + 1e-6 * scale))


def _bf16_exact(t):
    return t.to(torch.bfloat16).float()


def test_bf16_dia_spmv_kernels_match_plain(dev):
    rng = np.random.default_rng(30)
    A = gen.poisson3d_27pt(13, 11, 7, dtype=np.float32, device="cpu")
    A = A.with_data(torch.from_numpy(rng.standard_normal(
        tuple(A.data.shape)).astype(np.float32)).to(torch.bfloat16)).to(dev)
    x32 = torch.from_numpy(rng.standard_normal(A.shape[1]).astype(
        np.float32)).to(dev)
    op = cuda_spmv.ExtendedStencilOperator(A)
    A32 = A.with_data(A.data.float())
    op32 = cuda_spmv.ExtendedStencilOperator(A32)
    for x, sfx in ((x32, "bf16_f32"), (x32.to(torch.bfloat16), "bf16")):
        before = dict(cuda_spmv.LAUNCHES)
        y = cuda_spmv.dia_spmv_cuda(A, x)
        ye = op.extract(op(op.extend(x)))
        assert cuda_spmv.LAUNCHES["dia_spmv_" + sfx] == \
            before["dia_spmv_" + sfx] + 1
        assert cuda_spmv.LAUNCHES["dia_spmv_ext_" + sfx] == \
            before["dia_spmv_ext_" + sfx] + 1
        y0 = ref.dia_spmv_wide(A, x)
        assert y.dtype == ye.dtype == x.dtype == y0.dtype
        if sfx == "bf16":
            assert _bf16_close(y, y0) and _bf16_close(ye, y0)
        else:
            assert _rel(y, y0) <= 1e-5 and _rel(ye, y0) <= 1e-5
            # the data widened in registers: the float32 build's bits
            assert torch.equal(y, cuda_spmv.dia_spmv_cuda(A32, x))
            assert torch.equal(ye, op32.extract(op32(op32.extend(x))))
        assert torch.equal(y, cuda_spmv.dia_spmv_cuda(A, x))
    with pytest.raises(TypeError, match="bfloat16 / float32"):
        cuda_spmv.dia_spmv_cuda(A, x32.double())
    assert cuda_cg.make_fused_operator(A) is None  # JAX's fused CG refuses


@pytest.mark.parametrize("n,m,per_row,group,wide", [
    (3000, 2500, 8, 1, False), (1001, 777, 7, 2, False),
    (300, 600, 4, 1, True)])
def test_bf16_cwell_kernels_match_plain(dev, n, m, per_row, group, wide):
    """K4 and K6/K7 on bf16 values (and K6/K7 on a bf16 B) against the
    compact plain versions; every K6/K7 column equal to K4 bit for bit;
    on bf16-exact values the float32 builds' bits. The wide case has a
    row of 600 nonzeros, so its block stages in pieces and a bf16 Y
    carries its sums through the float32 workspace."""
    from tpu_sparse_torch.sparse import cwell_compact
    from tpu_sparse_torch.sparse.convert import dense_to_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    C = _random_csr(n, m, per_row, np.float32, 31)
    if wide:
        Ad = C.todense()
        Ad[5] = torch.arange(1, m + 1).float() / m - 0.3
        C = dense_to_csr(Ad)
    W32 = csr_to_cwell(C.with_data(_bf16_exact(C.data)).to(dev), group=group)
    W = W32.with_data(W32.vals.to(torch.bfloat16))
    plan, cvals = cwell_compact.compact(W)
    assert plan.wide == wide and cvals.dtype == torch.bfloat16
    rng = np.random.default_rng(32)
    x32 = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)
    before = dict(cuda_cwell.LAUNCHES)
    for x, sfx in ((x32, "bf16_f32"), (x32.to(torch.bfloat16), "bf16")):
        y = cuda_cwell.cwell_spmv_cuda(W, x)
        y0 = ref.cwell_compact_spmv(plan, cvals, x)
        assert y.dtype == y0.dtype == x.dtype
        if sfx == "bf16":
            assert _bf16_close(y, y0)
        else:
            assert _rel(y, y0) <= 1e-5
            assert torch.equal(y, cuda_cwell.cwell_spmv_cuda(W32, x))
        assert torch.equal(y, cuda_cwell.cwell_spmv_cuda(W, x))
    for sfx in ("bf16", "bf16_f32"):
        assert cuda_cwell.LAUNCHES["cwell_spmv_" + sfx] == \
            before["cwell_spmv_" + sfx] + 2
    for k in (1, 3, 8):
        B32 = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(dev)
        Bh = B32.to(torch.bfloat16)
        for Wk, B in ((W, B32), (W, Bh), (W32, Bh)):
            Y = cuda_cwell.cwell_spmm_cuda(Wk, B)
            pk, ck = cwell_compact.compact(Wk)
            Y0 = ref.cwell_compact_spmm(pk, ck, B)
            assert Y.dtype == Y0.dtype
            if Y.dtype == torch.bfloat16:
                assert _bf16_close(Y, Y0)
            else:
                assert _rel(Y, Y0) <= 1e-5
            for j in range(k):
                xj = B[:, j].contiguous()
                if Wk is W32:  # K4 has no float32 / bf16 build: x widened
                    xj = xj.float()
                assert torch.equal(Y[:, j], cuda_cwell.cwell_spmv_cuda(Wk,
                                                                       xj))
    for sfx in ("bf16", "bf16_f32", "f32_bf16"):
        assert cuda_cwell.LAUNCHES["cwell_spmm_" + sfx] == \
            before["cwell_spmm_" + sfx] + 3
    with pytest.raises(TypeError, match="float64"):
        cuda_cwell.cwell_spmv_cuda(W, x32.double())


@pytest.mark.parametrize("nb,bs,pad,k", [(40, 8, 0, 8), (30, 3, 1, 5),
                                         (12, 16, 2, 130), (6, 64, 1, 3)])
def test_bf16_bell_spmm_kernel_matches_plain(dev, nb, bs, pad, k):
    from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
    from tpu_sparse_torch.sparse.convert import dense_to_csr

    Ad = _bf16_exact(torch.from_numpy(_block_dense(nb, bs, 0.3, nb + bs)
                                      .astype(np.float32)))
    S = csr_to_bsr(dense_to_csr(Ad.to(dev)), bs)
    A32 = bsr_to_bell(S, ell_width=int(torch.diff(S.indptr.long()).max())
                      + pad)
    A = A32.with_data(A32.blocks.to(torch.bfloat16))
    B32 = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (nb * bs, k)).astype(np.float32)).to(dev)
    for B, sfx in ((B32, "bf16_f32"), (B32.to(torch.bfloat16), "bf16")):
        before = cuda_bell.LAUNCHES["bell_spmm_" + sfx]
        Y = cuda_bell.bell_spmm_cuda(A, B)
        assert cuda_bell.LAUNCHES["bell_spmm_" + sfx] == before + 1
        Y0 = ref.bell_spmm_wide(A, B)
        assert Y.dtype == B.dtype == Y0.dtype
        if sfx == "bf16":
            assert _bf16_close(Y, Y0)
        else:
            assert _rel(Y, Y0) <= 1e-5
            assert torch.equal(Y, cuda_bell.bell_spmm_cuda(A32, B))
        assert torch.equal(Y, cuda_bell.bell_spmm_cuda(A, B))
    with pytest.raises(TypeError, match="bfloat16 / float32"):
        cuda_bell.bell_spmm_cuda(A, B32.double())
    # a single-RHS matvec runs K4's bf16 build on the bf16 CWELL repack
    from tpu_sparse_torch import kernels

    before = cuda_cwell.LAUNCHES["cwell_spmv_bf16_f32"]
    y = kernels.spmv(A, B32[:, 0].contiguous())
    assert cuda_cwell.LAUNCHES["cwell_spmv_bf16_f32"] == before + 1
    assert _rel(y, ref.bell_spmm_wide(A, B32[:, :1])[:, 0]) <= 1e-5


def test_bf16_solves_on_card(dev):
    """solve() on a bf16 DIA with a float32 b takes the extended route
    (kernel 1's bf16 extended build; the fused kernels refuse bf16) and,
    the Poisson values being bf16-exact, takes the float32 loop's
    iterations with x within 1e-6; a bf16 b, the CWELL pack and (n, 3)
    right-hand sides run their bf16 builds; no values cast anywhere."""
    from tpu_sparse_torch import kernels
    from tpu_sparse_torch.autodiff import implicit
    from tpu_sparse_torch.sparse import convert as conv
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    A32 = gen.poisson3d_27pt(24, dtype=np.float32, device=dev)
    A = A32.with_data(A32.data.to(torch.bfloat16))
    b = torch.from_numpy(np.random.default_rng(33).standard_normal(
        A.shape[0]).astype(np.float32)).to(dev)
    kernels.reset_cast_counts()
    cuda_spmv.reset_launch_counts()
    x, r = tpu_sparse_torch.solve(A, b, method="cg", tol=1e-6)
    assert cuda_spmv.LAUNCHES["dia_spmv_ext_bf16_f32"] > 0
    op32 = cuda_spmv.ExtendedStencilOperator(A32)
    xr, info, it, _ = implicit._ext_loop("cg", dict(tol=1e-6, atol=0.0,
                                                    maxiter=None),
                                         op32, b, None, None)
    assert r.converged and int(info) == 0 and r.iterations == int(it)
    assert _rel(x, xr) <= 1e-6
    for method in ("bicgstab", "gmres"):
        _, r = tpu_sparse_torch.solve(A, b, method=method, tol=1e-5,
                                      M="jacobi")
        assert r.converged
    xh, rh = tpu_sparse_torch.solve(A, b.to(torch.bfloat16), tol=2e-2)
    assert xh.dtype == torch.bfloat16 and rh.converged
    W = csr_to_cwell(conv.to_csr(A))
    assert W.vals.dtype == torch.bfloat16
    cuda_cwell.reset_launch_counts()
    xw, rw = tpu_sparse_torch.solve(W, b, method="cg", tol=1e-5)
    assert rw.converged and cuda_cwell.LAUNCHES["cwell_spmv_bf16_f32"] > 0
    B = torch.stack([b, 2 * b, -b], 1)
    X, rB = tpu_sparse_torch.solve(W, B, method="cg", tol=1e-5)
    assert rB.converged and cuda_cwell.LAUNCHES["cwell_spmm_bf16_f32"] > 0
    assert kernels.CAST_COUNTS["values_casts"] == 0
