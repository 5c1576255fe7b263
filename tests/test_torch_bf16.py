"""bf16 in ``tpu_sparse_torch`` against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages. bf16 crosses as
float32 arrays of bf16-exact values, cast by torch (``convert.*(dtype=
torch.bfloat16)``), or as numpy's bf16 arrays that ``np.asarray`` of a
JAX bf16 array gives.

* SpMVs: the port's plain versions of the card's bf16 builds
  (``reference.dia_spmv_wide``, ``ExtendedStencilOperator.apply_plain``,
  ``reference.cwell_compact_spmv`` / ``_spmm``, ``reference.
  bell_spmm_wide``: bf16 widened to float32, float32 sums, one rounding)
  against JAX's Pallas kernels in interpret mode (K1, K2, K4, K6/K7,
  K8). A float32 output within 1e-5 of max|y|; where JAX sums in bf16
  (K1 / K2 with a bf16 x) within 2e-2 of max|y| (a few bf16 ulps); where
  JAX sums in float32 and rounds once (K8 with a bf16 B) within one bf16
  ulp of |y| plus 1e-6 of max|y|.
* Solves with bf16 values and a float32 b against JAX on the same
  bf16-rounded values: equal iterations and x within 1e-5 of max|x| (both
  run float32 arithmetic). The CWELL case is held against JAX on the
  float32 cast of the values, not JAX's bf16 reference, which sums the
  gathered x in bf16 (ROADMAP R15).
* Solves with a bf16 b (bf16 values) for cg, bicgstab, gmres, fgmres and
  minres with M None and Jacobi, and (n, 3) for cg and gmres: ``converged``
  equal and iterations within 1 of JAX's, x within 3e-2 of max|x| (the
  two sum their dots in different orders, and a bf16 vector holds 8 bits).
  The amg and direct backends as JAX runs them (direct: not converged by
  R11's 1e-4 rule in both).
* The gradient in b of a bf16-values CG against ``jax.grad`` of JAX's
  solve (1e-5 of max|g|), and no values cast on any of these routes.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sparse
import tpu_sparse.kernels.pallas_bell as jpb
import tpu_sparse.kernels.pallas_cwell as jpc
import tpu_sparse.kernels.pallas_spmv as jps
import tpu_sparse_torch
from tpu_sparse.sparse import bsr_to_bell as jbsr_to_bell
from tpu_sparse.sparse import csr_to_bsr as jcsr_to_bsr
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import to_csr as jto_csr
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell
from tpu_sparse_torch import kernels as tk
from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import cuda_spmv
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.sparse import convert as tconv
from tpu_sparse_torch.sparse import cwell_compact
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

BF = torch.bfloat16


@pytest.fixture
def interpret_mode(monkeypatch):
    for mod in (jps, jpc, jpb):
        monkeypatch.setattr(mod, "_INTERPRET", True)
        monkeypatch.setattr(mod, "_HAS_PALLAS", True)
    yield


def _f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _max_rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _within_ulp(y, y0) -> bool:
    y, y0 = _f32(y), _f32(y0)
    return bool(np.all(np.abs(y - y0)
                       <= 2.0 ** -7 * np.abs(y0) + 1e-6 * np.abs(y0).max()))


def _dia_pair(nx, random_values=False, seed=0):
    """(JAX bf16 DIA, port bf16 DIA) of poisson3d_27pt(nx)'s pattern; the
    values are the Poisson ones (bf16-exact) or standard normal draws
    rounded to bf16."""
    A = jgen.poisson3d_27pt(nx, dtype=np.float32)
    data = np.asarray(A.data)
    if random_values:
        data = np.random.default_rng(seed).standard_normal(
            data.shape).astype(np.float32)
    Aj = A.with_data(jnp.asarray(data, jnp.bfloat16))
    At = tconv.dia_from_numpy(np.asarray(Aj.data), A.offsets, A.shape,
                              device="cpu")
    return Aj, At


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_dia_plain_versions_against_jax_kernels(interpret_mode, xdt):
    """K1 (``dia_spmv_pallas``) and K2 (the extended operator) on bf16
    data: with a float32 x JAX casts the data to float32 and sums in
    float32, as the port's builds do; with a bf16 x it sums in bf16."""
    Aj, At = _dia_pair(6, random_values=True)
    assert At.data.dtype == BF
    x = np.random.default_rng(1).standard_normal(At.shape[0]).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.float32 if xdt == "f32" else jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.float32 if xdt == "f32" else BF)
    y1j = jps.dia_spmv_pallas(Aj, xj)
    opj = jps.ExtendedStencilOperator(Aj)
    y2j = opj.extract(opj(opj.extend(xj)))
    y1 = tref.dia_spmv_wide(At, xt)
    opt = cuda_spmv.ExtendedStencilOperator(At)
    ye = opt(opt.extend(xt))
    assert y1.dtype == ye.dtype == xt.dtype
    assert float(ye[:opt.Wl].abs().max()) == 0.0
    bound = 1e-5 if xdt == "f32" else 2e-2
    assert _max_rel(y1, y1j) <= bound
    assert _max_rel(opt.extract(ye), y2j) <= bound
    # the CPU route (kernels.spmv): JAX's XLA product, float32 for a
    # float32 x, no values cast
    tracing.reset()
    y = tk.spmv(At, xt)
    assert y.dtype == xt.dtype and tk.CAST_COUNTS["values_casts"] == 0
    if xdt == "f32":
        assert _max_rel(y, y1j) <= 1e-5


def test_cwell_plain_versions_against_jax_kernels(interpret_mode):
    """K4 on bf16 values with a float32 x (JAX: values streamed in bf16,
    gather and sum in float32) and K6/K7 on float32 values with a bf16 B
    (JAX casts B to float32): the port's compact plain versions, the
    card's bf16 builds' mirror, and its CPU route."""
    A = jto_csr(jgen.poisson2d(12, dtype=np.float32))
    rng = np.random.default_rng(2)
    vals = jnp.asarray(rng.standard_normal(A.nnz), jnp.bfloat16)
    Wj = jcsr_to_cwell(A.with_data(vals.astype(jnp.float32)))
    Wjb = Wj.with_data(Wj.vals.astype(jnp.bfloat16))
    Wt = tconv.cwell_from_numpy(np.asarray(Wj.vals), np.asarray(Wj.idx2),
                                np.asarray(Wj.srow), Wj.shape, nnz=Wj.nnz,
                                fill=Wj.fill, group=Wj.group, device="cpu",
                                dtype=BF)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    yj = jpc.cwell_spmv_pallas(Wjb, jnp.asarray(x))
    plan, cvals = cwell_compact.compact(Wt)
    assert cvals.dtype == BF  # the value gather keeps bf16
    y = tref.cwell_compact_spmv(plan, cvals, torch.from_numpy(x))
    assert y.dtype == torch.float32 and _max_rel(y, yj) <= 1e-5
    tracing.reset()
    assert _max_rel(tk.spmv(Wt, torch.from_numpy(x)), yj) <= 1e-5
    assert tk.CAST_COUNTS["values_casts"] == 0
    B = rng.standard_normal((A.shape[1], 3)).astype(np.float32)
    Yj = jpc.cwell_spmm_pallas(Wj, jnp.asarray(B, jnp.bfloat16))
    W32 = Wt.with_data(Wt.vals.float())
    Bt = torch.from_numpy(B).to(BF)
    Y = tref.cwell_compact_spmm(*cwell_compact.compact(W32), Bt)
    assert Y.dtype == torch.float32 and _max_rel(Y, Yj) <= 1e-5
    assert _max_rel(tk.spmm(W32, Bt), Yj) <= 1e-5
    # bf16 values with a bf16 B (JAX's K6 refuses bf16 values): each
    # column is the compact SpMV's, rounded once
    Yb = tref.cwell_compact_spmm(plan, cvals, Bt)
    assert Yb.dtype == BF
    for j in range(3):
        assert torch.equal(Yb[:, j], tref.cwell_compact_spmv(
            plan, cvals, Bt[:, j]))


@pytest.mark.parametrize("bdt", ["f32", "bf16"])
def test_bell_plain_version_against_jax_kernel(interpret_mode, bdt):
    """K8 on bf16 blocks: JAX sums in float32 and writes B's dtype."""
    Bj = jbsr_to_bell(jcsr_to_bsr(jto_csr(jgen.poisson2d(8,
                                                         dtype=np.float32)),
                                  8))
    Bjb = Bj.with_data(Bj.blocks.astype(jnp.bfloat16))
    At = tconv.bell_from_numpy(np.asarray(Bjb.blocks), np.asarray(
        Bj.indices), Bj.shape, device="cpu")
    assert At.blocks.dtype == BF
    B = np.random.default_rng(3).standard_normal((64, 3)).astype(np.float32)
    dt_j = jnp.float32 if bdt == "f32" else jnp.bfloat16
    dt_t = torch.float32 if bdt == "f32" else BF
    Yj = jpb.bell_spmm_pallas(Bjb, jnp.asarray(B, dt_j))
    Y = tref.bell_spmm_wide(At, torch.from_numpy(B).to(dt_t))
    assert Y.dtype == dt_t and str(Yj.dtype) == str(dt_t).split(".")[1]
    if bdt == "f32":
        assert _max_rel(Y, Yj) <= 1e-5
    else:
        assert _within_ulp(Y, Yj)


def test_carry_across_bf16_arrays():
    """``np.asarray`` of a JAX bf16 array crosses as bf16 (widened through
    float32, exact); float32 arrays of bf16-exact values cross with
    ``dtype=torch.bfloat16``; bf16 tensors go to the host as float32."""
    Aj, _ = _dia_pair(3, random_values=True)
    raw = np.asarray(Aj.data)
    assert raw.dtype.name == "bfloat16"
    A1 = tconv.dia_from_numpy(raw, Aj.offsets, Aj.shape, device="cpu")
    A2 = tconv.dia_from_numpy(np.asarray(Aj.data, np.float32), Aj.offsets,
                              Aj.shape, device="cpu", dtype=BF)
    A3 = tconv.dia_from_offsets(Aj.offsets, raw, Aj.shape, device="cpu")
    assert A1.data.dtype == A2.data.dtype == A3.data.dtype == BF
    assert torch.equal(A1.data, A2.data) and torch.equal(A1.data, A3.data)
    np.testing.assert_array_equal(A1.data.float().numpy(),
                                  np.asarray(Aj.data, np.float32))
    S = tconv.to_scipy_csr(A1)
    assert S.dtype == np.float32
    C = tconv.csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                              device="cpu", dtype=BF)
    assert C.data.dtype == BF
    assert torch.equal(C.todense(), A1.todense())


def _torch(a) -> torch.Tensor:
    """A JAX array as a tensor of its dtype (bf16 through float32)."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(BF) if a.dtype == jnp.bfloat16 else t


def _solve_both(Aj, At, b, **kw):
    b = jnp.asarray(b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, rj = tpu_sparse.solve(Aj, b, **kw)
    tracing.reset()
    xt, rt = tpu_sparse_torch.solve(At, _torch(b), **kw)
    assert tk.CAST_COUNTS["values_casts"] == 0
    return (xj, rj), (xt, rt)


@pytest.mark.parametrize("fmt,method", [("dia", "cg"), ("dia", "bicgstab"),
                                        ("dia", "gmres"), ("cwell", "cg")])
def test_bf16_values_f32_b_solves_match_jax(fmt, method):
    """bf16 values with a float32 b: both packages run float32 arithmetic
    on the bf16-rounded values. The CWELL is held against JAX on the
    float32 cast (JAX's CWELL reference sums in bf16: R15)."""
    Aj, At = _dia_pair(6)
    b = np.random.default_rng(4).standard_normal(At.shape[0]).astype(
        np.float32)
    if fmt == "cwell":
        Wj = jcsr_to_cwell(jto_csr(Aj.with_data(Aj.data.astype(
            jnp.float32))))
        At = tconv.cwell_from_numpy(np.asarray(Wj.vals), np.asarray(
            Wj.idx2), np.asarray(Wj.srow), Wj.shape, nnz=Wj.nnz,
            fill=Wj.fill, group=Wj.group, device="cpu", dtype=BF)
        Aj = Wj
    (xj, rj), (xt, rt) = _solve_both(Aj, At, b, method=method, tol=1e-5)
    assert xt.dtype == torch.float32
    assert rt.converged and rj.converged
    assert rt.iterations == rj.iterations
    assert _max_rel(xt, xj) <= 1e-5


CASES = [(m, M) for m in ("cg", "bicgstab", "gmres", "fgmres", "minres")
         for M in (None, "jacobi")]


@pytest.mark.parametrize("method,M", CASES)
def test_bf16_b_solves_match_jax(method, M):
    """bf16 values and a bf16 b on poisson2d(8) at tol 1e-2: GMRES and
    FGMRES ran only after B1 (their least squares in float32)."""
    L = jgen.poisson2d(8, dtype=np.float32)
    Aj = L.with_data(L.data.astype(jnp.bfloat16))
    At = tconv.dia_from_numpy(np.asarray(L.data), L.offsets, L.shape,
                              device="cpu", dtype=BF)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(64),
                    jnp.bfloat16)
    (xj, rj), (xt, rt) = _solve_both(Aj, At, b, method=method, tol=1e-2,
                                     M=M)
    assert xt.dtype == BF
    assert rt.converged == rj.converged
    assert abs(rt.iterations - rj.iterations) <= 1
    assert _max_rel(xt, xj) <= 3e-2


@pytest.mark.parametrize("method", ["cg", "gmres"])
def test_bf16_batched_solves_match_jax_and_singles(method):
    """(n, 3) bf16 right-hand sides, batched: JAX's ``converged``, CG's
    iterations within 1 of JAX's (B4: the column dots summed products
    rounded to bf16, which took other iterations), and each column equal
    to its own single solve. GMRES's counts are not compared: at tol 1e-2
    a bf16 GMRES restarts from a true residual computed in bf16, whose
    rounding floor is near the tolerance, and column 0 stalls there for
    24 cycles in JAX and 47 in the port (ROADMAP queue 3, B1)."""
    L = jgen.poisson2d(8, dtype=np.float32)
    Aj = L.with_data(L.data.astype(jnp.bfloat16))
    At = tconv.dia_from_numpy(np.asarray(L.data), L.offsets, L.shape,
                              device="cpu", dtype=BF)
    B = jnp.asarray(np.random.default_rng(0).standard_normal((64, 3)),
                    jnp.bfloat16)
    (Xj, rj), (Xt, rt) = _solve_both(Aj, At, B, method=method, tol=1e-2,
                                     multi_rhs="batch")
    assert rt.converged == rj.converged
    if method == "cg":
        assert abs(rt.iterations - rj.iterations) <= 1
    assert _max_rel(Xt, Xj) <= 3e-2
    Bt = _torch(B)
    for j in range(3):
        xj, _ = tpu_sparse_torch.solve(At, Bt[:, j].contiguous(),
                                       method=method, tol=1e-2)
        assert torch.equal(Xt[:, j], xj)


@pytest.mark.parametrize("method", ["amg", "direct"])
def test_bf16_amg_and_direct_match_jax(method):
    """backend amg (B2) and direct (B3) on bf16 values and a bf16 b: the
    AMG set-up runs in float64 on the host and its levels in bf16, as
    JAX's; the direct solve returns a bf16 x, not converged by R11's 1e-4
    rule, in both."""
    L = jgen.poisson2d(8, dtype=np.float32)
    Aj = L.with_data(L.data.astype(jnp.bfloat16))
    At = tconv.dia_from_numpy(np.asarray(L.data), L.offsets, L.shape,
                              device="cpu", dtype=BF)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(64),
                    jnp.bfloat16)
    (xj, rj), (xt, rt) = _solve_both(Aj, At, b, method=method, tol=1e-2)
    assert xt.dtype == BF
    assert rt.converged == rj.converged
    if method == "amg":
        assert rt.converged and abs(rt.iterations - rj.iterations) <= 1
    else:
        assert not rt.converged
    assert _max_rel(xt, xj) <= 3e-2


def test_bf16_gradient_in_b_matches_jax_grad():
    """The adjoint of a bf16-values CG with a float32 b: b.grad against
    ``jax.grad`` of JAX's solve on the same values."""
    Aj, At = _dia_pair(6)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(At.shape[0]).astype(np.float32)
    w = rng.standard_normal(At.shape[0]).astype(np.float32)
    gj = jax.grad(lambda bb: jnp.sum(tpu_sparse.solve(
        Aj, bb, method="cg", tol=1e-6)[0] * w))(jnp.asarray(b))
    bt = torch.from_numpy(b).requires_grad_()
    x, res = tpu_sparse_torch.solve(At, bt, method="cg", tol=1e-6)
    (x * torch.from_numpy(w)).sum().backward()
    assert res.converged and bt.grad.dtype == torch.float32
    assert _max_rel(bt.grad, gj) <= 1e-5


def test_refined_solve_with_bf16_inner_sweeps():
    """``refined_solve(..., inner_dtype=torch.bfloat16)``: bf16 inner CG
    sweeps under a float64 outer residual reach 1e-8 (JAX's refined_solve
    takes the same inner dtype; on poisson2d(10) both took 70 inner
    iterations to the same x)."""
    from tpu_sparse_torch.solvers import cg_full
    from tpu_sparse_torch.solvers.mixed import refined_solve

    A = jgen.poisson2d(10, dtype=np.float64)
    At = tconv.dia_from_numpy(np.asarray(A.data), A.offsets, A.shape,
                              device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(100))
    x, info, iters, res = refined_solve(
        cg_full, At, b, tol=1e-8, inner_dtype=BF, inner_tol=1e-2,
        inner_maxiter=200, max_sweeps=10)
    assert int(info) == 0 and x.dtype == torch.float64
    x_ref = np.linalg.solve(np.asarray(A.todense()), b.numpy())
    assert float(torch.linalg.vector_norm(b - At @ x)
                 / torch.linalg.vector_norm(b)) <= 1e-8
    assert np.abs(x.numpy() - x_ref).max() <= 1e-7 * np.abs(x_ref).max()
