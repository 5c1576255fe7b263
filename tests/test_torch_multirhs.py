"""tpu_sparse_torch's multi-RHS slice against tpu_sparse on the CPU: the
plain SpMMs and the batched and block solvers (the router and the batched
refinement are in test_torch_multirhs_solve.py).

The same seeded numpy inputs go through both packages. Tolerances: plain
SpMMs within 1e-13 (float64) / 1e-6 (float32) of max|Y| of the JAX XLA
reference (sums in another order); the plain CWELL SpMM against the JAX
Pallas K6 and K7 in interpret mode within 1e-5 (float32); float64 solves
with equal per-column infos and iteration counts and X within 1e-10 of
max|X|, and residual norms within 1e-11 of max||b_j|| (their rounding
floor); float32 batched CG within 2 iterations and 1e-4 of max|X| (the
column sums of the port and JAX's vdot round apart, and float32 CG
crosses its threshold within an iteration or two of each other).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_sparse.kernels import reference as jref
from tpu_sparse.precond.jacobi import jacobi_preconditioner as jjacobi
from tpu_sparse.solvers import batched as jbatched
from tpu_sparse.solvers import block as jblock
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import dense_to_csr as jdense_to_csr
from tpu_sparse.sparse.convert import to_csr as jto_csr
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell
from tpu_sparse.sparse.cwell import csr_to_cwell_segments as jsegments
from tpu_sparse_torch.kernels import as_matmat, spmm
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner
from tpu_sparse_torch.solvers import batched, block
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse.cwell import csr_to_cwell, csr_to_cwell_segments
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


def _dia(Aj):
    return tconvert.dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                                   device="cpu")


def _csr(Cj):
    return tconvert.csr_from_arrays(np.asarray(Cj.data),
                                    np.asarray(Cj.indices),
                                    np.asarray(Cj.indptr), Cj.shape,
                                    device="cpu")


def _block(n, k, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _random_csr(n, m, density, seed, dtype):
    rng = np.random.default_rng(seed)
    Ad = ((rng.random((n, m)) < density)
          * rng.standard_normal((n, m))).astype(dtype)
    Cj = jdense_to_csr(Ad)
    return Cj, _csr(Cj)


def _operands(fmt, dtype):
    """(JAX operand, port operand, m) of one format, from one matrix."""
    if fmt == "dia":
        Aj = jgen.poisson2d(9, 7, dtype=dtype)
        return Aj, _dia(Aj), Aj.shape[1]
    Cj, Ct = _random_csr(257, 190, 0.08, 3, dtype)
    if fmt == "csr":
        return Cj, Ct, 190
    if fmt == "coo":
        return Cj.tocoo(), Ct.tocoo(), 190
    if fmt == "cwellseg":
        Cj, Ct = _random_csr(300, 700, 0.03, 4, dtype)
        return jsegments(Cj, seg_cols=256), \
            csr_to_cwell_segments(Ct, seg_cols=256), 700
    if fmt.startswith("cwell"):
        group = int(fmt[-1])
        return jcsr_to_cwell(Cj, group=group), csr_to_cwell(Ct, group=group), \
            190
    Ad = np.asarray(Cj.todense())
    return jnp.asarray(Ad), torch.from_numpy(Ad), 190


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-6),
                                         (np.float64, 1e-13)])
@pytest.mark.parametrize("fmt", ["dia", "csr", "coo", "cwell1", "cwell4",
                                 "cwellseg", "dense"])
def test_plain_spmm_matches_jax_reference(fmt, dtype, bound):
    from tpu_sparse.kernels import spmm as jspmm

    Aj, At, m = _operands(fmt, dtype)
    B = _block(m, 5, 7, dtype)
    Yj = np.asarray(jspmm(Aj, jnp.asarray(B)))
    Yt = spmm(At, torch.from_numpy(B)).numpy()
    assert Yt.dtype == Yj.dtype and Yt.shape == Yj.shape
    assert np.abs(Yt - Yj).max() <= bound * np.abs(Yj).max()
    # A @ B of a container is the SpMM
    if not isinstance(At, torch.Tensor):
        np.testing.assert_array_equal((At @ torch.from_numpy(B)).numpy(), Yt)


def test_plain_cwell_spmm_matches_pallas_k6_k7_interpret():
    """JAX K6 (the gather kernel) and K7 (the one-hot kernel) in interpret
    mode on a grouped pack with m not a multiple of 128."""
    from tpu_sparse.kernels import pallas_cwell

    Cj, Ct = _random_csr(300, 333, 0.05, 8, np.float32)
    Wj, Wt = jcsr_to_cwell(Cj, group=2), csr_to_cwell(Ct, group=2)
    B = _block(333, 8, 9, np.float32)
    pallas_cwell._INTERPRET = True
    try:
        y6 = np.asarray(pallas_cwell.cwell_spmm_pallas_gather(
            Wj, jnp.asarray(B)))
        y7 = np.asarray(pallas_cwell._cwell_spmm_impl(
            Wj.vals, Wj.idx2, Wj.srow, jnp.asarray(B), shape=Wj.shape, rb=4,
            kt=8, group=Wj.group))
    finally:
        pallas_cwell._INTERPRET = False
    yt = tref.cwell_spmm(Wt, torch.from_numpy(B)).numpy()
    for y in (y6, y7):
        assert np.abs(yt - y).max() <= 1e-5 * np.abs(y).max()


def test_plain_cwell_spmm_fill_rule_and_columns():
    """Columns at or past m gather 0, and each column of Y is the SpMV of
    the column of B."""
    Cj, Ct = _random_csr(200, 130, 0.1, 5, np.float64)
    W = csr_to_cwell(Ct)
    # point a padding slot (value 0) at column 255, past m = 130
    b, s, lane = (W.vals == 0).nonzero()[0].tolist()
    W.idx2[b, s, lane] = 255 - 128 * int(W.srow[b, s])
    assert int((W.gcols() >= 130).sum()) == 1
    B = torch.from_numpy(_block(130, 3, 6))
    Y = tref.cwell_spmm(W, B)
    for j in range(3):
        torch.testing.assert_close(Y[:, j], tref.cwell_spmv(W, B[:, j]),
                                   rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Cj.todense()) @
                               B.numpy(), rtol=1e-12, atol=1e-12)


def _system(kind):
    Aj = {"spd": jgen.poisson3d_27pt(6, dtype=np.float64),
          "nonsym": jgen.convection_diffusion_3d_27pt(6, dtype=np.float64),
          }[kind]
    return Aj, _dia(Aj)


def _same_result(out_t, out_j, B, scalar_iters=False):
    """Equal infos and iteration counts, X within 1e-10 of max|X|, and
    residual norms within 1e-11 of max||b_j||: at tol 1e-10 they sit at
    the rounding floor of a float64 residual, where the two packages'
    sums differ in the last digits."""
    Xt, it_, kt, rt = out_t
    Xj, ij, kj, rj = out_j
    Xj = np.asarray(Xj)
    assert np.array_equal(it_.numpy(), np.asarray(ij))
    if scalar_iters:
        assert int(kt) == int(kj)
    else:
        assert np.array_equal(kt.numpy(), np.asarray(kj)), (kt, kj)
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-10 * np.abs(Xj).max()
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-11 * np.linalg.norm(B, axis=0).max())


@pytest.mark.parametrize("method,kind,jacobi,kw", [
    ("cg", "spd", False, {}),
    ("cg", "spd", True, {}),
    ("bicgstab", "nonsym", False, {}),
    ("gmres", "nonsym", False, dict(restart=10)),
    ("gmres", "nonsym", True, dict(restart=10, solve_method="incremental")),
])
def test_batch_solvers_match_jax(method, kind, jacobi, kw):
    Aj, At = _system(kind)
    B = _block(Aj.shape[0], 4, 11)
    B[:, 2] = 0.0  # a zero column: 0 iterations, X = 0, converged
    Mj, Mt = (jjacobi(Aj), jacobi_preconditioner(At)) if jacobi else (None,
                                                                      None)
    jfn = getattr(jbatched, "batch_" + method)
    tfn = getattr(batched, "batch_" + method)
    out_j = jfn(Aj, jnp.asarray(B), tol=1e-10, M=Mj, **kw)
    out_t = tfn(At, torch.from_numpy(B), tol=1e-10, M=Mt, **kw)
    _same_result(out_t, out_j, B)
    assert int(out_t[2][2]) == 0 and float(out_t[0][:, 2].abs().max()) == 0


def test_batch_cg_float32_matches_jax():
    Aj = jgen.poisson3d_27pt(6, dtype=np.float32)
    B = _block(Aj.shape[0], 3, 12, np.float32)
    Xj, ij, kj, _ = jbatched.batch_cg(Aj, jnp.asarray(B), tol=1e-5)
    Xt, it_, kt, _ = batched.batch_cg(_dia(Aj), torch.from_numpy(B),
                                      tol=1e-5)
    assert np.array_equal(it_.numpy(), np.asarray(ij))
    assert np.abs(kt.numpy() - np.asarray(kj)).max() <= 2
    Xj = np.asarray(Xj)
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-4 * np.abs(Xj).max()


@pytest.mark.parametrize("operand,jacobi", [("dia", False), ("dia", True),
                                            ("cwell", False)])
def test_block_cg_matches_jax(operand, jacobi):
    Aj, At = _system("spd")
    if operand == "cwell":
        Cj = jto_csr(Aj)
        Aj, At = jcsr_to_cwell(Cj), csr_to_cwell(_csr(Cj))
    B = _block(At.shape[0], 5, 13)
    Mj, Mt = (jjacobi(Aj), jacobi_preconditioner(At)) if jacobi else (None,
                                                                      None)
    out_j = jblock.block_cg(Aj, jnp.asarray(B), tol=1e-10, M=Mj)
    out_t = block.block_cg(At, torch.from_numpy(B), tol=1e-10, M=Mt)
    _same_result(out_t, out_j, B, scalar_iters=True)


def test_block_cg_replaces_the_residual_every_32_iterations():
    """A run long enough to pass the replacement iterations (poisson2d(16),
    53 iterations): JAX and the port replace on the same iterations."""
    Aj = jgen.poisson2d(16, dtype=np.float64)
    B = _block(256, 2, 14)
    out_j = jblock.block_cg(Aj, jnp.asarray(B), tol=1e-10)
    out_t = block.block_cg(_dia(Aj), torch.from_numpy(B), tol=1e-10)
    assert int(out_t[2]) > 32
    _same_result(out_t, out_j, B, scalar_iters=True)


def test_as_matmat_applies_each_kind_of_operator():
    Aj, At = _system("spd")
    V = torch.from_numpy(_block(At.shape[0], 3, 19))
    want = torch.from_numpy(np.asarray(jref.dia_spmm(Aj, jnp.asarray(
        V.numpy()))))
    M = jacobi_preconditioner(At)
    for op, ref in ((At, want), (At.todense(), want),
                    (lambda v: tref.dia_spmv(At, v), want),
                    (M, M.dinv[:, None] * V), (None, V)):
        torch.testing.assert_close(as_matmat(op)(V), ref, rtol=1e-13,
                                   atol=1e-13)


def test_batch_cg_bf16_columns_equal_single_solves():
    """A bf16 column dot takes exact products summed in float32, as the
    single-RHS loop's ``torch.vdot`` does: every column of a batched bf16
    CG equals its own single solve (products rounded to bf16 first took
    other iterations)."""
    import tpu_sparse_torch

    A = jgen.poisson2d(8, dtype=np.float32)
    At = tconvert.dia_from_numpy(np.asarray(A.data), A.offsets, A.shape,
                                 device="cpu")
    At = At.with_data(At.data.to(torch.bfloat16))
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 3)).astype(np.float32)).to(torch.bfloat16)
    X, infos, iters, _ = batched.batch_cg(At, B, tol=1e-2)
    for j in range(3):
        x, res = tpu_sparse_torch.solve(At, B[:, j].contiguous(),
                                        method="cg", tol=1e-2)
        assert torch.equal(X[:, j], x)
        assert int(iters[j]) == res.iterations
