"""tpu_sparse_torch's multi-RHS router and refinement against tpu_sparse
on the CPU: ``batch_refined``, ``solve(A, B)`` under ``multi_rhs``
auto/block/batch and each precision, on DIA, CWELL, dense and callable
operands, and the multi-RHS refusals.

The same seeded numpy inputs go through both packages. Tolerances are
stated at each test: float64 'full' solves with equal iteration counts and
X within 1e-10 of max|X|; the refinement's float32 inner sweeps within 2
iterations and X within 1e-9 (see the test); relative residuals at the
rounding floor of float64 within 1e-11.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_sparse
import tpu_sparse_torch
from tpu_sparse.solvers import batched as jbatched
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import to_csr as jto_csr
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell
from tpu_sparse_torch.solvers import batched, mixed
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse.cwell import csr_to_cwell


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


def _system(kind):
    Aj = {"spd": jgen.poisson3d_27pt(6, dtype=np.float64),
          "nonsym": jgen.convection_diffusion_3d_27pt(6, dtype=np.float64),
          }[kind]
    return Aj, _dia(Aj)


@pytest.mark.parametrize("method,kind", [("cg", "spd"),
                                         ("bicgstab", "nonsym"),
                                         ("gmres", "nonsym")])
def test_batch_refined_matches_jax(method, kind):
    """float64 defect correction with float32 inner sweeps, per column
    (three sweeps, which these systems need at most): the same infos and
    inner iteration counts, and X within 1e-9 of max|X|, not 1e-10: the
    float32 sweeps round apart, and the refinement bounds the difference
    of the two solutions by the tolerance, not by float64 rounding. The
    inner counts are sums of float32 CG / BiCGStab runs, which cross their
    tolerance an iteration apart: within 2 of JAX's (GMRES cycles match)."""
    Aj, At = _system(kind)
    B = _block(Aj.shape[0], 3, 17)
    out_j = jbatched.batch_refined(method, Aj, jnp.asarray(B), tol=1e-10,
                                   max_sweeps=3)
    out_t = mixed.batch_refined(method, At, torch.from_numpy(B), tol=1e-10,
                                max_sweeps=3)
    Xj = np.asarray(out_j[0])
    assert np.array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    assert np.abs(out_t[2].numpy() - np.asarray(out_j[2])).max() <= 2
    assert np.abs(out_t[0].numpy() - Xj).max() <= 1e-9 * np.abs(Xj).max()
    assert int(out_t[1].abs().sum()) == 0
    # each column as the single-RHS refinement of the port
    single = {"cg": mixed.cg_refined, "bicgstab": mixed.bicgstab_refined,
              "gmres": mixed.gmres_refined}[method]
    x0, _, k0, _ = single(At, torch.from_numpy(B[:, 0].copy()), tol=1e-10,
                          max_sweeps=3)
    assert int(k0) == int(out_t[2][0])
    torch.testing.assert_close(x0, out_t[0][:, 0], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method,multi_rhs,M,precision", [
    ("cg", "auto", None, "full"),
    ("cg", "auto", "jacobi", "full"),
    ("cg", "block", None, "auto"),
    ("cg", "batch", "jacobi", "full"),
    ("bicgstab", "auto", None, "full"),
    ("gmres", "batch", None, "full"),
    ("cg", "auto", None, "auto"),
])
def test_solve_multirhs_matches_jax(method, multi_rhs, M, precision):
    Aj, At = _system("spd" if method == "cg" else "nonsym")
    B = _block(Aj.shape[0], 3, 16)
    kw = dict(method=method, tol=1e-10, M=M, multi_rhs=multi_rhs,
              precision=precision)
    Xj, rj = tpu_sparse.solve(Aj, jnp.asarray(B), **kw)
    Xt, rt = tpu_sparse_torch.solve(At, torch.from_numpy(B), **kw)
    assert rt.converged and rj.converged
    assert rt.iterations == rj.iterations
    assert abs(rt.residual - rj.residual) <= 1e-11  # the rounding floor
    Xj = np.asarray(Xj)
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-10 * np.abs(Xj).max()
    assert rt.residual <= 1e-10 * 1.0001


def test_solve_multirhs_on_cwell_dense_and_callable():
    """Operands that JAX solves alike: a CWELL pack, a dense matrix and a
    matrix-free callable, batched CG in float64."""
    Aj, At = _system("spd")
    Cj = jto_csr(Aj)
    B = _block(Aj.shape[0], 2, 17)
    Xj, rj = tpu_sparse.solve(jcsr_to_cwell(Cj), jnp.asarray(B), tol=1e-10,
                              precision="full")
    dense = torch.from_numpy(np.asarray(Aj.todense()))
    for op in (csr_to_cwell(_csr(Cj)), dense, lambda v: dense @ v):
        Xt, rt = tpu_sparse_torch.solve(op, torch.from_numpy(B), tol=1e-10,
                                        precision="full")
        assert rt.converged and rt.iterations == rj.iterations
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                                   atol=1e-10 * float(np.abs(Xj).max()))


def test_multirhs_refusals_and_warnings():
    Aj, At = _system("spd")
    B = torch.from_numpy(_block(At.shape[0], 2, 18))
    with pytest.raises(ValueError, match="unknown multi_rhs"):
        tpu_sparse_torch.solve(At, B, multi_rhs="nope")
    with pytest.raises(ValueError, match="unknown multi_rhs"):
        tpu_sparse.solve(Aj, jnp.asarray(B.numpy()), multi_rhs="nope")
    with pytest.raises(ValueError, match="not differentiable"):
        tpu_sparse_torch.solve(At, B.clone().requires_grad_())
    data = At.data.clone().requires_grad_()
    with pytest.raises(ValueError, match="not differentiable"):
        tpu_sparse_torch.solve(At.with_data(data), B, precision="full")
    with pytest.warns(UserWarning, match="unavailable with"):
        tpu_sparse_torch.solve(At, B, multi_rhs="block", precision="mixed",
                               tol=1e-8)
    for fn in (batched.batch_fcg, batched.batch_fgmres,
               batched.batch_minres):
        with pytest.raises(NotImplementedError, match="item 14"):
            fn(At, B)
    with pytest.raises(ValueError, match="shape"):
        batched.batch_cg(At, B[:, 0])
