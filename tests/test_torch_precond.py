"""tpu_sparse_torch preconditioners and their routes through solve(),
against tpu_sparse on the CPU.

Tolerances (float64): the L1-Jacobi diagonal within 1e-14 of max|d|;
Chebyshev, Neumann, FSAI and FSAI(2) applies within 1e-12 of max|y| (FSAI's
G within 1e-12 as well); a block apply (``matmat``) equal to the column
loop within 1e-14; routed solves against JAX's with equal iterations and x
within 1e-10 of max|x| (the mixed path: iterations within 2 and x within
1e-9, its f32 inner sweeps summing in another order); a route against the
port's own function on the same preconditioner exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_sparse
import tpu_sparse_torch
from tpu_sparse import precond as jpre
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import csr_from_arrays as jcsr
from tpu_sparse_torch import precond as tpre
from tpu_sparse_torch.kernels import as_matmat
from tpu_sparse_torch.solvers import block_cg, cg_full
from tpu_sparse_torch.solvers.mixed import _cast_precond, cg_refined
from tpu_sparse_torch.sparse.convert import (csr_from_arrays,
                                             dia_from_numpy)
from tpu_sparse_torch.sparse.cwell import csr_to_cwell
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


def _port(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                          device="cpu")


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= rel * max(
        float(np.abs(b).max()), 1e-300)


def _general(n=300, seed=4):
    """A random sparse matrix with signed entries and empty rows."""
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, density=0.03, random_state=rng, format="csr")
    S.data = rng.standard_normal(S.nnz)
    S = (S + sp.diags(np.where(np.arange(n) % 7 == 3, 0.0, 5.0))).tocsr()
    S.sort_indices()
    return S


@pytest.mark.parametrize("fmt", ["dia", "csr", "coo", "cwell", "dense"])
def test_l1_jacobi_diag_matches_jax(fmt):
    if fmt == "dia":
        Aj = jgen.poisson2d_anisotropic(12, eps=30.0)
        At, dj = _port(Aj), jpre.l1_jacobi_diag(Aj)
    else:
        S = _general()
        Ajc = jcsr(S.data, S.indices, S.indptr, S.shape)
        dj = jpre.l1_jacobi_diag(Ajc)
        At = csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                             device="cpu")
        At = {"csr": At, "coo": At.tocoo(), "cwell": csr_to_cwell(At),
              "dense": At.todense()}[fmt]
    _close(tpre.l1_jacobi_diag(At).numpy(), dj, 1e-14)


BUILDERS = {
    "chebyshev": (jpre.chebyshev_preconditioner,
                  tpre.chebyshev_preconditioner, {}),
    "neumann": (jpre.neumann_preconditioner, tpre.neumann_preconditioner,
                {}),
    "fsai": (jpre.fsai_preconditioner, tpre.fsai_preconditioner, {}),
    "fsai2": (jpre.fsai_preconditioner, tpre.fsai_preconditioner,
              {"pattern_power": 2}),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_preconditioner_apply_matches_jax(name):
    jb, tb, kw = BUILDERS[name]
    Aj = jgen.poisson3d_27pt(6, dtype=np.float64)
    Mj, Mt = jb(Aj, **kw), tb(_port(Aj), **kw)
    rng = np.random.default_rng(8)
    v = rng.standard_normal(Aj.shape[0])
    _close(Mt(torch.from_numpy(v)).numpy(), Mj(jnp.asarray(v)), 1e-12)
    if name.startswith("fsai"):
        Gj, _ = jpre.fsai_setup(Aj, **kw)
        Gt, _ = tpre.fsai_setup(_port(Aj), **kw)
        _close(Gt.todense().numpy(), Gj.todense(), 1e-12)
    V = torch.from_numpy(rng.standard_normal((Aj.shape[0], 3)))
    Y = as_matmat(Mt)(V)
    for j in range(3):
        _close(Y[:, j].numpy(), Mt(V[:, j].contiguous()).numpy(), 1e-14)
    assert Mt.to(torch.float32)(V[:, 0].float()).dtype == torch.float32


def _system(nx=16):
    Aj = jgen.poisson2d(nx)
    x_true = np.random.default_rng(7).standard_normal(Aj.shape[0])
    bj = Aj @ jnp.asarray(x_true)
    return Aj, _port(Aj), bj, torch.from_numpy(np.array(bj))


@pytest.mark.parametrize("kw,slack,rel", [
    (dict(backend="amg", accelerant=None), 0, 1e-10),
    (dict(M="chebyshev", precision="full"), 0, 1e-10),
    (dict(M="neumann", precision="full"), 0, 1e-10),
    (dict(M="fsai2", precision="full"), 0, 1e-10),
    (dict(M="amg", precision="auto"), 2, 1e-9),
], ids=["amg-stationary", "chebyshev", "neumann", "fsai2", "amg-mixed"])
def test_routes_match_jax(kw, slack, rel):
    """The mixed case is JAX's cg_refined with its AMG M against the
    port's, whose f32 sweeps run the cast hierarchy."""
    Aj, At, bj, bt = _system()
    xj, rj = tpu_sparse.solve(Aj, bj, tol=1e-10, **kw)
    xt, rt = tpu_sparse_torch.solve(At, bt, tol=1e-10, **kw)
    assert rt.converged and rj.converged
    assert abs(rt.iterations - rj.iterations) <= slack
    assert (rt.backend, rt.method) == (rj.backend, rj.method)
    _close(xt.numpy(), xj, rel)


@pytest.mark.parametrize("kw,build", [
    (dict(backend="amg"), lambda A: tpre.amg_preconditioner(A)),
    (dict(method="amg"), lambda A: tpre.amg_preconditioner(A)),
    (dict(backend="module_b"), lambda A: tpre.amg_preconditioner(A)),
    (dict(M="amg"), lambda A: tpre.amg_preconditioner(A)),
    (dict(M="fsai"), lambda A: tpre.fsai_preconditioner(A)),
    (dict(M="jacobi"), lambda A: tpre.jacobi_preconditioner(A)),
], ids=["backend-amg", "method-amg", "module_b", "M-amg", "M-fsai",
        "M-jacobi"])
def test_routes_run_the_named_preconditioner(kw, build):
    """Each name routes to CG with that preconditioner (amg: maxiter 100),
    built once per matrix and reused."""
    _, At, _, bt = _system()
    solver = tpu_sparse_torch.SparseSolver()
    x, res = solver.solve(At, bt, tol=1e-10, precision="full", **kw)
    amg = "backend" in kw or kw.get("method") == "amg"
    x0, info, iters, _ = cg_full(At, bt, tol=1e-10, M=build(At),
                                 maxiter=100 if amg else None)
    assert res.converged and int(info) == 0
    assert res.iterations == int(iters)
    assert torch.equal(x, x0)
    assert res.backend == ("amg" if amg else "krylov")
    caches = solver._amg_cache._store, solver._m_cache._store
    assert sum(len(c) for c in caches) == 1
    solver.solve(At, bt, tol=1e-10, precision="full", **kw)
    assert sum(len(c) for c in caches) == 1


def test_ilu0_raises_naming_item_16():
    """ILU(0) raised naming ROADMAP item 16b until it was ported. Now its
    apply matches JAX's within 1e-12 of max|y|, M='ilu0' routes to CG with
    that preconditioner (equal to cg_full with it, bit for bit), built
    once per matrix and reused, and a non-DIA operand raises JAX's
    ValueError."""
    Aj, At, _, bt = _system(6)
    v = np.random.default_rng(9).standard_normal(Aj.shape[0])
    M = tpre.ilu0_preconditioner(At)
    _close(M(torch.from_numpy(v)).numpy(),
           jpre.ilu0_preconditioner(Aj)(jnp.asarray(v)), 1e-12)
    solver = tpu_sparse_torch.SparseSolver()
    x, res = solver.solve(At, bt, tol=1e-10, precision="full", M="ilu0")
    x0, info, iters, _ = cg_full(At, bt, tol=1e-10, M=M)
    assert res.converged and int(info) == 0
    assert res.iterations == int(iters) and torch.equal(x, x0)
    solver.solve(At, bt, tol=1e-10, precision="full", M="ilu0")
    assert len(solver._m_cache._store) == 1
    for fn in (tpre.ilu0_preconditioner, tpre.ilu0_factor):
        with pytest.raises(ValueError, match="requires a DIA"):
            fn(csr_from_arrays(*_csr_arrays(), device="cpu"))


def _csr_arrays():
    S = _general(40)
    return S.data, S.indices, S.indptr, S.shape


def test_multi_rhs_amg_runs_block_cg_with_the_vcycle():
    """solve(A, B, backend='amg') is block CG with the V-cycle as M; its
    block products go through the preconditioner's matmat."""
    _, At, _, _ = _system()
    B = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (At.shape[0], 3)))
    solver = tpu_sparse_torch.SparseSolver()
    X, res = solver.solve(At, B, backend="amg", tol=1e-10)
    M = tpre.amg_preconditioner(At)
    X0, infos, iters, _ = block_cg(At, B, tol=1e-10, maxiter=100, M=M)
    assert res.converged and bool((infos == 0).all())
    assert res.iterations == int(iters) and res.backend == "amg"
    torch.testing.assert_close(X, X0, rtol=0, atol=0)
    for j in range(3):
        r = B[:, j] - At @ X[:, j]
        assert float(r.norm() / B[:, j].norm()) <= 1e-10


class _Spy:
    """A preconditioner that records its block and dtype calls."""

    def __init__(self, dtype=torch.float64, log=None):
        self.dtype, self.log = dtype, [] if log is None else log

    def __call__(self, v):
        assert v.dim() == 1, "a block must go through matmat"
        return v.clone()

    def matmat(self, V):
        self.log.append(("matmat", V.shape))
        return V.clone()

    def to(self, dtype):
        self.log.append(("to", dtype))
        return _Spy(dtype, self.log)


def test_as_matmat_uses_a_preconditioners_matmat():
    M = _Spy()
    V = torch.ones(5, 3, dtype=torch.float64)
    assert torch.equal(as_matmat(M)(V), V)
    assert M.log == [("matmat", (5, 3))]


def test_mixed_precision_casts_preconditioners_with_to():
    """The f32 sweeps get M.to(float32): an AMG hierarchy is cast, not
    applied in float64 inside the float32 loop."""
    _, At, _, bt = _system(8)
    M = tpre.amg_preconditioner(At)
    M32 = _cast_precond(M, torch.float32)
    assert M32.hier.coarse_inv.dtype == torch.float32
    assert all(lv.dinv_l1.dtype == torch.float32 for lv in M32.hier.levels)
    spy = _Spy()
    x, info, _, _ = cg_refined(At, bt, tol=1e-10, M=spy)
    assert int(info) == 0 and ("to", torch.float32) in spy.log
