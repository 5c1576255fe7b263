"""tpu_sparse_torch.direct (banded, dense, host SuperLU, SparseLU) and the
router's method="direct" against tpu_sparse.direct on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port: the banded solvers (Thomas, PCR, block PCR, banded LU) and
``dense_solve`` within 1e-10 relative in float64 and 1e-4 in float32, the
block-tridiagonal blocks and Gauss-Jordan solve equal, the dispatch of
``direct_solve``, ``solve(A, b, method="direct")`` on a tridiagonal, a
2-D Poisson DIA and a general CSR (host SuperLU on the CPU), their
gradients in b and A's values, ``solve(A, B)`` with k = 3, SparseLU, and
the LDC with ``solver="direct"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_sparse
import tpu_sparse_torch
from examples.ldc import ldc_solver as jldc
from tpu_sparse import direct as jd
from tpu_sparse.direct import banded as jband
from tpu_sparse.direct.sparse_lu import SparseLU as JSparseLU
from tpu_sparse.sparse import convert as jconv
from tpu_sparse_torch import direct as td
from tpu_sparse_torch.apps import ldc as tldc
from tpu_sparse_torch.direct import banded as tband
from tpu_sparse_torch.solvers.batched import gj_solve_batched
from tpu_sparse_torch.sparse import convert as tconv
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _dia(offsets, data, n):
    """The same DIA in both packages."""
    return (jconv.dia_from_offsets(offsets, data, (n, n)),
            tconv.dia_from_offsets(offsets, data, (n, n), device="cpu"))


def _csr(S):
    """A scipy CSR in both packages."""
    S = S.tocsr()
    S.sort_indices()
    args = (S.data, S.indices.astype(np.int32), S.indptr.astype(np.int32),
            S.shape)
    return jconv.csr_from_arrays(*args), tconv.csr_from_arrays(
        *args, device="cpu")


def _banded(n, offsets, dtype, seed):
    """A diagonally dominant nonsymmetric band with the given offsets."""
    rng = np.random.default_rng(seed)
    data = -rng.random((len(offsets), n)).astype(dtype)
    data[offsets.index(0)] = 2.5 * len(offsets)
    return data


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _skewed_poisson(nx, dtype=np.float64):
    """poisson2d(nx) + 0.1 triu as a general CSR (the JAX bench's
    general-direct system)."""
    P = jconv.to_csr(tpu_sparse.sparse.generators.poisson2d(nx, dtype=dtype))
    S = sp.csr_matrix((np.asarray(P.data), np.asarray(P.indices),
                       np.asarray(P.indptr)), shape=P.shape)
    return (S + 0.1 * sp.triu(S, k=1)).tocsr().astype(dtype)


CASES = [(name, dt) for name in ("thomas", "pcr", "block_pcr", "banded_lu",
                                 "dense") for dt in (np.float64, np.float32)]


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{d.__name__}" for n, d in CASES])
def test_banded_and_dense_solvers_match_jax(name, dtype):
    n, offsets = {"thomas": (300, (-1, 0, 1)), "pcr": (300, (-1, 0, 1)),
                  "block_pcr": (600, (-20, -1, 0, 1, 20)),
                  "banded_lu": (144, (-12, -3, 0, 5, 12)),
                  "dense": (60, (-7, -1, 0, 2, 9))}[name]
    data = _banded(n, list(offsets), dtype, seed=len(name))
    Aj, At = _dia(offsets, data, n)
    b = np.random.default_rng(7).standard_normal(n).astype(dtype)
    if name == "block_pcr":
        xj = jband.block_pcr_solve(Aj, jnp.asarray(b), block_size=24)
        xt = tband.block_pcr_solve(At, torch.from_numpy(b), block_size=24)
    else:
        fn = name + "_solve"
        xj = getattr(jband, fn)(Aj, jnp.asarray(b))
        xt = getattr(tband, fn)(At, torch.from_numpy(b))
    assert xt.dtype == torch.from_numpy(b).dtype
    assert _rel(xt.numpy(), xj) <= TOL[dtype]
    # an (n, k) right-hand side: every column equals its single solve
    B = np.random.default_rng(8).standard_normal((n, 3)).astype(dtype)
    fn = getattr(tband, name + "_solve")
    X = fn(At, torch.from_numpy(B))
    for j in range(3):
        assert _rel(X[:, j].numpy(), fn(At, torch.from_numpy(
            np.ascontiguousarray(B[:, j]))).numpy()) <= TOL[dtype]


def test_band_blocks_and_factors_match_jax():
    """The block-tridiagonal view (one scatter in the port) and the banded
    LU factors equal JAX's; the Gauss-Jordan solve the port keeps for
    block CG equals JAX's ``_gj_solve_batched``."""
    offsets = (-9, -4, 0, 1, 9)
    data = _banded(100, list(offsets), np.float64, seed=3)
    Aj, At = _dia(offsets, data, 100)
    for s in (9, 16):
        for bj, bt in zip(jband._band_blocks(Aj, s)[:3],
                          tband._band_blocks(At, s)[:3]):
            assert np.array_equal(np.asarray(bj), bt.numpy())
    Lj, Uj, wj = jband.banded_lu_factor(Aj)
    Lt, Ut, wt = tband.banded_lu_factor(At)
    assert wj == wt
    assert _rel(Lt.numpy(), Lj) <= 1e-12 and _rel(Ut.numpy(), Uj) <= 1e-12
    rng = np.random.default_rng(4)
    D = rng.standard_normal((5, 6, 6)) + 6 * np.eye(6)
    R = rng.standard_normal((5, 6, 2))
    assert _rel(gj_solve_batched(torch.from_numpy(D),
                                 torch.from_numpy(R)).numpy(),
                jband._gj_solve_batched(jnp.asarray(D), jnp.asarray(R))
                ) <= 1e-12


def test_direct_solve_dispatch():
    """CPU dispatch as in JAX off the TPU: Thomas for a tridiagonal, the
    banded LU for a band up to n / 4, host SuperLU for a general matrix
    past 4096 rows, the dense LU otherwise; bit for bit the branch's
    result."""
    rng = np.random.default_rng(5)
    Aj, At = _dia((-1, 0, 1), _banded(80, [-1, 0, 1], np.float64, 1), 80)
    b = torch.from_numpy(rng.standard_normal(80))
    assert torch.equal(td.direct_solve(At, b), td.thomas_solve(At, b))
    Aj, At = _dia((-8, 0, 3), _banded(80, [-8, 0, 3], np.float64, 2), 80)
    assert torch.equal(td.direct_solve(At, b), td.banded_lu_solve(At, b))
    Aj, At = _dia((-30, 0, 3), _banded(80, [-30, 0, 3], np.float64, 3), 80)
    assert not td.needs_host_splu(At) and not jd.needs_host_splu(Aj)
    assert torch.equal(td.direct_solve(At, b), td.dense_solve(At, b))
    S = _skewed_poisson(65)
    Cj, Ct = _csr(S)
    assert td.needs_host_splu(Ct) and jd.needs_host_splu(Cj)
    bb = torch.from_numpy(rng.standard_normal(S.shape[0]))
    assert torch.equal(td.direct_solve(Ct, bb), td.host_splu_solve(Ct, bb))
    with pytest.raises(TypeError, match="matrix operand"):
        td.direct_solve(lambda v: v, b)


@pytest.fixture(scope="module")
def router_systems():
    """A tridiagonal, a 2-D Poisson DIA (bandwidth 12) and a general CSR
    past the densify limit (n = 4225), in both packages."""
    tri = _dia((-1, 0, 1), _banded(200, [-1, 0, 1], np.float64, 11), 200)
    pj = tpu_sparse.sparse.generators.poisson2d(12)
    pt = tpu_sparse_torch.sparse.generators.poisson2d(12, device="cpu")
    return {"tridiagonal": tri, "poisson2d": (pj, pt),
            "general_csr": _csr(_skewed_poisson(65))}


@pytest.mark.parametrize("name", ["tridiagonal", "poisson2d", "general_csr"])
def test_router_direct_and_gradients_match_jax(router_systems, name):
    """solve(A, b, method='direct') and its gradients in b and A's values
    (JAX: ``direct_solve_diff`` under ``jax.grad``) within 1e-10."""
    Aj, At = router_systems[name]
    n = At.shape[0]
    rng = np.random.default_rng(12)
    b = rng.standard_normal(n)
    w = rng.standard_normal(n)
    xj, rj = tpu_sparse.solve(Aj, jnp.asarray(b), method="direct")
    vals = tpu_sparse_torch.sparse.values(At).clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    xt, rt = tpu_sparse_torch.solve(At.with_data(vals), bt, method="direct")
    assert rt.converged and rj.converged and rt.backend == "direct"
    assert rt.iterations is None and rt.residual < 1e-12
    assert _rel(xt.detach().numpy(), xj) <= 1e-10
    (xt * torch.from_numpy(w)).sum().backward()

    def loss(data, bb):
        return jnp.vdot(jnp.asarray(w),
                        jd.direct_solve_diff(Aj.with_data(data), bb))

    gA, gb = jax.grad(loss, argnums=(0, 1))(Aj.data, jnp.asarray(b))
    assert _rel(bt.grad.numpy(), gb) <= 1e-10
    assert _rel(vals.grad.numpy(), gA) <= 1e-10


def test_router_multi_rhs_and_refusals(router_systems):
    """solve(A, B) with k = 3 against JAX's router and the port's single
    solves; M is dropped with a warning; a matrix-free operator and a
    multi-RHS b that requires grad are refused."""
    rng = np.random.default_rng(13)
    for name in ("poisson2d", "general_csr"):
        Aj, At = router_systems[name]
        B = rng.standard_normal((At.shape[0], 3))
        Xj, rj = tpu_sparse.solve(Aj, jnp.asarray(B), method="direct")
        Xt, rt = tpu_sparse_torch.solve(At, torch.from_numpy(B),
                                        method="direct")
        assert rt.converged and rt.residual < 1e-12
        assert _rel(Xt.numpy(), Xj) <= 1e-10
        for j in range(3):
            xj = tpu_sparse_torch.solve(At, torch.from_numpy(B[:, j].copy()),
                                        method="direct")[0]
            assert _rel(Xt[:, j].numpy(), xj.numpy()) <= 1e-12
    Aj, At = router_systems["poisson2d"]
    b = torch.ones(At.shape[0], dtype=torch.float64)
    with pytest.warns(UserWarning, match="M is ignored"):
        x, r = tpu_sparse_torch.solve(At, b, backend="module_c", M="jacobi")
    assert r.converged and r.backend == "direct"
    assert torch.equal(x, tpu_sparse_torch.api.solver.direct_solve(At, b)[0])
    with pytest.raises(TypeError, match="matrix operand"):
        tpu_sparse_torch.solve(lambda v: At @ v, b, method="direct")
    with pytest.raises(ValueError, match="not differentiable"):
        tpu_sparse_torch.solve(At, torch.ones(At.shape[0], 2,
                                              dtype=torch.float64,
                                              requires_grad=True),
                               method="direct")


def test_router_caches_host_factors_per_values_tensor(router_systems):
    """One host factorization per live values tensor: a repeat solve hits
    it, new values or an in-place write refactor, a freed matrix drops
    its entry."""
    _, At = router_systems["general_csr"]
    solver = tpu_sparse_torch.SparseSolver()
    b = torch.ones(At.shape[0], dtype=torch.float64)
    A2 = At.with_data(At.data.clone())
    solver.solve(A2, b, method="direct")
    lu = solver._host_splu(A2)
    solver.solve(A2, b, method="direct")
    assert solver._host_splu(A2) is lu and len(solver._host_lu_cache) == 1
    A2.data.mul_(2.0)
    x2, r2 = solver.solve(A2, b, method="direct")
    assert solver._host_splu(A2) is not lu and r2.converged
    del A2, x2
    assert len(solver._host_lu_cache) == 0


def test_sparse_lu_matches_jax():
    """SparseLU (block sweeps, K4/K5 on the card) against JAX's on the
    skewed Poisson CSR: solve, solve_transpose, an (n, k) b and the
    b-gradient of ``sparse_lu_solve_diff``; a singular matrix raises."""
    S = _skewed_poisson(40)
    Cj, Ct = _csr(S)
    lj, lt = JSparseLU.factor(Cj), td.SparseLU.factor(Ct)
    assert (lj.depth_l, lj.depth_u) == (lt.depth_l, lt.depth_u)
    rng = np.random.default_rng(14)
    B = rng.standard_normal((S.shape[0], 2))
    b = B[:, 0].copy()
    Xj = jax.jit(lambda L, bb, BB: (
        L.solve(bb), L.solve_transpose(bb), L.solve(BB),
        L.solve_transpose(jnp.ones_like(bb))))(lj, jnp.asarray(b),
                                               jnp.asarray(B))
    bt = torch.from_numpy(b).requires_grad_()
    Xt = (td.sparse_lu_solve_diff(lt, bt), lt.solve_transpose(bt.detach()),
          lt.solve(torch.from_numpy(B)))
    for a, j in zip(Xt, Xj):
        assert _rel(a.detach().numpy(), j) <= 1e-10
    Xt[0].sum().backward()  # b_bar = A^-T 1
    assert _rel(bt.grad.numpy(), Xj[3]) <= 1e-10
    bad = sp.csr_matrix((np.array([1.0, 0.0]), np.array([0, 1]),
                         np.array([0, 1, 2])), shape=(2, 2))
    with pytest.raises(RuntimeError, match="singular"):
        td.SparseLU.factor(_csr(bad)[1])


def test_ldc_direct_matches_jax():
    """LDC with solver='direct' at nx = 12 (the banded LU of the pinned
    matrix on the CPU) against the JAX example's fields after 12 steps."""
    kw = dict(nx=12, Re=100.0, solver="direct")
    js = jldc.LDCSolver(jldc.LDCConfig(**kw))
    js.run(12)
    ts = tldc.LDCSolver(tldc.LDCConfig(device="cpu", **kw))
    st = ts.run(12)
    for name in ("u", "v", "p"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.shape == b.shape and a.dtype == b.dtype == np.float64
        assert float(np.abs(a - b).max()) <= 1e-8, name
    assert st["pressure_iters_total"] == 0 and st["mass_residual"] < 1e-6


@pytest.mark.parametrize("kind", ["banded", "dense", "host_splu"])
def test_direct_bf16_operand(kind, monkeypatch):
    """method='direct' on bf16 values: the host loops and SuperLU take the
    operands as float32 (numpy has no bf16), torch's dense solve runs in
    float32 (it has no bf16 LU), and x comes back in bf16; ``converged``
    follows R11's 1e-4 rule for non-float64, as in JAX. It raised
    TypeError before."""
    from tpu_sparse_torch.sparse.containers import values, with_values

    n = 64
    rng = np.random.default_rng(9)
    if kind == "banded":
        A = tconv.dia_from_numpy(np.stack([-np.ones(n), 4 * np.ones(n),
                                           -np.ones(n)]).astype(np.float32),
                                 (-1, 0, 1), (n, n), device="cpu")
    else:
        S = (sp.random(n, n, 0.1, random_state=9, dtype=np.float32)
             + 8 * sp.identity(n, dtype=np.float32)).tocsr()
        A = tconv.csr_from_arrays(S.data, S.indices, S.indptr, (n, n),
                                  device="cpu")
        if kind == "host_splu":
            monkeypatch.setattr(td, "_DENSE_DIRECT_LIMIT", 16)
    A = with_values(A, values(A).to(torch.bfloat16))
    b = torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(torch.bfloat16)
    x, res = tpu_sparse_torch.solve(A, b, method="direct")
    assert x.dtype == torch.bfloat16 and res.converged is False
    Ad = A.todense().float()
    assert float(torch.linalg.vector_norm(b.float() - Ad @ x.float())
                 / torch.linalg.vector_norm(b.float())) <= 2e-2
