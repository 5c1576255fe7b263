"""tpu_sparse_torch's ILU(0) (``precond/ilu.py``: the host factor, the
level schedule, the level-scheduled apply, ``M="ilu0"``) against the JAX
package's ``ilu0_factor`` / ``ilu0_preconditioner`` on the CPU, from the
same numpy inputs, in float64 unless stated.

Tolerances: the factors' L and U within 1e-13 of max|L|, max|U| (float32:
1e-5); an apply within 1e-12 of max|y| (the substitutions run the same
operations; only the summation order of a row's products and the level
order differ); ``matmat`` equal to the column loop within 1e-14; on a
tridiagonal matrix ILU(0) is the exact LU, so A M(v) = v within 1e-10
(JAX's ``tests/test_precond.py`` case); the float32 cast of M within
1e-5 of the float64 apply; the gradient in b through ``solve(A, b,
M="ilu0")`` within 1e-9 of ``jax.grad``'s; multi-RHS solves with
``M="ilu0"`` (every product of M one ``matmat``) against JAX's at tol
1e-10: equal iterations, X within 1e-10 of max|X| (the float64 "auto"
batch runs the batched refinement: iterations within 2). Level counts
are exact. JAX's results are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sparse
import tpu_sparse_torch
from tpu_sparse import precond as jpre
from tpu_sparse.sparse import containers as jcont
from tpu_sparse.sparse import convert as jconv
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch import precond as tpre
from tpu_sparse_torch.precond.ilu import ILU0Preconditioner
from tpu_sparse_torch.solvers.mixed import _cast_precond
from tpu_sparse_torch.sparse import generators as tgen
from tpu_sparse_torch.sparse.containers import DIA
from tpu_sparse_torch.sparse.convert import dia_from_numpy, to_csr
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


def _zero_pivot():
    """tridiagonal(16) with every entry 1: the factor's pivots alternate
    1, 0, 1, 0, ... (JAX's zero -> 1 rule, in the factor and in U's
    divisor)."""
    return jgen.tridiagonal(16, main=1.0, off=1.0)


SYSTEMS = {
    "tridiagonal": lambda: jgen.tridiagonal(32),
    "poisson2d": lambda: jgen.poisson2d(6),
    "poisson3d_27pt": lambda: jgen.poisson3d_27pt(5, dtype=np.float64),
    "convection_diffusion": lambda: jgen.convection_diffusion(36),
    "zero_pivot": _zero_pivot,
    "poisson3d_27pt_f32": lambda: jgen.poisson3d_27pt(5),
}


def _port(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                          device="cpu")


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= rel * max(
        float(np.abs(b).max()), 1e-300)


def _v(n, seed=0, dtype=np.float64, k=None):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.fixture(scope="module")
def jax_ilu():
    """JAX's factors and one apply per system, computed once."""
    out = {}
    for name, make in SYSTEMS.items():
        Aj = make()
        L, U = jpre.ilu0_factor(Aj)
        M = jpre.ilu0_preconditioner(Aj)
        y = M(jnp.asarray(_v(Aj.shape[0], dtype=Aj.data.dtype)))
        out[name] = (Aj, L, U, np.asarray(y))
    return out


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_factor_matches_jax(name, jax_ilu):
    Aj, Lj, Uj, _ = jax_ilu[name]
    Lt, Ut = tpre.ilu0_factor(_port(Aj))
    rel = 1e-5 if name.endswith("f32") else 1e-13
    assert Lt.offsets == Lj.offsets and Ut.offsets == Uj.offsets
    assert Lt.shape == Lj.shape and Ut.shape == Uj.shape
    assert Lt.dtype == Ut.dtype == torch.from_numpy(
        np.array(Aj.data)).dtype
    _close(Lt.data.numpy(), Lj.data, rel)
    _close(Ut.data.numpy(), Uj.data, rel)


@pytest.mark.parametrize("name", [n for n in SYSTEMS
                                  if not n.endswith("f32")])
def test_apply_matches_jax_and_matmat_the_column_loop(name, jax_ilu):
    Aj, _, _, yj = jax_ilu[name]
    M = tpre.ilu0_preconditioner(_port(Aj))
    assert isinstance(M, ILU0Preconditioner)
    n = Aj.shape[0]
    y = M(torch.from_numpy(_v(n)))
    assert y.dtype == torch.float64
    _close(y.numpy(), yj, 1e-12)
    V = torch.from_numpy(_v(n, seed=1, k=3))
    Y = M.matmat(V)
    for j in range(3):
        _close(Y[:, j].numpy(), M(V[:, j].contiguous()).numpy(), 1e-14)


@pytest.mark.parametrize("nx", [4, 6, 9])
def test_level_counts_are_the_stencil_wavefronts(nx):
    """Levels come from the factors' nonzeros: the stored wrap-around
    zeros chain no rows. poisson2d(nx): 2 nx - 1 levels each way (i + j);
    the 27-point stencil: 7 (nx - 1) + 1 (i + 2j + 4k; from nx = 4 on: at
    nx = 3 the factor fills wrap-around entries and the count is 27)."""
    M2 = tpre.ilu0_preconditioner(tgen.poisson2d(nx, device="cpu"))
    assert M2.levels == (2 * nx - 1, 2 * nx - 1)
    M3 = tpre.ilu0_preconditioner(tgen.poisson3d_27pt(nx, device="cpu"))
    assert M3.levels == (7 * (nx - 1) + 1, 7 * (nx - 1) + 1)
    # every level's rows are independent: no pack reads its own level
    for sweep in (M3.fwd, M3.bwd):
        for (a, b), N in zip(sweep.ranges, sweep.packs):
            assert (N is None) == (a == 0)
            if N is not None:
                assert N.shape == (b - a, nx ** 3)
                assert bool((N.tocsr().indices < a).all())


def test_ilu0_exact_for_tridiagonal():
    """ILU(0) on a tridiagonal pattern is the exact LU: A M(v) = v."""
    A = tgen.tridiagonal(32, device="cpu")
    v = torch.from_numpy(_v(32, seed=8))
    x = tpre.ilu0_preconditioner(A)(v)
    _close((A @ x).numpy(), v.numpy(), 1e-10)


def test_errors_match_jax():
    Aj = jgen.poisson2d(4)
    At = _port(Aj)
    with pytest.raises(ValueError, match="requires a DIA") as ej:
        jpre.ilu0_preconditioner(jconv.to_csr(Aj))
    with pytest.raises(ValueError, match="requires a DIA") as et:
        tpre.ilu0_preconditioner(to_csr(At))
    assert str(et.value) == str(ej.value)
    offs = tuple(o for o in Aj.offsets if o != 0)
    keep = [d for d, o in enumerate(Aj.offsets) if o != 0]
    no_diag_j = jcont.DIA(Aj.data[np.asarray(keep)], offs, Aj.shape)
    no_diag_t = DIA(At.data[keep], offs, At.shape)
    with pytest.raises(ValueError, match="stored main diagonal") as ej:
        jpre.ilu0_factor(no_diag_j)
    for fn in (tpre.ilu0_factor, tpre.ilu0_preconditioner):
        with pytest.raises(ValueError, match="stored main diagonal") as et:
            fn(no_diag_t)
        assert str(et.value) == str(ej.value)


def test_precision_cast_keeps_the_factor():
    """``_cast_precond(M, float32)`` (the mixed path's inner sweeps) casts
    the packs' values and U's divisor; the order is unchanged and nothing
    is refactored."""
    A = tgen.poisson3d_27pt(5, dtype=np.float64, device="cpu")
    M = tpre.ilu0_preconditioner(A)
    M32 = _cast_precond(M, torch.float32)
    assert isinstance(M32, ILU0Preconditioner) and M32.dtype == torch.float32
    assert M32.order is M.order and M32.levels == M.levels
    assert M32.bwd.diag.dtype == torch.float32
    assert all(N.dtype == torch.float32 for N in M32.fwd.operators())
    v = torch.from_numpy(_v(A.shape[0], seed=3))
    y32 = M32(v.float())
    assert y32.dtype == torch.float32
    _close(y32.double().numpy(), M(v).numpy(), 1e-5)
    Mc = M.to("cpu")
    _close(Mc(v).numpy(), M(v).numpy(), 0.0)


def test_gradient_through_solve_matches_jax():
    """d/db of sum(w * x) for x = solve(A, b, M='ilu0', method='cg'): one
    adjoint solve with the same M (CG is symmetric), against jax.grad."""
    Aj = jgen.poisson2d(6)
    b, w = _v(36, seed=4), _v(36, seed=5)

    def loss_j(bb):
        x, _ = tpu_sparse.solve(Aj, bb, M="ilu0", method="cg", tol=1e-12,
                                precision="full")
        return jnp.sum(x * jnp.asarray(w))

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(b)))
    bt = torch.from_numpy(b).requires_grad_()
    x, res = tpu_sparse_torch.solve(_port(Aj), bt, M="ilu0", method="cg",
                                    tol=1e-12, precision="full")
    assert res.converged
    (x * torch.from_numpy(w)).sum().backward()
    _close(bt.grad.numpy(), gj, 1e-9)


@pytest.mark.parametrize("kw", [
    dict(method="cg", multi_rhs="block", precision="full"),
    dict(method="bicgstab", multi_rhs="batch", precision="full"),
    dict(method="cg", multi_rhs="batch", precision="auto"),
], ids=["block-cg", "batch-bicgstab", "batch-cg-auto"])
def test_multi_rhs_solves_match_jax(kw):
    Aj = jgen.poisson2d(6)
    B = _v(36, seed=2, k=3)
    xj, rj = tpu_sparse.solve(Aj, jnp.asarray(B), M="ilu0", tol=1e-10,
                              **kw)
    xt, rt = tpu_sparse_torch.solve(_port(Aj), torch.from_numpy(B),
                                    M="ilu0", tol=1e-10, **kw)
    assert rt.converged and rj.converged
    slack = 2 if kw["precision"] == "auto" else 0
    assert abs(rt.iterations - rj.iterations) <= slack
    _close(xt.numpy(), np.asarray(xj), 1e-10)
