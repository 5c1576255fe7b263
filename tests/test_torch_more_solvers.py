"""tpu_sparse_torch's single-reduction CG, flexible CG, MINRES and FGMRES
(plain, refined, batched, through the router) against the JAX package on
the CPU, from the same numpy inputs.

Tolerances: float64 solves take the same info and iterations (FGMRES:
restart cycles) as JAX's, x within 1e-10 of max|x| (both run the same
recurrence; only the summation order of dot products and of the CWELL
matvec differs). MINRES with Jacobi: JAX's loop stops on the M-norm
estimate with its true residual 1.3x above tol ||b|| and reports info -1
(its fault R10); the port restarts from x, so it is held to convergence
instead (info 0, true residual <= tol ||b||) and to
``scipy.sparse.linalg.minres`` with the same Jacobi M (x within 1e-8 of
max|x|; both stop near 1e-10 relative). float32 solves: x within
1e-4 of max|x| and iterations within 1 (MINRES on the indefinite system
within 3: its float32 recurrence drifts with the summation order). The
flexible methods with JAX's AMG V(0,3) hierarchy carried across: as
float64 above. The refined forms (tol 1e-8): info 0, x within 1e-8 of
max|x|, inner iterations within 5% (float32 sweeps). The batched solvers:
each column equal to its single solve (iterations equal, x within
1e-10) and to JAX's ``batch_*`` (x within 1e-10, iterations equal;
MINRES within 2, as JAX's vmap stops a column up to 2 iterations after
JAX's single solve of it). JAX calls are cached per case, so each JAX
solve runs once for the whole file.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sparse.solvers as js
import tpu_sparse_torch
from tpu_sparse.precond import amg as jamg
from tpu_sparse.precond.jacobi import jacobi_preconditioner as jjacobi
from tpu_sparse.sparse import containers as jcont
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch import solvers as ts
from tpu_sparse_torch.precond import amg as tamg
from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner as tjacobi
from tpu_sparse_torch.sparse.convert import dia_from_numpy, to_csr
from tpu_sparse_torch.sparse.cwell import csr_to_cwell
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

METHODS = ("cg_sr", "fcg", "minres", "fgmres")
# restart of every FGMRES call in this file
KW = {"fgmres": dict(restart=10)}


def _shifted_laplacian(shift=1.5):
    """JAX tests/test_solvers.py's indefinite system: poisson2d(12) -
    shift I."""
    A = jgen.poisson2d(12)
    d0 = A.offsets.index(0)
    return jcont.DIA(A.data.at[d0].add(-shift), A.offsets, A.shape)


SYSTEMS = {
    "poisson2d": lambda: jgen.poisson2d(12),
    "tridiagonal": lambda: jgen.tridiagonal(100),
    "shifted": _shifted_laplacian,
    "convdiff": lambda: jgen.convection_diffusion(64),
}
# the system each method is held on first (MINRES: indefinite; FGMRES:
# nonsymmetric), and its second case (with Jacobi)
FIRST = {"cg_sr": "poisson2d", "fcg": "poisson2d", "minres": "shifted",
         "fgmres": "convdiff"}
SECOND = {"cg_sr": "tridiagonal", "fcg": "tridiagonal",
          "minres": "poisson2d", "fgmres": "convdiff"}


def _jax_system(name, dtype=np.float64):
    A = SYSTEMS[name]()
    return A.with_data(A.data.astype(dtype))


def _port(Aj, fmt="dia"):
    A = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                       device="cpu")
    return csr_to_cwell(to_csr(A)) if fmt == "cwell" else A


def _rhs(n, dtype=np.float64, seed=0, k=None):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@functools.lru_cache(maxsize=None)
def _jax_full(method, system, dtype, jacobi, tol, maxiter):
    Aj = _jax_system(system, dtype)
    M = jjacobi(Aj) if jacobi else None
    out = getattr(js, f"{method}_full")(
        Aj, jnp.asarray(_rhs(Aj.shape[0], dtype)), tol=tol, maxiter=maxiter,
        M=M, **KW.get(method, {}))
    return tuple(np.asarray(o) for o in out)


def _port_full(method, system, dtype, jacobi, tol, maxiter, fmt="dia"):
    Aj = _jax_system(system, dtype)
    At = _port(Aj, fmt)
    M = tjacobi(At) if jacobi else None
    return getattr(ts, f"{method}_full")(
        At, torch.from_numpy(_rhs(Aj.shape[0], dtype)), tol=tol,
        maxiter=maxiter, M=M, **KW.get(method, {}))


def _close(xt, xj, rel):
    xj = np.asarray(xj)
    assert np.abs(np.asarray(xt) - xj).max() <= rel * np.abs(xj).max()


CASES_F64 = [(m, FIRST[m], False, fmt) for m in METHODS
             for fmt in ("dia", "cwell")] + \
    [(m, SECOND[m], True, "dia") for m in METHODS]


def _scipy_minres_jacobi(system):
    """scipy's MINRES with the Jacobi M on the same float64 system."""
    import scipy.sparse.linalg as spl

    from tpu_sparse_torch.sparse.convert import to_scipy_csr

    S = to_scipy_csr(_port(_jax_system(system)))
    d = S.diagonal()
    M = spl.LinearOperator(S.shape, matvec=lambda v: v / d)
    x, info = spl.minres(S, _rhs(S.shape[0]), rtol=1e-10, maxiter=2000,
                         M=M)
    assert info == 0
    return x


@pytest.mark.parametrize("method,system,jacobi,fmt", CASES_F64)
def test_full_f64_matches_jax(method, system, jacobi, fmt):
    key = (method, system, np.float64, jacobi, 1e-10, 2000)
    xt, it, kt, rt = _port_full(*key, fmt=fmt)
    assert int(it) == 0
    if (method, jacobi) == ("minres", True):
        # JAX's R10: its loop stops on the M-norm estimate and reports
        # info -1; the port restarts and converges (module docstring)
        b = _rhs(xt.shape[0])
        At = _port(_jax_system(system))
        assert float(np.linalg.norm(b - (At @ xt).numpy())) <= \
            1e-10 * np.linalg.norm(b)
        assert abs(float(rt) - np.linalg.norm(b - (At @ xt).numpy())) \
            <= 1e-12 * np.linalg.norm(b)
        _close(xt.numpy(), _scipy_minres_jacobi(system), 1e-8)
        return
    xj, ij, kj, rj = _jax_full(*key)
    assert int(ij) == 0
    assert int(kt) == int(kj)
    _close(xt.numpy(), xj, 1e-10)
    assert abs(float(rt) - float(rj)) <= 1e-10 * np.linalg.norm(
        _rhs(xj.shape[0]))


@pytest.mark.parametrize("method", METHODS)
def test_full_f32_matches_jax(method):
    key = (method, FIRST[method], np.float32, False, 1e-5, 2000)
    xj, ij, kj, _ = _jax_full(*key)
    xt, it, kt, _ = _port_full(*key)
    assert xt.dtype == torch.float32
    assert int(it) == int(ij) == 0
    assert abs(int(kt) - int(kj)) <= (3 if method == "minres" else 1)
    _close(xt.numpy(), xj, 1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_maxiter_stop_matches_jax(method):
    """Stopping at maxiter (37 iterations: not a multiple of the host-check
    interval; FGMRES 2 cycles) counts the same iterations, returns the
    same x and reports info -1."""
    maxiter = 2 if method == "fgmres" else 37
    key = (method, FIRST[method], np.float64, False, 1e-14, maxiter)
    xj, ij, kj, _ = _jax_full(*key)
    xt, it, kt, _ = _port_full(*key)
    assert int(it) == int(ij) == -1
    assert int(kt) == int(kj) == maxiter
    _close(xt.numpy(), xj, 1e-10)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's native loader, built in this worker's own directory when the
    shared build was lost to a race (its loader caches a failed load)."""
    from tpu_sparse import native

    if native._lib is None:
        mp = pytest.MonkeyPatch()
        mp.setenv("TPU_SPARSE_NATIVE_CACHE",
                  str(tmp_path_factory.mktemp("jax_native")))
        native._tried = False
        try:
            assert native.available(), "JAX's native AMG set-up did not build"
        finally:
            mp.undo()
    return native


def _spec(op):
    """A JAX level operator as the numpy dict ``amg_hierarchy_from_numpy``
    takes."""
    if op is None:
        return None
    if isinstance(op, jamg.TentativeP):
        return dict(kind="tentative", vals=np.asarray(op.vals),
                    agg=np.asarray(op.agg), shape=op.shape)
    if isinstance(op, jcont.DIA):
        return dict(kind="dia", data=np.asarray(op.data),
                    offsets=op.offsets, shape=op.shape)
    if isinstance(op, jcont.CSR):
        return dict(kind="csr", data=np.asarray(op.data),
                    indices=np.asarray(op.indices),
                    indptr=np.asarray(op.indptr), shape=op.shape)
    return dict(kind="dense", data=np.asarray(op))


@pytest.mark.parametrize("method,make,kw", [
    ("fcg", lambda: jgen.tridiagonal(200), dict(maxiter=200)),
    ("fgmres", lambda: jgen.convection_diffusion(200), dict(restart=30)),
])
def test_flexible_methods_with_jax_amg_v03(method, make, kw, jax_native):
    """JAX's own flexible case: the nonsymmetric AMG V(0,3) cycle as M
    (tests/test_solvers.py), on JAX's hierarchy carried across."""
    Aj = make()
    hj = jamg.amg_setup(Aj)
    Mj = jamg.amg_preconditioner(Aj, pre_sweeps=0, post_sweeps=3)
    ht = tamg.amg_hierarchy_from_numpy(
        [tuple(_spec(o) for o in (lv.A, lv.P, lv.R)) + (
            np.asarray(lv.dinv_l1),) for lv in hj.levels],
        np.asarray(hj.coarse_inv), device="cpu")
    Mt = tamg.AMGPreconditioner(ht, pre_sweeps=0, post_sweeps=3)
    b = _rhs(Aj.shape[0], seed=4)
    xj, ij, kj, _ = getattr(js, f"{method}_full")(
        Aj, jnp.asarray(b), tol=1e-8, M=Mj, **kw)
    xt, it, kt, _ = getattr(ts, f"{method}_full")(
        _port(Aj), torch.from_numpy(b), tol=1e-8, M=Mt, **kw)
    assert int(it) == int(ij) == 0
    assert int(kt) == int(kj)
    _close(xt.numpy(), xj, 1e-10)


@functools.lru_cache(maxsize=None)
def _jax_refined(method):
    Aj = _jax_system(FIRST[method])
    out = getattr(js, f"{method}_refined")(
        Aj, jnp.asarray(_rhs(Aj.shape[0], seed=6)), tol=1e-8,
        **KW.get(method, {}))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("method", METHODS)
def test_refined_matches_jax(method):
    Aj = _jax_system(FIRST[method])
    b = _rhs(Aj.shape[0], seed=6)
    xj, ij, kj, _ = _jax_refined(method)
    xt, it, kt, rt = getattr(ts, f"{method}_refined")(
        _port(Aj), torch.from_numpy(b), tol=1e-8, **KW.get(method, {}))
    assert int(it) == int(ij) == 0
    assert abs(int(kt) - int(kj)) <= 0.05 * int(kj)
    _close(xt.numpy(), xj, 1e-8)
    assert float(rt) <= 1e-8 * np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def _jax_batch(method):
    Aj = _jax_system(FIRST[method])
    out = getattr(js, f"batch_{method}")(
        Aj, jnp.asarray(_rhs(Aj.shape[0], seed=8, k=3)), tol=1e-10,
        maxiter=2000, **KW.get(method, {}))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("method", ["fcg", "minres", "fgmres"])
def test_batched_match_single_solves_and_jax(method):
    """Every column of ``batch_*`` on a CWELL (one SpMM per matvec) is the
    single-RHS solve of that column, and JAX's vmapped solve."""
    Aj = _jax_system(FIRST[method])
    W = _port(Aj, "cwell")
    B = _rhs(Aj.shape[0], seed=8, k=3)
    kw = dict(tol=1e-10, maxiter=2000, **KW.get(method, {}))
    X, infos, iters, res = getattr(ts, f"batch_{method}")(
        W, torch.from_numpy(B), **kw)
    Xj, ij, kj, _ = _jax_batch(method)
    assert infos.tolist() == ij.tolist() == [0, 0, 0]
    # JAX's vmapped MINRES stops a column up to 2 iterations after JAX's
    # own single solve of it (77 / 79 on column 1); the port stops with
    # the single solve
    gap = 2 if method == "minres" else 0
    assert np.abs(iters.numpy() - kj).max() <= gap
    _close(X.numpy(), Xj, 1e-10)
    for j in range(3):
        x, info, k, r = getattr(ts, f"{method}_full")(
            W, torch.from_numpy(B[:, j].copy()), **kw)
        assert int(info) == 0 and int(k) == int(iters[j])
        _close(X[:, j].numpy(), x.numpy(), 1e-10)
        assert abs(float(res[j]) - float(r)) <= 1e-10 * np.linalg.norm(
            B[:, j])


@pytest.mark.parametrize("method", METHODS)
def test_router_single_multi_rhs_and_auto(method):
    """solve() runs the method's ``*_diff`` for precision='full', its
    ``*_refined`` for 'auto' (float64), its batched solver for an (n, k)
    b (cg_sr: batched CG, reported as cg_sr), and its ``batch_refined``
    for a float64 (n, k) b with 'auto'."""
    Aj = _jax_system(FIRST[method])
    At = _port(Aj)
    n = Aj.shape[0]
    kw = dict(method=method, **KW.get(method, {}))
    b = torch.from_numpy(_rhs(n))
    x, r = tpu_sparse_torch.solve(At, b, tol=1e-10, maxiter=2000,
                                  precision="full", **kw)
    xj, _, kj, _ = _jax_full(method, FIRST[method], np.float64, False,
                             1e-10, 2000)
    assert r.converged and r.method == method and r.backend == "krylov"
    assert r.iterations == int(kj)
    _close(x.numpy(), xj, 1e-10)

    b6 = torch.from_numpy(_rhs(n, seed=6))
    x, r = tpu_sparse_torch.solve(At, b6, tol=1e-8, **kw)
    xj, _, kj, _ = _jax_refined(method)
    assert r.converged and abs(r.iterations - int(kj)) <= 0.05 * int(kj)
    _close(x.numpy(), xj, 1e-8)

    B = torch.from_numpy(_rhs(n, seed=8, k=3))
    X, r = tpu_sparse_torch.solve(At, B, tol=1e-10, maxiter=2000,
                                  precision="full", **kw)
    assert r.converged and r.method == method
    if method == "cg_sr":
        Xref = ts.batch_cg(At, B, tol=1e-10, maxiter=2000)[0]
        assert torch.equal(X, Xref)
    else:
        _close(X.numpy(), _jax_batch(method)[0], 1e-10)
    X, r = tpu_sparse_torch.solve(At, B, tol=1e-8, **kw)
    assert r.converged and r.residual <= 1e-8
    Xref = ts.batch_refined(method, At, B, tol=1e-8,
                            **KW.get(method, {}))[0]
    assert torch.equal(X, Xref)


@pytest.mark.parametrize("probe", ["maxiter", "zero_rhs", "nan_rhs"])
@pytest.mark.parametrize("method", METHODS)
def test_honest_failure_probes(method, probe):
    """maxiter reached gives converged False; a zero rhs gives x = 0 in 0
    iterations; a NaN rhs gives converged False (the true-residual check
    sees it) instead of a hang or a false pass."""
    At = _port(_jax_system(FIRST[method]))
    b = torch.from_numpy(_rhs(At.shape[0]))
    kw = dict(method=method, precision="full", **KW.get(method, {}))
    if probe == "maxiter":
        x, r = tpu_sparse_torch.solve(At, b, tol=1e-14, maxiter=3, **kw)
        assert not r.converged and r.iterations == 3
        assert torch.isfinite(x).all()
    elif probe == "zero_rhs":
        x, r = tpu_sparse_torch.solve(At, torch.zeros_like(b), **kw)
        assert r.converged and r.iterations == 0
        assert not x.any()
    else:
        b[5] = float("nan")
        x, r = tpu_sparse_torch.solve(At, b, maxiter=50, **kw)
        assert not r.converged
