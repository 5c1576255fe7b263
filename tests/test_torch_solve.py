"""tpu_sparse_torch.solve against tpu_sparse.solve on the CPU, the router's
refusals outside the ported slice, and the package's independence from JAX.

Tolerances: info equal; iterations (GMRES: restart cycles) equal for
float64 'full', within 2 for the mixed path and for float32 (f32 dot
products summed in another order); x rtol 1e-8 (float64) / 1e-4 (float32)
relative to ||x||.
"""

import ast
import functools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_sparse
import tpu_sparse_torch
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.api.solver import SolverResult
from tpu_sparse_torch.sparse.convert import dia_from_numpy
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent

CASES = [
    # (dtype, precision, M, iteration slack, x rtol)
    (np.float32, "auto", None, 2, 1e-4),
    (np.float64, "auto", None, 2, 1e-8),
    (np.float64, "full", None, 0, 1e-8),
    (np.float64, "full", "jacobi", 0, 1e-8),
    (np.float64, "auto", "jacobi", 2, 1e-8),
]


@pytest.mark.parametrize("dtype,precision,M,slack,rtol", CASES)
def test_solve_matches_jax(dtype, precision, M, slack, rtol):
    Aj = jgen.poisson2d(16, dtype=dtype)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                        device="cpu")
    x_true = np.random.default_rng(7).standard_normal(Aj.shape[0]).astype(
        dtype)
    bj = Aj @ jnp.asarray(x_true)
    bt = torch.from_numpy(np.array(bj))
    tol = 1e-5 if dtype == np.float32 else 1e-10
    xj, rj = tpu_sparse.solve(Aj, bj, method="cg", tol=tol,
                              precision=precision, M=M)
    xt, rt = tpu_sparse_torch.solve(At, bt, method="cg", tol=tol,
                                    precision=precision, M=M)
    assert rt.converged == rj.converged is True
    assert abs(rt.iterations - rj.iterations) <= slack, \
        (rt.iterations, rj.iterations)
    assert xt.dtype == bt.dtype
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(xj))))
    assert rt.residual <= tol * (10 if dtype == np.float32 else 1)
    assert rt.backend == "krylov" and rt.method == "cg"


@pytest.mark.parametrize("dtype,M,slack,rtol", [
    (np.float64, None, 0, 1e-8),
    (np.float64, "jacobi", 0, 1e-8),
    (np.float32, None, 2, 1e-4),
    (np.float32, "jacobi", 2, 1e-4),
])
def test_extended_space_runners_match_jax(dtype, M, slack, rtol):
    """ext_run_f64 / ext_run's extended-space loop (plain kernel versions on
    CPU tensors) against the JAX full-precision solve. The float32 case
    passes x0 so that it takes the loop, not the fused CG."""
    from tpu_sparse_torch.solvers.extended import ext_run, ext_run_f64
    from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner

    Aj = jgen.poisson2d(16, dtype=dtype)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                        device="cpu")
    x_true = np.random.default_rng(11).standard_normal(Aj.shape[0]).astype(
        dtype)
    bj = Aj @ jnp.asarray(x_true)
    bt = torch.from_numpy(np.array(bj))
    tol = 1e-5 if dtype == np.float32 else 1e-10
    xj, rj = tpu_sparse.solve(Aj, bj, method="cg", tol=tol,
                              precision="full", M=M)
    Mt = None if M is None else jacobi_preconditioner(At)
    kw = dict(tol=tol, atol=0.0, maxiter=None)
    if dtype == np.float64:
        out = ext_run_f64("cg", kw, At, bt, None, Mt)
    else:
        out = ext_run("cg", kw, At, bt, torch.zeros_like(bt), Mt)
    xt, info, iters, res = out
    assert int(info) == 0 and rj.converged
    assert abs(int(iters) - rj.iterations) <= slack, (int(iters),
                                                      rj.iterations)
    assert xt.shape == bt.shape and xt.dtype == bt.dtype
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(xj))))
    assert float(res) <= tol * float(torch.linalg.vector_norm(bt)) * (
        10 if dtype == np.float32 else 1)


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
@pytest.mark.parametrize("dtype,precision,M,slack,rtol", CASES)
def test_nonsymmetric_solve_matches_jax(method, dtype, precision, M, slack,
                                        rtol):
    Aj = jgen.convection_diffusion_3d_27pt(8, dtype=dtype)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                        device="cpu")
    x_true = np.random.default_rng(7).standard_normal(Aj.shape[0]).astype(
        dtype)
    bj = Aj @ jnp.asarray(x_true)
    bt = torch.from_numpy(np.array(bj))
    tol = 1e-5 if dtype == np.float32 else 1e-10
    kw = dict(method=method, tol=tol, precision=precision, M=M)
    if method == "gmres":
        kw.update(restart=10, solve_method="incremental")
    xj, rj = tpu_sparse.solve(Aj, bj, **kw)
    xt, rt = tpu_sparse_torch.solve(At, bt, **kw)
    assert rt.converged == rj.converged is True
    assert abs(rt.iterations - rj.iterations) <= slack, \
        (rt.iterations, rj.iterations)
    assert xt.dtype == bt.dtype
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(xj))))
    assert rt.residual <= tol * (10 if dtype == np.float32 else 1)
    assert rt.backend == "krylov" and rt.method == method


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
@pytest.mark.parametrize("dtype,M,slack,rtol", [
    (np.float64, None, 0, 1e-8),
    (np.float64, "jacobi", 0, 1e-8),
    (np.float32, None, 2, 1e-4),
    (np.float32, "jacobi", 2, 1e-4),
])
def test_extended_space_nonsymmetric_runners_match_jax(method, dtype, M,
                                                       slack, rtol):
    """ext_run_f64 / ext_run (plain kernel versions on CPU tensors) for
    bicgstab and gmres against the JAX full-precision solve. The float32
    bicgstab case without M takes fused_bicgstab_ext (K10); with M, the
    method's loop over the extended operator."""
    from tpu_sparse_torch.solvers.extended import ext_run, ext_run_f64
    from tpu_sparse_torch.precond.jacobi import jacobi_preconditioner

    Aj = jgen.convection_diffusion_3d_27pt(8, dtype=dtype)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                        device="cpu")
    x_true = np.random.default_rng(11).standard_normal(Aj.shape[0]).astype(
        dtype)
    bj = Aj @ jnp.asarray(x_true)
    bt = torch.from_numpy(np.array(bj))
    tol = 1e-5 if dtype == np.float32 else 1e-10
    jkw = dict(restart=10) if method == "gmres" else {}
    xj, rj = tpu_sparse.solve(Aj, bj, method=method, tol=tol,
                              precision="full", M=M, **jkw)
    Mt = None if M is None else jacobi_preconditioner(At)
    kw = dict(tol=tol, atol=0.0, maxiter=None, **jkw)
    run = ext_run_f64 if dtype == np.float64 else ext_run
    xt, info, iters, res = run(method, kw, At, bt, None, Mt)
    assert int(info) == 0 and rj.converged
    assert abs(int(iters) - rj.iterations) <= slack, (int(iters),
                                                      rj.iterations)
    assert xt.shape == bt.shape and xt.dtype == bt.dtype
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(xj))))
    assert float(res) <= tol * float(torch.linalg.vector_norm(bt)) * (
        10 if dtype == np.float32 else 1)


def test_solver_shortcuts_route_like_solve():
    A = tpu_sparse_torch.sparse.generators.convection_diffusion(50,
                                                                device="cpu")
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(50))
    solver = tpu_sparse_torch.SparseSolver()
    from tpu_sparse_torch.api import bicgstab, gmres

    for method, shortcut, module_fn in (
            ("bicgstab", solver.bicgstab, bicgstab),
            ("gmres", solver.gmres, gmres)):
        x_ref, r_ref = tpu_sparse_torch.solve(A, b, method=method, tol=1e-10,
                                              precision="full")
        for fn in (shortcut, module_fn):
            x, r = fn(A, b, tol=1e-10, precision="full")
            assert r.method == method and r.converged
            assert torch.equal(x, x_ref)


def test_solve_dense_and_callable_operands():
    At = tpu_sparse_torch.sparse.generators.poisson2d(8, device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(64))
    x_ref, r_ref = tpu_sparse_torch.solve(At, b, tol=1e-10, precision="full")
    for op in (At.todense(), lambda v: At @ v):
        x, r = tpu_sparse_torch.solve(op, b, tol=1e-10, precision="full")
        assert r.converged
        torch.testing.assert_close(x, x_ref, rtol=1e-8, atol=1e-10)


def test_solver_result_is_lazy_and_reads_once():
    conv = torch.tensor(True)
    res = SolverResult(x=None, converged=conv, iterations=torch.tensor(7),
                       residual=torch.tensor(1e-9, dtype=torch.float64),
                       backend="krylov", method="cg")
    assert res._fetched is False
    assert res.iterations == 7 and res.converged is True
    assert res._fetched is True
    assert abs(res.residual - 1e-9) < 1e-20
    assert "iterations=7" in repr(res)


def _a_b():
    A = tpu_sparse_torch.sparse.generators.poisson2d(4, device="cpu")
    return A, torch.ones(16, dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _jax_ilu0_solve(items):
    Aj = jgen.poisson2d(4)
    xj, rj = tpu_sparse.solve(Aj, jnp.ones(16), M="ilu0", tol=1e-10,
                              **dict(items))
    return np.asarray(xj), rj.converged, rj.iterations


@pytest.mark.parametrize("kw", [
    dict(M="ilu0", method="bicgstab"),
    dict(M="ilu0", method="gmres"), dict(M="ilu0", method="fcg"),
    dict(M="ilu0", method="minres"),
    dict(M="ilu0", precision="full"), dict(M="ilu0"),
    dict(M="ilu0", method="cg_sr"), dict(M="ilu0", method="fgmres"),
])
def test_out_of_slice_raises_not_implemented(kw):
    """M='ilu0' was outside the port until ILU(0) was ported; every route
    now matches tpu_sparse.solve at tol 1e-10: converged (MINRES: the
    port's own, JAX's loop has fault R10), equal iterations (the f64
    'auto' routes run the mixed path: within 2) and x within 1e-10 of
    max|x|."""
    A, b = _a_b()
    kw = {k: v for k, v in kw.items() if k != "M"}
    xt, rt = tpu_sparse_torch.solve(A, b, M="ilu0", tol=1e-10, **kw)
    xj, conv_j, it_j = _jax_ilu0_solve(tuple(sorted(kw.items())))
    assert rt.converged
    if kw.get("method") != "minres":
        assert conv_j
    slack = 0 if kw.get("precision") == "full" else 2
    assert abs(rt.iterations - it_j) <= slack, (rt.iterations, it_j)
    assert xt.dtype == torch.float64
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert rt.residual <= 1e-10


@pytest.mark.parametrize("k", [None, 3], ids=["vector", "block"])
@pytest.mark.parametrize("precision", ["full", "auto", "mixed"])
@pytest.mark.parametrize("method", ["cg", "cg_sr", "fcg", "minres",
                                    "bicgstab", "gmres", "fgmres"])
def test_mixed_dtypes_solve_in_the_common_dtype(method, precision, k):
    """A float64 matrix with a float32 b (and x0): b and x0 are promoted
    to float64 before any route is chosen, so every method, precision and
    right-hand-side form gives the float64 solve of the promoted b, bit
    for bit (GMRES and FGMRES raised a dtype error before)."""
    A = tpu_sparse_torch.sparse.generators.poisson2d(8, device="cpu")
    shape = (64,) if k is None else (64, k)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32))
    x0 = torch.zeros(shape, dtype=torch.float32)
    kw = dict(method=method, precision=precision, tol=1e-8)
    x, r = tpu_sparse_torch.solve(A, b, x0=x0, **kw)
    x64, r64 = tpu_sparse_torch.solve(A, b.double(), x0=x0.double(),
                                      **kw)
    assert x.dtype == torch.float64 and r.converged
    assert torch.equal(x, x64) and r.iterations == r64.iterations


@pytest.mark.parametrize("kw,msg", [
    (dict(method="nope"), "unknown krylov method"),
    (dict(backend="nope"), "is not available"),
    (dict(M="nope"), "unknown preconditioner"),
    (dict(precision="nope"), "unknown precision"),
    (dict(reorder="nope"), "unknown reorder"),
])
def test_unknown_names_raise_value_error_like_jax(kw, msg):
    A, b = _a_b()
    with pytest.raises(ValueError, match=msg):
        tpu_sparse_torch.solve(A, b, **kw)
    Aj = jgen.poisson2d(4)
    with pytest.raises(ValueError, match=msg):
        tpu_sparse.solve(Aj, jnp.ones(16), **kw)


def test_inputs_requiring_grad_multi_rhs_and_complex_raise():
    """Inputs that require grad: a matrix operand and a matrix-free
    callable differentiate through the full-precision solve (one adjoint
    solve); the mixed path and a multi-RHS solve refuse."""
    A, b = _a_b()
    for method in ("cg", "bicgstab", "gmres"):
        bg = b.clone().requires_grad_()
        data = A.data.clone().requires_grad_()
        x, r = tpu_sparse_torch.solve(A.with_data(data), bg, method=method,
                                      tol=1e-12, precision="full")
        assert r.converged and x.requires_grad
        x.sum().backward()
        # b_bar = A^-T 1; A_bar = -b_bar x^T on the pattern
        dense = A.todense()
        v = torch.linalg.solve(dense.T, torch.ones(16, dtype=torch.float64))
        torch.testing.assert_close(bg.grad, v, rtol=1e-8, atol=1e-12)
        pattern = A.with_data(torch.ones_like(A.data)).todense()
        grad_dense = -torch.outer(v, x.detach()) * pattern
        torch.testing.assert_close(A.with_data(data.grad).todense(),
                                   grad_dense, rtol=1e-8, atol=1e-12)
    for method in ("cg", "gmres"):
        bg = b.clone().requires_grad_()
        x, r = tpu_sparse_torch.solve(lambda v: A @ v, bg, method=method,
                                      tol=1e-12, precision="full")
        x.sum().backward()
        v = torch.linalg.solve(A.todense().T,
                               torch.ones(16, dtype=torch.float64))
        torch.testing.assert_close(bg.grad, v, rtol=1e-8, atol=1e-12)
    for precision in ("mixed", "auto"):
        with pytest.raises(ValueError, match="not differentiable"):
            tpu_sparse_torch.solve(A, b.clone().requires_grad_(),
                                   precision=precision)
    # multi-RHS solves, but is not differentiable (nor in JAX)
    X, r = tpu_sparse_torch.solve(A, torch.ones(16, 2, dtype=torch.float64),
                                  tol=1e-12)
    assert r.converged and X.shape == (16, 2)
    with pytest.raises(ValueError, match="not differentiable"):
        tpu_sparse_torch.solve(A, torch.ones(16, 2, dtype=torch.float64,
                                             requires_grad=True))
    # complex input solves natively (it was refused before native complex)
    xc, rc = tpu_sparse_torch.solve(A, b.to(torch.complex128) * (1 + 1j),
                                    tol=1e-12)
    assert rc.converged and xc.dtype == torch.complex128
    torch.testing.assert_close(A @ xc, b.to(torch.complex128) * (1 + 1j),
                               rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="dimension mismatch"):
        tpu_sparse_torch.solve(A, torch.ones(5, dtype=torch.float64))


def test_availability_reports_krylov_only():
    """krylov, amg (since the AMG slice) and direct (since the direct
    slice), each by a live probe."""
    from tpu_sparse_torch.api import availability

    assert availability.get_available_backends() == ["krylov", "amg",
                                                     "direct"]
    d = availability.availability_dict()
    assert d["krylov"] and d["amg"] and d["direct"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_tpu_sparse():
    files = sorted((REPO / "tpu_sparse_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_sparse"), (f, mod)
    code = ("import sys, pkgutil, importlib, tpu_sparse_torch as t\n"
            "for m in pkgutil.walk_packages(t.__path__, 'tpu_sparse_torch.'):"
            "\n    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_sparse')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
