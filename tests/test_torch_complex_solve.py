"""``tpu_sparse_torch.solve`` on complex128 systems against the JAX
package's native complex solves, on the CPU, from the same numpy inputs.

The systems are poisson2d(12) made Hermitian by a unitary similarity,
A_h = D^H L D with D = diag(exp(i theta)) and theta uniform on [0, 2 pi)
from ``default_rng(0)``, and (1 + 0.2i) L (the scaling of JAX's on-chip
validation). Each runs as DIA through every Krylov method that takes it
(CG, BiCGStab, GMRES on A_h; BiCGStab, GMRES on the scaled L) with M in
None, Jacobi, Chebyshev, Neumann, FSAI, AMG and ILU(0); as CWELL and
BELL (carried across from JAX's packs) with M None, and the CWELL with
Jacobi against the port's own DIA solve (JAX builds Jacobi from a DIA
only); and
through ``backend="amg"`` and ``backend="direct"``. ``converged`` and the
iteration counts are JAX's, x within 1e-10 of max|x|: both packages run
the same recurrences on the same matrices, and only summation orders
differ. The AMG hierarchies of both are built from the real part of A
(ROADMAP R14), the same way.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sparse
import tpu_sparse_torch
from tpu_sparse.sparse import bsr_to_bell as jbsr_to_bell
from tpu_sparse.sparse import containers as jcont
from tpu_sparse.sparse import csr_to_bsr as jcsr_to_bsr
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import dense_to_csr as jdense_to_csr
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell
from tpu_sparse_torch.sparse import convert as tconvert
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

PRECONDS = (None, "jacobi", "chebyshev", "neumann", "fsai", "amg", "ilu0")
METHODS = {"hermitian": ("cg", "bicgstab", "gmres"),
           "scaled": ("bicgstab", "gmres")}
TOL = 1e-10


def _system(name):
    """(DIA data, offsets, shape, b) as numpy, complex128."""
    L = jgen.poisson2d(12)
    n = L.shape[0]
    rng = np.random.default_rng(0)
    data = np.asarray(L.data).astype(np.complex128)
    if name == "hermitian":
        D = np.exp(1j * rng.uniform(0, 2 * np.pi, n))
        for d, o in enumerate(L.offsets):
            i = np.arange(max(0, -o), min(n, n - o))
            data[d, i] = D[i].conj() * data[d, i] * D[i + o]
    else:
        data = data * (1 + 0.2j)
        rng.uniform(0, 2 * np.pi, n)  # the same b for both systems
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return data, L.offsets, L.shape, b


def _both(name, fmt):
    """(JAX operand, port operand, b) of a system in a format; the CWELL
    and BELL forms are JAX's packs, carried across."""
    data, offsets, shape, b = _system(name)
    Aj = jcont.DIA(jnp.asarray(data), offsets, shape)
    if fmt == "dia":
        return Aj, tconvert.dia_from_numpy(data, offsets, shape,
                                           device="cpu"), b
    Cj = jdense_to_csr(np.asarray(Aj.todense()))
    if fmt == "cwell":
        Wj = jcsr_to_cwell(Cj)
        return Wj, tconvert.cwell_from_numpy(
            np.asarray(Wj.vals), np.asarray(Wj.idx2), np.asarray(Wj.srow),
            Wj.shape, nnz=Wj.nnz, fill=Wj.fill, group=Wj.group,
            device="cpu"), b
    Bj = jbsr_to_bell(jcsr_to_bsr(Cj, 8))
    return Bj, tconvert.bell_from_numpy(np.asarray(Bj.blocks),
                                        np.asarray(Bj.indices), Bj.shape,
                                        device="cpu"), b


def _solve_both(name, fmt, **kw):
    Aj, At, b = _both(name, fmt)
    with warnings.catch_warnings():
        # both AMG set-ups drop the imaginary part (R14) and say so
        warnings.simplefilter("ignore", np.exceptions.ComplexWarning)
        xj, rj = tpu_sparse.solve(Aj, jnp.asarray(b), tol=TOL, **kw)
        xt, rt = tpu_sparse_torch.SparseSolver().solve(
            At, torch.from_numpy(b), tol=TOL, **kw)
    return np.asarray(xj), rj, xt, rt, b


def _check(xj, rj, xt, rt, iterations=True):
    assert xt.dtype == torch.complex128
    assert rt.converged and rj.converged
    if iterations:
        assert rt.iterations == rj.iterations
    assert float(np.abs(xt.numpy() - xj).max() / np.abs(xj).max()) <= 1e-10


@pytest.mark.parametrize("name,method,M", [
    (name, method, M) for name, methods in METHODS.items()
    for method in methods for M in PRECONDS])
def test_complex_dia_solves_match_jax(name, method, M):
    _check(*_solve_both(name, "dia", method=method, M=M)[:4])


@pytest.mark.parametrize("fmt", ["cwell", "bell"])
@pytest.mark.parametrize("name,method", [("hermitian", "cg"),
                                         ("scaled", "gmres")])
def test_complex_cwell_and_bell_solves_match_jax(fmt, name, method):
    """M None against JAX; on the CWELL with Jacobi (which JAX builds from
    a DIA only, the port from a DIA or a CWELL) against the port's DIA
    solve of the same system: the container changes no iterate."""
    xj, rj, xt, rt, b = _solve_both(name, fmt, method=method)
    _check(xj, rj, xt, rt)
    if fmt == "bell":
        return
    At = _both(name, fmt)[1]
    xd, rd = tpu_sparse_torch.solve(_both(name, "dia")[1],
                                    torch.from_numpy(b), method=method,
                                    M="jacobi", tol=TOL)
    xm, rm = tpu_sparse_torch.solve(At, torch.from_numpy(b), method=method,
                                    M="jacobi", tol=TOL)
    _check(xd.numpy(), rd, xm, rm)


@pytest.mark.parametrize("name,backend", [
    ("hermitian", "amg"), ("hermitian", "direct"), ("scaled", "direct")])
def test_complex_backends_match_jax(name, backend):
    """backend='amg' is AMG-preconditioned CG: the Hermitian system only
    (CG does not solve the scaled one, in either package)."""
    xj, rj, xt, rt, b = _solve_both(name, "dia", backend=backend)
    # the direct backend reports no iterations
    _check(xj, rj, xt, rt, iterations=backend == "amg")
    assert rt.backend == backend
