"""tpu_sparse_torch.precond.amg against tpu_sparse.precond.amg on the CPU.

The same matrices, built by the JAX generators and carried across as
numpy, go through both packages' AMG set-up and solve phase.

Tolerances: aggregates equal integer for integer and level sizes equal;
R, P (smoothed), each coarse A, the L1-Jacobi dinv and the coarse pinv
within 1e-12 of max|.| (float64); the port's V-cycle on a JAX hierarchy
carried across within 1e-12 (float64) / 1e-5 (float32) of max|y|;
``amg_solve`` and ``amg_stationary_solve`` with equal iterations and x
within 1e-10 of max|x|; gradients within 1e-8. JAX's native set-up is
built in a directory of this worker's own, so that a build race between
test workers cannot turn it off.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_sparse.precond import amg as jamg
from tpu_sparse.sparse import containers as jcont
from tpu_sparse.sparse import generators as jgen
from tpu_sparse_torch.precond import _native
from tpu_sparse_torch.precond import amg as tamg
from tpu_sparse_torch.sparse.containers import CSR
from tpu_sparse_torch.sparse.convert import dia_from_numpy
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

MATRICES = {
    "poisson2d(32)": lambda: jgen.poisson2d(32),
    "poisson3d_27pt(12)": lambda: jgen.poisson3d_27pt(12, dtype=np.float64),
    "anisotropic(24)": lambda: jgen.poisson2d_anisotropic(24, eps=100.0),
}
VARIANTS = {"plain": {}, "smoothed": {"smoothed": True},
            "aggressive": {"aggressive": 1}}


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


def _port(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape,
                          device="cpu")


def _sp_jax(op):
    return sp.csr_matrix((np.asarray(op.data), np.asarray(op.indices),
                          np.asarray(op.indptr)), shape=op.shape)


def _sp_port(op):
    return sp.csr_matrix((op.data.numpy(), op.indices.numpy(),
                          op.indptr.numpy()), shape=op.shape)


def _close(a, b, rel=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()) if b.size else 0.0, 1.0)
    assert float(np.abs(a - b).max() if a.size else 0.0) <= rel * scale


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


def _carry(hj):
    return tamg.amg_hierarchy_from_numpy(
        [tuple(_spec(o) for o in (lv.A, lv.P, lv.R)) + (
            np.asarray(lv.dinv_l1),) for lv in hj.levels],
        np.asarray(hj.coarse_inv), device="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_setup_matches_jax(matrix, native, variant, jax_native):
    Aj = MATRICES[matrix]()
    kw = VARIANTS[variant]
    hj = jamg.amg_setup(Aj, use_native=native, **kw)
    ht = tamg.amg_setup(_port(Aj), use_native=native, **kw)
    assert [lv.A.shape for lv in ht.levels] == [lv.A.shape
                                                for lv in hj.levels]
    for k, (lj, lt) in enumerate(zip(hj.levels, ht.levels)):
        if variant == "smoothed":
            assert isinstance(lt.P, CSR)
            _close(_sp_port(lt.P).toarray(), _sp_jax(lj.P).toarray())
        else:
            assert isinstance(lt.P, tamg.TentativeP)
            assert np.array_equal(lt.P.agg.numpy(), np.asarray(lj.P.agg))
            assert np.array_equal(lt.P.vals.numpy(), np.asarray(lj.P.vals))
        _close(_sp_port(lt.R).toarray(), _sp_jax(lj.R).toarray())
        _close(lt.dinv_l1.numpy(), lj.dinv_l1)
        if k > 0:
            _close(_sp_port(lt.A).toarray(), _sp_jax(lj.A).toarray())
    _close(ht.coarse_inv.numpy(), hj.coarse_inv)


def test_scipy_aggregation_makes_no_coarse_level_on_27pt(jax_native):
    """ROADMAP R7, kept as JAX has it: with theta 0.08 every coupling of
    the 27-point stencil is weak (1 < 0.08 * 26), and the scipy path merges
    singletons only with strength-graph neighbours, so it builds no coarse
    level; the native path merges with any matrix neighbour."""
    A = _port(jgen.poisson3d_27pt(12, dtype=np.float64))
    sizes = {nat: [lv.A.shape[0] for lv in
                   tamg.amg_setup(A, use_native=nat).levels]
             for nat in (True, False)}
    assert sizes[False] == []
    assert sizes[True] == [1728, 216, 108, 36]


@pytest.mark.parametrize("dtype,sweeps,rel", [
    (np.float64, dict(pre_sweeps=1, post_sweeps=1, omega=0.9), 1e-12),
    (np.float64, dict(pre_sweeps=0, post_sweeps=3, omega=1.0), 1e-12),
    (np.float64, dict(pre_sweeps=2, post_sweeps=2, smoother="chebyshev"),
     1e-12),
    (np.float32, dict(pre_sweeps=1, post_sweeps=1, omega=0.9), 1e-5),
], ids=["f64-v11", "f64-v03", "f64-chebyshev", "f32-v11"])
def test_vcycle_on_carried_jax_hierarchy(dtype, sweeps, rel, jax_native):
    """Apply parity apart from set-up parity: the port's V-cycle on
    exactly JAX's levels."""
    Aj = jgen.poisson3d_27pt(10, dtype=dtype)
    hj = jamg.amg_setup(Aj)
    ht = _carry(hj)
    assert isinstance(ht.levels[0].A, type(_port(Aj)))
    b = np.random.default_rng(3).standard_normal(Aj.shape[0]).astype(dtype)
    yj = np.asarray(jax.jit(lambda h, v: jamg.v_cycle(h, v, **sweeps))(
        hj, jnp.asarray(b)))
    yt = tamg.v_cycle(ht, torch.from_numpy(b), **sweeps)
    assert yt.dtype == torch.from_numpy(b).dtype
    _close(yt.numpy(), yj, rel)


def test_block_vcycle_equals_column_loop():
    """An (n, k) block runs one SpMM per level operator; every column is
    the V-cycle of that column."""
    A = _port(jgen.poisson2d(24))
    M = tamg.amg_preconditioner(A)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (A.shape[0], 4)))
    Y = M.matmat(B)
    for j in range(4):
        _close(Y[:, j].numpy(), M(B[:, j].contiguous()).numpy(), 1e-14)


@pytest.mark.parametrize("cols", [None, 3], ids=["vector", "block3"])
def test_cpu_apply_is_the_eager_cycle(cols):
    """Off the card an apply is ``v_cycle`` itself, bit for bit, on every
    apply (a card would replay a captured graph from the third): no graph
    is kept and the graph counters stay 0, through a solve too."""
    import tpu_sparse_torch

    A = _port(jgen.poisson3d_27pt(10, dtype=np.float64))
    M = tamg.amg_preconditioner(A)
    shape = (A.shape[0],) if cols is None else (A.shape[0], cols)
    rng = np.random.default_rng(3)
    before = dict(tamg.PRECOND)
    for _ in range(3):
        b = torch.from_numpy(rng.standard_normal(shape))
        y = M(b) if cols is None else M.matmat(b)
        assert torch.equal(y, tamg.v_cycle(
            M.hier, b, pre_sweeps=M.pre_sweeps, post_sweeps=M.post_sweeps,
            omega=M.omega, smoother=M.smoother))
    x, res = tpu_sparse_torch.solve(A, torch.from_numpy(rng.standard_normal(
        A.shape[0])), backend="amg")
    assert res.converged
    assert dict(tamg.PRECOND) == before and len(M.hier.graphs) == 0


def test_hierarchy_goes_with_its_last_reference():
    """After applies, dropping the preconditioner frees its hierarchy (and
    on the card the CUDA graphs it keeps) at once: no reference cycle
    leaves it to the garbage collector, which could free a graph inside
    another capture."""
    import gc
    import weakref

    A = _port(jgen.poisson2d(16))
    M = tamg.amg_preconditioner(A)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    M(b)
    M.matmat(torch.ones(A.shape[0], 2, dtype=torch.float64))
    ref = weakref.ref(M.hier)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del M
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("matrix,stationary", [
    ("poisson2d(32)", False), ("poisson2d(32)", True),
    ("anisotropic(24)", True)],
    ids=["poisson2d(32)-amg_solve", "poisson2d(32)-amg_stationary_solve",
         "anisotropic(24)-amg_stationary_solve"])
def test_solves_match_jax(matrix, stationary, jax_native):
    Aj = MATRICES[matrix]()
    x_true = np.random.default_rng(9).standard_normal(Aj.shape[0])
    bj = Aj @ jnp.asarray(x_true)
    fj, ft = ((jamg.amg_stationary_solve, tamg.amg_stationary_solve)
              if stationary else (jamg.amg_solve, tamg.amg_solve))
    xj, ij, itj, _ = fj(Aj, bj, tol=1e-10, maxiter=200)
    xt, it_, itt, _ = ft(_port(Aj), torch.from_numpy(np.array(bj)),
                         tol=1e-10, maxiter=200)
    assert int(ij) == int(it_) == 0
    assert int(itt) == int(itj)
    _close(xt.numpy(), xj, 1e-10)


def test_gradient_through_amg_solve_matches_jax(jax_native):
    """b.grad through solve(A, b, backend='amg') against jax.grad of JAX's
    amg_solve: the adjoint solve reuses the symmetric V(1,1) cycle."""
    import tpu_sparse_torch

    Aj = jgen.poisson2d(16)
    bnp = np.random.default_rng(2).standard_normal(Aj.shape[0])
    w = np.linspace(0.5, 1.5, Aj.shape[0])
    Mj = jamg.amg_preconditioner(Aj)
    gj = jax.grad(lambda b: jnp.sum(jnp.asarray(w) * jamg.amg_solve(
        Aj, b, tol=1e-12, maxiter=200, precond=Mj)[0]))(jnp.asarray(bnp))
    bt = torch.from_numpy(bnp).requires_grad_()
    x, res = tpu_sparse_torch.solve(_port(Aj), bt, backend="amg",
                                    tol=1e-12, maxiter=200)
    assert res.converged and res.backend == "amg"
    (torch.from_numpy(w) * x).sum().backward()
    _close(bt.grad.numpy(), gj, 1e-8)


def test_hierarchy_to_dtype_and_device():
    A = _port(jgen.poisson2d(20))
    M = tamg.amg_preconditioner(A)
    M32 = M.to(torch.float32)
    assert M32.hier.coarse_inv.dtype == torch.float32
    for lv in M32.hier.levels:
        assert lv.A.dtype == lv.R.dtype == lv.dinv_l1.dtype == torch.float32
        assert lv.P.vals.dtype == torch.float32
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(400))
    _close(M32(b.float()).double().numpy(), M(b).numpy(), 1e-5)
    Mc = M.to("cpu")
    _close(Mc(b).numpy(), M(b).numpy(), 0.0)


def test_native_loader_builds_per_process_and_forgets_failures(
        tmp_path, monkeypatch):
    """Two processes build into an empty directory at once: both load the
    same library (each compiles to a name of its own and moves it into
    place). A failed build raises and is not remembered."""
    code = ("import sys; from pathlib import Path; "
            "from tpu_sparse_torch.precond import _native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); "
            "agg, na = n.aggregate([0, 2, 4], [0, 1, 0, 1], "
            "[2.0, -1.0, -1.0, 2.0], 0.08, 4); print(na, agg.tolist())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == ["1 [0, 0]"] * 2
    built = list(tmp_path.glob("host-*/*.so"))
    assert [p.name for p in built] == ["amg_setup.so"]

    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setenv("CXX", sys.executable)  # not a compiler: fails
    with pytest.raises(RuntimeError, match="host C.. build failed"):
        _native.library()
    assert not _native._libs and not list(
        (tmp_path / "fresh").glob("host-*/*.so"))
    monkeypatch.delenv("CXX")
    assert _native.l1_row_norms([0, 2], [-1.0, 2.0]).tolist() == [3.0]


def test_amg_bf16_operand_sets_up_on_the_host():
    """A bf16 matrix crosses to the host set-up as float32 (numpy has no
    bf16) and its levels are packed in bf16, as JAX packs them in the
    operand's dtype; backend='amg' converges, where it raised TypeError."""
    import tpu_sparse_torch

    A = jgen.poisson2d(12, dtype=np.float32)
    At = dia_from_numpy(np.asarray(A.data), A.offsets, A.shape,
                        device="cpu")
    At = At.with_data(At.data.to(torch.bfloat16))
    hier = tamg.amg_setup(At)
    assert hier.coarse_inv.dtype == torch.bfloat16
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(
        144).astype(np.float32))
    for rhs in (b, b.to(torch.bfloat16)):
        x, res = tpu_sparse_torch.solve(At, rhs, method="amg", tol=1e-2)
        assert res.converged and x.dtype == rhs.dtype
