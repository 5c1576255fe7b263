"""tpu_sparse_torch's general-structure slice against tpu_sparse on the CPU:
the CWELL pack, its plain SpMV, ``to_gpu_operator``, Krylov solves on CWELL
operands, Jacobi, ``reorder="rcm"`` and the adjoint gradient.

The same seeded numpy inputs go through both packages. Tolerances: packs,
conversions and diagonals byte-equal; the plain CWELL SpMV within 1e-13
(float64) / 1e-6 (float32) of max|y| of the JAX XLA reference (sums over
planes in another order); against the JAX Pallas kernels in interpret mode
1e-5 (K4, float32) and 1e-12 (K5: double-f32 pairs against native float64);
float64 'full' solves with equal info and iterations (GMRES: restart
cycles) and x within 1e-8 of ||x||; 'auto' within its tol of the JAX
'full' solution; gradients within 1e-7 relative (float64, tol 1e-12).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_sparse
import tpu_sparse_torch
from tpu_sparse.kernels import reference as jref
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import dense_to_csr as jdense_to_csr
from tpu_sparse.sparse.convert import to_csr as jto_csr
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.kernels import spmv as tspmv
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse.cwell import (CWELL, CWELLSeg, csr_to_cwell,
                                           csr_to_cwell_segments)


def _random_dense(n, m, density, seed, dtype):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.standard_normal((n, m))).astype(dtype)


def _both_csr(Ad):
    """The same CSR in both packages (JAX dense_to_csr, carried across)."""
    Aj = jdense_to_csr(Ad)
    At = tconvert.csr_from_arrays(np.asarray(Aj.data), np.asarray(Aj.indices),
                                  np.asarray(Aj.indptr), Aj.shape,
                                  device="cpu")
    return Aj, At


def _csr_of(Aj_dia):
    """A JAX generator's matrix as CSR in both packages."""
    Cj = jto_csr(Aj_dia)
    Ct = tconvert.csr_from_arrays(np.asarray(Cj.data), np.asarray(Cj.indices),
                                  np.asarray(Cj.indptr), Cj.shape,
                                  device="cpu")
    return Cj, Ct


def _same(tensor, array):
    a = np.asarray(array)
    return tensor.numpy().dtype == a.dtype and np.array_equal(tensor.numpy(),
                                                              a)


PACK_CASES = [
    # (n, m, density): square, rectangular, wide, m < 256 with n, m not
    # multiples of 128, dense-ish, empty
    (50, 50, 0.1), (200, 130, 0.05), (300, 520, 0.02), (257, 190, 0.08),
    (128, 128, 0.3), (5, 5, 0.0),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("n,m,density", PACK_CASES)
def test_pack_byte_equal_to_jax(n, m, density, group, dtype):
    Aj, At = _both_csr(_random_dense(n, m, density, n + m, dtype))
    Wj = jcsr_to_cwell(Aj, group=group)
    Wt = csr_to_cwell(At, group=group)
    for k in ("vals", "idx2", "srow"):
        assert _same(getattr(Wt, k), getattr(Wj, k)), k
    assert (Wt.fill, Wt.nnz, Wt.group) == (Wj.fill, Wj.nnz, Wj.group)
    # tocsr round trip, and its agreement with the JAX conversion
    Cj, Ct = Wj.tocsr(), Wt.tocsr()
    for k in ("data", "indices", "indptr"):
        assert _same(getattr(Ct, k), getattr(Cj, k)), k
    assert np.array_equal(Wt.todense().numpy(), np.asarray(Aj.todense()))


def test_pack_of_stencil_csr_and_transpose_match_jax():
    Cj, Ct = _csr_of(jgen.poisson3d_27pt(8, 7, 5, dtype=np.float64))
    Wj, Wt = jcsr_to_cwell(Cj), csr_to_cwell(Ct)
    assert Wt.planes == Wj.planes and Wt.fill == Wj.fill
    WTj, WTt = Wj.T, Wt.T
    for k in ("vals", "idx2", "srow"):
        assert _same(getattr(Wt, k), getattr(Wj, k)), k
        assert _same(getattr(WTt, k), getattr(WTj, k)), k
    with pytest.raises(ValueError, match="Not to port"):
        csr_to_cwell(Ct, group="auto")
    with pytest.raises(ValueError, match="1, 2, 4, or 8"):
        csr_to_cwell(Ct, group=3)


def test_segments_match_jax():
    from tpu_sparse.kernels import spmv as jspmv
    from tpu_sparse.sparse.cwell import csr_to_cwell_segments as jsegments

    Ad = _random_dense(600, 1500, 0.02, 16, np.float32)
    Aj, At = _both_csr(Ad)
    Sj = jsegments(Aj, seg_cols=512)
    St = csr_to_cwell_segments(At, seg_cols=512)
    assert isinstance(St, CWELLSeg) and len(St.segments) == 3
    assert (St.starts, St.widths, St.rstarts, St.nnz) == (
        Sj.starts, Sj.widths, Sj.rstarts, Sj.nnz)
    for Wt, Wj in zip(St.segments, Sj.segments):
        for k in ("vals", "idx2", "srow"):
            assert _same(getattr(Wt, k), getattr(Wj, k)), k
    x = np.random.default_rng(16).standard_normal(1500).astype(np.float32)
    yj = np.asarray(jspmv(Sj, jnp.asarray(x)))
    yt = tspmv(St, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=1e-6 * np.abs(yj).max())
    np.testing.assert_array_equal(St.todense().numpy(), Ad)
    xt = np.random.default_rng(18).standard_normal(600).astype(np.float32)
    np.testing.assert_allclose(tspmv(St.T, torch.from_numpy(xt)).numpy(),
                               Ad.T @ xt, rtol=1e-5, atol=1e-5)


def test_cwell_from_numpy_carries_jax_pack():
    Aj, _ = _both_csr(_random_dense(300, 520, 0.02, 3, np.float32))
    Wj = jcsr_to_cwell(Aj, group=4)
    Wt = tconvert.cwell_from_numpy(np.asarray(Wj.vals), np.asarray(Wj.idx2),
                                   np.asarray(Wj.srow), Wj.shape, nnz=Wj.nnz,
                                   fill=Wj.fill, group=Wj.group,
                                   device="cpu")
    assert isinstance(Wt, CWELL) and Wt.group == 4 and Wt.shape == Wj.shape
    for k in ("vals", "idx2", "srow"):
        assert _same(getattr(Wt, k), getattr(Wj, k)), k
    Wt.vals[0, 0, 0] = 123.0  # a copy: the torch pack owns its memory
    assert float(np.asarray(Wj.vals)[0, 0, 0]) != 123.0


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-6),
                                         (np.float64, 1e-13)])
@pytest.mark.parametrize("group", [1, 4])
def test_plain_spmv_matches_jax_reference(dtype, bound, group):
    Aj, At = _both_csr(_random_dense(257, 190, 0.08, 3, dtype))
    Wj, Wt = jcsr_to_cwell(Aj, group=group), csr_to_cwell(At, group=group)
    x = np.random.default_rng(4).standard_normal(190).astype(dtype)
    yj = np.asarray(jref.cwell_spmv(Wj, jnp.asarray(x)))
    yt = tref.cwell_spmv(Wt, torch.from_numpy(x)).numpy()
    assert yt.dtype == yj.dtype and yt.shape == (257,)
    assert np.abs(yt - yj).max() <= bound * np.abs(yj).max()
    # the dispatch takes the plain version for CPU tensors
    assert np.array_equal(tspmv(Wt, torch.from_numpy(x)).numpy(), yt)


def test_plain_spmv_matches_pallas_k4_k5_interpret():
    """The JAX Pallas kernels in interpret mode (two tiny cases: slow)."""
    from tpu_sparse.kernels import pallas_cwell

    rng = np.random.default_rng(9)
    Aj, At = _both_csr(_random_dense(300, 300, 0.05, 8, np.float32))
    x32 = rng.standard_normal(300).astype(np.float32)
    Cj, Ct = _csr_of(jgen.poisson3d_27pt(8, dtype=np.float64))
    x64 = rng.standard_normal(512)
    pallas_cwell._INTERPRET = True
    try:
        y4 = np.asarray(pallas_cwell.cwell_spmv_pallas(jcsr_to_cwell(Aj),
                                                       jnp.asarray(x32)))
        y5 = np.asarray(pallas_cwell.cwell_spmv_pallas_df(
            jcsr_to_cwell(Cj), jnp.asarray(x64)))
    finally:
        pallas_cwell._INTERPRET = False
    t4 = tref.cwell_spmv(csr_to_cwell(At), torch.from_numpy(x32)).numpy()
    t5 = tref.cwell_spmv(csr_to_cwell(Ct), torch.from_numpy(x64)).numpy()
    assert np.abs(t4 - y4).max() <= 1e-5 * np.abs(y4).max()
    assert y5.dtype == np.float64
    assert np.abs(t5 - y5).max() <= 1e-12 * np.abs(y5).max()


def _bell_matrix():
    """Dense 8 x 8 blocks scattered over wide block columns: too many
    diagonals for DIA, too little fill for CWELL, blocks full for BELL."""
    rng = np.random.default_rng(5)
    n, m = 512, 8192
    Ad = np.zeros((n, m))
    for br in range(n // 8):
        for bc in rng.choice(m // 8, 3, replace=False):
            Ad[br * 8:br * 8 + 8, bc * 8:bc * 8 + 8] = rng.standard_normal(
                (8, 8))
    return Ad


def test_to_gpu_operator_picks_jax_format():
    from tpu_sparse.sparse import BELL
    from tpu_sparse.sparse.containers import CSR as JCSR
    from tpu_sparse.sparse.containers import DIA as JDIA
    from tpu_sparse.sparse.cwell import CWELL as JCWELL
    from tpu_sparse.sparse.optimize import to_tpu_operator
    from tpu_sparse_torch.sparse import CSR, DIA, to_gpu_operator

    rng = np.random.default_rng(0)
    stencil = np.asarray(jgen.poisson2d(8).todense())
    unstructured = ((rng.random((64, 64)) < 0.05)
                    * rng.standard_normal((64, 64)))
    rng7 = np.random.default_rng(7)
    local = np.asarray(rng7.standard_normal((96, 96)))
    local[np.abs(local) < 1.2] = 0.0
    for Ad, jcls, tcls in ((stencil, JDIA, DIA), (unstructured, JCSR, CSR),
                           (local, JCWELL, CWELL)):
        Aj, At = _both_csr(Ad)
        Oj, Ot = to_tpu_operator(Aj), to_gpu_operator(At)
        assert isinstance(Oj, jcls) and isinstance(Ot, tcls), (Oj, Ot)
        x = rng.standard_normal(Ad.shape[1])
        np.testing.assert_allclose(tspmv(Ot, torch.from_numpy(x)).numpy(),
                                   Ad @ x, rtol=1e-12, atol=1e-12)
    # csr_to_dia gives the generator's diagonals back, byte for byte
    Od = to_gpu_operator(_csr_of(jgen.poisson2d(8))[1])
    assert Od.offsets == jgen.poisson2d(8).offsets
    assert _same(Od.data, jgen.poisson2d(8).data)
    # max_diags is the JAX function's own: the stencil then packs as CWELL
    Aj, At = _both_csr(stencil)
    assert isinstance(to_tpu_operator(Aj, max_diags=2), JCWELL)
    assert isinstance(to_gpu_operator(At, max_diags=2), CWELL)
    # block-structured: both promote to BELL, with the same blocks
    from tpu_sparse_torch.sparse import BELL as TBELL

    Ab = _bell_matrix()
    Bj = to_tpu_operator(jdense_to_csr(Ab))
    Bt = to_gpu_operator(tconvert.dense_to_csr(torch.from_numpy(Ab)))
    assert isinstance(Bj, BELL) and isinstance(Bt, TBELL)
    assert _same(Bt.blocks, Bj.blocks) and _same(Bt.indices, Bj.indices)


def test_to_gpu_operator_wide_matrix_single_cwell():
    """Where JAX splits a wide matrix into CWELLSeg (its kernel kept x in
    VMEM), the port keeps one CWELL with the same SpMV."""
    import scipy.sparse as sp

    from tpu_sparse.kernels import spmv as jspmv
    from tpu_sparse.sparse.convert import csr_from_arrays
    from tpu_sparse.sparse.cwell import CWELLSeg as JCWELLSeg
    from tpu_sparse.sparse.optimize import to_tpu_operator
    from tpu_sparse_torch.sparse import to_gpu_operator

    n, m = 512, 1_600_000
    rng = np.random.default_rng(20)
    rows = np.repeat(np.arange(n), 16)
    cols = ((rows // 128) * 400_000 + rng.integers(0, 1024, rows.size)) % m
    S = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(n, m)).tocsr()
    Oj = to_tpu_operator(csr_from_arrays(S.data, S.indices, S.indptr, (n, m)))
    Ot = to_gpu_operator(tconvert.csr_from_arrays(
        S.data, S.indices, S.indptr, (n, m), device="cpu"))
    assert isinstance(Oj, JCWELLSeg) and isinstance(Ot, CWELL)
    x = rng.standard_normal(m).astype(np.float32)
    yj = np.asarray(jspmv(Oj, jnp.asarray(x)))
    yt = tspmv(Ot, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt, S @ x, rtol=1e-5, atol=1e-5)


def _system(method, dtype=np.float64):
    make = (jgen.poisson2d if method == "cg"
            else jgen.convection_diffusion_3d_27pt)
    Cj, Ct = _csr_of(make(16 if method == "cg" else 8, dtype=dtype))
    x_true = np.random.default_rng(7).standard_normal(Cj.shape[0]).astype(
        dtype)
    bj = jref.csr_spmv(Cj, jnp.asarray(x_true))
    return Cj, Ct, bj, torch.from_numpy(np.array(bj))


def _kw(method, tol):
    kw = dict(method=method, tol=tol)
    if method == "gmres":
        kw.update(restart=10, solve_method="incremental")
    return kw


@pytest.mark.parametrize("M", [None, "jacobi"])
@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_krylov_on_cwell_matches_jax_full(method, M):
    """float64 'full' on CWELL. JAX's Jacobi fails on CWELL (ROADMAP queue
    3, R6), so with M='jacobi' the JAX side solves the same matrix as
    CSR."""
    Cj, Ct, bj, bt = _system(method)
    Wj, Wt = jcsr_to_cwell(Cj), csr_to_cwell(Ct)
    kw = _kw(method, 1e-10)
    xj, rj = tpu_sparse.solve(Wj if M is None else Cj, bj, precision="full",
                              M=M, **kw)
    xt, rt = tpu_sparse_torch.solve(Wt, bt, precision="full", M=M, **kw)
    assert rt.converged and rj.converged
    assert rt.iterations == rj.iterations, (rt.iterations, rj.iterations)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8,
                               atol=1e-8 * float(np.max(np.abs(xj))))
    assert rt.residual <= 1e-10


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_auto_precision_on_cwell_matches_jax_full(method):
    """precision='auto' on a float64 CWELL runs defect correction (f32
    inner sweeps on the cast pack); the JAX 'auto' path fails there
    (ROADMAP queue 3, R5), so it is held to the JAX 'full' solution."""
    Cj, Ct, bj, bt = _system(method)
    tol = 1e-8
    xj, rj = tpu_sparse.solve(jcsr_to_cwell(Cj), bj, precision="full",
                              **_kw(method, tol))
    Wt = csr_to_cwell(Ct)
    xt, rt = tpu_sparse_torch.solve(Wt, bt, precision="auto",
                                    **_kw(method, tol))
    assert rt.converged and rj.converged and rt.residual <= tol
    xn = float(np.linalg.norm(np.asarray(xj)))
    assert float(np.linalg.norm(xt.numpy() - np.asarray(xj))) <= 1e2 * tol * xn


def test_jacobi_diagonal_of_cwell_matches_jax_csr():
    from tpu_sparse.precond.jacobi import diagonal as jdiagonal
    from tpu_sparse_torch.precond.jacobi import diagonal

    Ad = _random_dense(300, 260, 0.05, 2, np.float64)
    np.fill_diagonal(Ad, np.arange(1, 261))
    Aj, At = _both_csr(Ad)
    dj = np.asarray(jdiagonal(Aj))
    for W in (csr_to_cwell(At), csr_to_cwell(At, group=8),
              csr_to_cwell_segments(At, seg_cols=256)):
        assert _same(diagonal(W), dj)


def test_reorder_rcm_matches_jax():
    """The case of tests/test_api.py::test_solve_reorder_rcm_scrambled_poisson
    (float64, 'auto' and Jacobi), against the JAX solve."""
    rng = np.random.default_rng(55)
    Ad = np.asarray(jgen.poisson2d(20).todense())
    n = Ad.shape[0]
    perm = rng.permutation(n)
    As = Ad[np.ix_(perm, perm)]
    x_true = rng.standard_normal(n)
    b = As @ x_true
    Aj, At = _both_csr(As)
    sj, st = tpu_sparse.SparseSolver(), tpu_sparse_torch.SparseSolver()
    for M in (None, "jacobi"):
        xj, rj = sj.solve(Aj, jnp.asarray(b), method="cg", tol=1e-10, M=M,
                          reorder="rcm")
        xt, rt = st.solve(At, torch.from_numpy(b), method="cg", tol=1e-10,
                          M=M, reorder="rcm")
        assert rt.converged and rj.converged
        assert rt.iterations == rj.iterations
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(xt.numpy(), x_true, rtol=1e-6, atol=1e-6)
    Ap, perm_t, inv_t = st._reorder_cached(At)
    assert st._reorder_cached(At)[0] is Ap  # cached per matrix content
    assert torch.equal(perm_t[inv_t], torch.arange(n))
    from tpu_sparse.sparse.cwell import rcm_permutation as jrcm
    from tpu_sparse_torch.sparse import rcm_permutation

    assert np.array_equal(rcm_permutation(At), jrcm(Aj))
    assert np.array_equal(perm_t.numpy(), jrcm(Aj))
    with pytest.raises(ValueError, match="matrix operand"):
        st.solve(lambda v: v, torch.from_numpy(b), reorder="rcm")
    with pytest.raises(ValueError, match="user callable M"):
        st.solve(At, torch.from_numpy(b), reorder="rcm", M=lambda v: v)


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_gradients_on_cwell_match_jax(method):
    from tpu_sparse.autodiff import bicgstab_diff as jbicgstab_diff
    from tpu_sparse.autodiff import cg_diff as jcg_diff

    Cj, Ct, bj, bt = _system(method)
    Wj, Wt = jcsr_to_cwell(Cj), csr_to_cwell(Ct)
    jdiff = {"cg": jcg_diff, "bicgstab": jbicgstab_diff}[method]

    def loss(vals, b):
        return jnp.sum(jdiff(Wj.with_data(vals), b, tol=1e-12)[0])

    gv_j, gb_j = jax.grad(loss, argnums=(0, 1))(Wj.vals, bj)
    vals = Wt.vals.clone().requires_grad_()
    b = bt.clone().requires_grad_()
    x, r = tpu_sparse_torch.solve(Wt.with_data(vals), b, method=method,
                                  tol=1e-12, precision="full")
    assert r.converged
    x.sum().backward()
    for got, want in ((vals.grad, gv_j), (b.grad, gb_j)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-7 * np.abs(want).max()


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_gradients_on_cwell_segments_match_single_pack(method):
    """A CWELLSeg differentiates like the single CWELL of the same matrix
    (JAX tests/test_cwell.py::test_cwellseg_solver_and_grad covers cg)."""
    _, Ct, _, bt = _system(method)
    grads = []
    for W in (csr_to_cwell(Ct), csr_to_cwell_segments(Ct, seg_cols=256)):
        vals = tpu_sparse_torch.sparse.values(W).clone().requires_grad_()
        b = bt.clone().requires_grad_()
        x, r = tpu_sparse_torch.solve(W.with_data(vals), b, method=method,
                                      tol=1e-12, precision="full")
        assert r.converged
        x.sum().backward()
        # the values' gradient on the pattern, as a dense matrix (padding
        # slots get a gradient too, as in JAX, and the two packs pad apart)
        g = W.with_data(vals.grad * (vals != 0)).tocsr().todense()
        grads.append((g, b.grad))
    (g1, b1), (g2, b2) = grads
    assert float((b2 - b1).abs().max()) <= 1e-8 * float(b1.abs().max())
    assert float((g2 - g1).abs().max()) <= 1e-8 * float(g1.abs().max())


def test_packed_transpose_is_cached_and_equals_repack():
    from tpu_sparse_torch.autodiff import implicit

    _, Ct = _csr_of(jgen.convection_diffusion_3d_27pt(6))
    W = csr_to_cwell(Ct)
    calls = []
    real = implicit._transpose_plan
    implicit._transpose_plan = lambda A: calls.append(1) or real(A)
    try:
        T1 = implicit._adjoint_matrix(W, symmetric=False)
        T2 = implicit._adjoint_matrix(W.with_data(W.vals * 2.0), False)
    finally:
        implicit._transpose_plan = real
    assert len(calls) == 1  # one repack; the second call only gathers
    ref_T = W.T
    for k in ("vals", "idx2", "srow"):
        assert torch.equal(getattr(T1, k), getattr(ref_T, k)), k
    assert torch.equal(T2.vals, ref_T.vals * 2.0)


def test_opcache_key_tracks_in_place_writes():
    from tpu_sparse_torch.utils.opcache import OperandCache, content_key

    W = csr_to_cwell(_both_csr(_random_dense(40, 40, 0.2, 1,
                                             np.float64))[1])
    k0 = content_key(W)
    W.vals.mul_(2.0)
    assert content_key(W) != k0
    cache, built = OperandCache(), []
    for _ in range(2):
        cache.get_or_build(W, lambda: built.append(1) or len(built))
    assert built == [1]
    W.vals[0, 0, 0] += 1.0
    cache.get_or_build(W, lambda: built.append(1) or len(built))
    assert built == [1, 1]


def test_dense_to_csr_keeps_device_and_matches_jax():
    Ad = _random_dense(30, 20, 0.2, 4, np.float32)
    Cj = jdense_to_csr(Ad)
    for src in (Ad, torch.from_numpy(Ad)):
        Ct = tconvert.dense_to_csr(src)
        for k in ("data", "indices", "indptr"):
            t = getattr(Ct, k)
            assert t.device.type == "cpu"
            assert _same(t, getattr(Cj, k)), k
