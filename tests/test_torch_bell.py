"""tpu_sparse_torch's BSR / BELL formats against tpu_sparse on the CPU: the
conversions, the plain block SpMV / SpMM, the CWELL repack that single-RHS
BELL matvecs run on, ``to_gpu_operator``'s BELL decision and solves on a
BELL.

The same seeded numpy inputs go through both packages. Tolerances:
conversions and the repack byte-equal; plain SpMV / SpMM within 1e-13
(float64) / 1e-6 (float32) of max|y| of the JAX XLA reference (products
summed in another order); against the JAX Pallas K8 in interpret mode
within 1e-5 of max|Y| (float32); float64 solves with equal iterations and
x within 1e-10 of max|x|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_sparse
import tpu_sparse_torch
from tpu_sparse.kernels import reference as jref
from tpu_sparse.sparse import bsr_to_bell as jbsr_to_bell
from tpu_sparse.sparse import csr_to_bsr as jcsr_to_bsr
from tpu_sparse.sparse.convert import dense_to_csr as jdense_to_csr
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.kernels import spmm, spmv
from tpu_sparse_torch.sparse import (BELL, BSR, bsr_to_bell, csr_to_bsr,
                                     to_gpu_operator)
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse.bell import block_cwell
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)


def _block_matrix(nb, bs, density, seed, spd=False, dtype=np.float64):
    """nb x nb blocks of size bs, each present with probability density
    (the diagonal always); SPD when asked (A + A^T + 2n I)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nb, nb)) < density
    np.fill_diagonal(mask, True)
    n = nb * bs
    A = np.zeros((n, n))
    for i, j in zip(*np.nonzero(mask)):
        A[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.standard_normal(
            (bs, bs))
    if spd:
        A = A + A.T + 2 * n * np.eye(n)
    return A.astype(dtype)


def _both(Ad, bs=8):
    """The same BSR and BELL in both packages (the port's built by its own
    conversions from the JAX CSR's arrays)."""
    Cj = jdense_to_csr(Ad)
    Ct = tconvert.csr_from_arrays(np.asarray(Cj.data), np.asarray(Cj.indices),
                                  np.asarray(Cj.indptr), Cj.shape,
                                  device="cpu")
    Sj, St = jcsr_to_bsr(Cj, bs), csr_to_bsr(Ct, bs)
    return Sj, St, jbsr_to_bell(Sj), bsr_to_bell(St)


def _same(tensor, array):
    a = np.asarray(array)
    return tensor.numpy().dtype == a.dtype and np.array_equal(tensor.numpy(),
                                                              a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nb,bs,density", [(8, 8, 0.4), (6, 4, 0.3),
                                           (5, 3, 0.6)])
def test_bsr_and_bell_byte_equal_to_jax(nb, bs, density, dtype):
    Ad = _block_matrix(nb, bs, density, nb * bs, dtype=dtype)
    Sj, St, Bj, Bt = _both(Ad, bs)
    for k in ("data", "indices", "indptr"):
        assert _same(getattr(St, k), getattr(Sj, k)), k
    assert _same(St.block_row_ids(), Sj.block_row_ids())
    for k in ("blocks", "indices"):
        assert _same(getattr(Bt, k), getattr(Bj, k)), k
    assert (Bt.shape, Bt.ell_width, Bt.nnz, St.nnz) == (
        Bj.shape, Bj.ell_width, Bj.nnz, Sj.nnz)
    Cj = Sj.tocoo()
    Ct = St.tocoo()
    for k in ("data", "row", "col"):
        assert _same(getattr(Ct, k), getattr(Cj, k)), k
    np.testing.assert_array_equal(Bt.todense().numpy(), Ad)
    np.testing.assert_array_equal(St.todense().numpy(), Ad)
    # BELL -> CSR drops the padding (zero) slots: the CSR of Ad itself
    C = tconvert.to_csr(Bt)
    Cd = jdense_to_csr(Ad)
    for k in ("data", "indices", "indptr"):
        assert _same(getattr(C, k), getattr(Cd, k)), k


def test_bsr_to_bell_ell_width_and_carriers():
    Ad = _block_matrix(8, 8, 0.4, 1)
    Sj, St, Bj, _ = _both(Ad)
    wide_j, wide_t = jbsr_to_bell(Sj, ell_width=9), bsr_to_bell(St,
                                                                ell_width=9)
    assert _same(wide_t.blocks, wide_j.blocks)
    assert _same(wide_t.indices, wide_j.indices)
    with pytest.raises(ValueError, match="ell_width"):
        bsr_to_bell(St, ell_width=1)
    Bc = tconvert.bell_from_numpy(np.asarray(Bj.blocks),
                                  np.asarray(Bj.indices), Bj.shape,
                                  device="cpu")
    Sc = tconvert.bsr_from_arrays(np.asarray(Sj.data), np.asarray(Sj.indices),
                                  np.asarray(Sj.indptr), Sj.shape,
                                  device="cpu")
    assert isinstance(Bc, BELL) and isinstance(Sc, BSR)
    assert _same(Bc.blocks, Bj.blocks) and _same(Sc.data, Sj.data)
    Bc.blocks[0, 0, 0, 0] = 123.0  # a copy: the torch BELL owns its memory
    assert float(np.asarray(Bj.blocks)[0, 0, 0, 0]) != 123.0
    with pytest.raises(ValueError, match="divisible"):
        csr_to_bsr(tconvert.dense_to_csr(torch.ones(6, 6)), 4)


@pytest.mark.parametrize("dtype,bound", [(np.float32, 1e-6),
                                         (np.float64, 1e-13)])
def test_plain_block_spmv_spmm_match_jax_reference(dtype, bound):
    Ad = _block_matrix(8, 8, 0.4, 2, dtype=dtype)
    Sj, St, Bj, Bt = _both(Ad)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(64).astype(dtype)
    B = rng.standard_normal((64, 5)).astype(dtype)
    for got, want in (
            (tref.bsr_spmv(St, torch.from_numpy(x)),
             jref.bsr_spmv(Sj, jnp.asarray(x))),
            (tref.bell_spmv(Bt, torch.from_numpy(x)),
             jref.bell_spmv(Bj, jnp.asarray(x))),
            (tref.bsr_spmm(St, torch.from_numpy(B)),
             jref.bsr_spmm(Sj, jnp.asarray(B))),
            (tref.bell_spmm(Bt, torch.from_numpy(B)),
             jref.bell_spmm(Bj, jnp.asarray(B)))):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        assert np.abs(got.numpy() - want).max() <= bound * np.abs(want).max()
    # the dispatch takes the plain versions for CPU tensors, and A @ x
    assert torch.equal(spmv(Bt, torch.from_numpy(x)),
                       tref.bell_spmv(Bt, torch.from_numpy(x)))
    assert torch.equal(Bt @ torch.from_numpy(B),
                       tref.bell_spmm(Bt, torch.from_numpy(B)))
    assert torch.equal(spmm(St, torch.from_numpy(B)),
                       tref.bsr_spmm(St, torch.from_numpy(B)))


def test_plain_bell_spmm_matches_pallas_k8_interpret(monkeypatch):
    """The JAX K8 in interpret mode on its resident-B path (k = 130, padded
    to 256) and its column-tiled path (k = 300 over tiles of 128), as
    tests/test_bell.py runs them."""
    import tpu_sparse.kernels.pallas_bell as pb

    monkeypatch.setattr(pb, "_INTERPRET", True)
    Ad = _block_matrix(5, 8, 0.5, 4, dtype=np.float32)
    _, _, Bj, Bt = _both(Ad)
    rng = np.random.default_rng(5)
    B1 = rng.standard_normal((40, 130)).astype(np.float32)
    Y1 = np.asarray(pb._bell_spmm_impl(Bj.blocks, Bj.indices,
                                       jnp.asarray(B1), shape=Bj.shape))
    monkeypatch.setattr(pb, "_K_TILE", 128)
    B2 = rng.standard_normal((40, 300)).astype(np.float32)
    Y2 = np.asarray(pb._bell_spmm_impl(Bj.blocks, Bj.indices,
                                       jnp.asarray(B2), shape=Bj.shape))
    for B, Y in ((B1, Y1), (B2, Y2)):
        Yt = tref.bell_spmm(Bt, torch.from_numpy(B)).numpy()
        assert np.abs(Yt - Y).max() <= 1e-5 * np.abs(Y).max()


def test_block_cwell_repack_byte_equal_to_jax():
    """The repack single-RHS BELL / BSR matvecs run on (K4 on the card):
    JAX ``_build_block_cwell`` with group=1, byte for byte, cached per
    matrix content."""
    from tpu_sparse.kernels.pallas_spmv import _build_block_cwell
    from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell

    def jpack(csr, group):
        return jcsr_to_cwell(csr, group=1)

    Ad = _block_matrix(8, 8, 0.4, 6)
    Sj, St, Bj, Bt = _both(Ad)
    for Aj, At in ((Bj, Bt), (Sj, St)):
        Wj, Wt = _build_block_cwell(Aj, jpack), block_cwell(At)
        for k in ("vals", "idx2", "srow"):
            assert _same(getattr(Wt, k), getattr(Wj, k)), k
        assert Wt.group == 1 and Wt.fill == Wj.fill
        assert block_cwell(At) is Wt  # cached
    W1 = block_cwell(Bt)
    Bt.blocks.mul_(2.0)  # an in-place write: the repack is rebuilt
    W2 = block_cwell(Bt)
    assert W2 is not W1 and torch.equal(W2.vals, 2.0 * W1.vals)


def test_to_gpu_operator_picks_bell_like_jax():
    from tpu_sparse.sparse.bell import BELL as JBELL
    from tpu_sparse.sparse.optimize import to_tpu_operator

    rng = np.random.default_rng(5)
    n, m = 512, 8192
    Ad = np.zeros((n, m))
    for br in range(n // 8):
        for bc in rng.choice(m // 8, 3, replace=False):
            Ad[br * 8:br * 8 + 8, bc * 8:bc * 8 + 8] = rng.standard_normal(
                (8, 8))
    Oj = to_tpu_operator(jdense_to_csr(Ad))
    Ot = to_gpu_operator(tconvert.dense_to_csr(torch.from_numpy(Ad)))
    assert isinstance(Oj, JBELL) and isinstance(Ot, BELL)
    assert _same(Ot.blocks, Oj.blocks) and _same(Ot.indices, Oj.indices)
    assert to_gpu_operator(Ot) is Ot
    x = rng.standard_normal(m)
    np.testing.assert_allclose(spmv(Ot, torch.from_numpy(x)).numpy(),
                               Ad @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "gmres"])
def test_solve_on_bell_matches_jax(method):
    """float64 'full' solves on a BELL, single- and multi-RHS."""
    Ad = _block_matrix(8, 8, 0.4, 7, spd=True)
    _, _, Bj, Bt = _both(Ad)
    rng = np.random.default_rng(8)
    kw = dict(method=method, tol=1e-10, precision="full")
    for b in (rng.standard_normal(64), rng.standard_normal((64, 3))):
        xj, rj = tpu_sparse.solve(Bj, jnp.asarray(b), **kw)
        xt, rt = tpu_sparse_torch.solve(Bt, torch.from_numpy(b), **kw)
        assert rt.converged and rj.converged
        assert rt.iterations == rj.iterations
        xj = np.asarray(xj)
        assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
