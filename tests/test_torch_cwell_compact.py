"""The row-compact SpMV plan of a CWELL pack (``sparse/cwell_compact.py``),
which the card's K4 / K5 stream, against the plane pack on the CPU.

The plan and its plain SpMV (``reference.cwell_compact_spmv``) are held to
the port's plane reference (``reference.cwell_spmv``) and to the JAX
package's ``reference.cwell_spmv`` on the JAX pack of the same CSR, float32
and float64. Tolerances: 1e-6 (float32) / 1e-13 (float64) of max|y| (the
plans sum a row's slots in plane order, the references by ``sum`` over
planes). Slot counts, plan reuse and rebuilds are exact.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from tpu_sparse.kernels import reference as jref
from tpu_sparse.sparse import bsr_to_bell as jbsr_to_bell
from tpu_sparse.sparse import csr_to_bsr as jcsr_to_bsr
from tpu_sparse.sparse import generators as jgen
from tpu_sparse.sparse.convert import dense_to_csr as jdense_to_csr
from tpu_sparse.sparse.convert import csr_from_arrays as jcsr_from_arrays
from tpu_sparse.sparse.convert import to_csr as jto_csr
from tpu_sparse.sparse.cwell import csr_to_cwell as jcsr_to_cwell
from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import _cwellseg_apply
from tpu_sparse_torch.kernels import reference as tref
from tpu_sparse_torch.sparse import bsr_to_bell, csr_to_bsr
from tpu_sparse_torch.sparse import convert as tconvert
from tpu_sparse_torch.sparse import cwell_compact as cc
from tpu_sparse_torch.sparse.bell import block_cwell
from tpu_sparse_torch.sparse.cwell import csr_to_cwell, csr_to_cwell_segments
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

BOUND = {np.float32: 1e-6, np.float64: 1e-13}


def _scipy_csr(n, m, per_row, dtype, seed, zeros=0):
    """Up to per_row random entries a row (duplicates summed); ``zeros``
    of them stored as explicit zeros."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    S = sp.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                       (rows, rng.integers(0, m, rows.size))), shape=(n, m))
    S.sort_indices()
    if zeros:
        S.data[rng.choice(S.nnz, zeros, replace=False)] = 0.0
    return S


def _both_csr(S):
    """A scipy CSR in both packages."""
    Aj = jcsr_from_arrays(S.data, S.indices.astype(np.int32),
                          S.indptr.astype(np.int32), S.shape)
    At = tconvert.csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                                  device="cpu")
    return Aj, At


def _compact_spmv(W, x):
    return tref.cwell_compact_spmv(*cc.compact(W), x)


def _check(W, x, y_jax, dtype):
    """The compact SpMV of W against the plane reference and JAX's y."""
    y = _compact_spmv(W, x)
    y_plane = tref.cwell_spmv(W, x)
    scale = max(float(np.abs(y_jax).max()) if y_jax.size else 0.0, 1e-300)
    assert y.dtype == y_plane.dtype and y.shape == (W.shape[0],)
    assert float((y - y_plane).abs().max()) <= BOUND[dtype] * scale \
        if y.numel() else True
    assert np.abs(y.numpy() - y_jax).max() <= BOUND[dtype] * scale \
        if y.numel() else True
    return y


CASES = [
    # (n, m, per_row, group, explicit zeros): random with every group,
    # rectangular both ways, m < 256, n and m not multiples of 128, empty,
    # explicit zeros in the CSR
    (6000, 5000, 8, 1, 0), (6000, 5000, 8, 2, 0), (6000, 5000, 8, 4, 0),
    (6000, 5000, 8, 8, 0), (1000, 3001, 6, 1, 0), (3001, 1000, 6, 1, 0),
    (300, 200, 5, 1, 0), (1001, 777, 7, 1, 0), (300, 300, 0, 1, 0),
    (700, 650, 6, 2, 900),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,per_row,group,zeros", CASES)
def test_compact_spmv_matches_plane_and_jax(n, m, per_row, group, zeros,
                                            dtype):
    S = _scipy_csr(n, m, per_row, dtype, n + m, zeros)
    Aj, At = _both_csr(S)
    Wj, W = jcsr_to_cwell(Aj, group=group), csr_to_cwell(At, group=group)
    x = np.random.default_rng(1).standard_normal(m).astype(dtype)
    _check(W, torch.from_numpy(x), np.asarray(
        jref.cwell_spmv(Wj, jnp.asarray(x))), dtype)
    plan, cvals = cc.compact(W)
    # one slot per kept entry of a row, rows padded to their block's most
    nz = W.vals != 0
    lens = nz.sum(1).amax(1)
    assert plan.slots == int(lens.sum()) * 128
    assert int(torch.count_nonzero(cvals)) == int(torch.count_nonzero(
        torch.from_numpy(S.data)))
    assert not plan.wide and plan.idx.dtype == torch.int16
    assert int(plan.boff[-1]) == plan.slots == cvals.numel()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wide_plan_for_packs_of_more_than_256_planes(dtype):
    """Dense rows over three windows give S > 256: int32 columns."""
    S = _scipy_csr(300, 600, 4, dtype, 7).tolil()
    S[5, :] = np.arange(1, 601, dtype=dtype)
    S[130, 100:400] = -1.0
    S = S.tocsr()
    S.sort_indices()
    Aj, At = _both_csr(S)
    W, Wj = csr_to_cwell(At), jcsr_to_cwell(Aj)
    assert W.planes > 256
    x = np.random.default_rng(2).standard_normal(600).astype(dtype)
    _check(W, torch.from_numpy(x),
           np.asarray(jref.cwell_spmv(Wj, jnp.asarray(x))), dtype)
    plan, _ = cc.compact(W)
    assert plan.wide and plan.idx.dtype == torch.int32
    assert int(torch.diff(plan.boff).max()) // 128 == 600


def test_jax_layout_grouped_pack_and_segments():
    """A JAX pack carried across (group 4), and a CWELLSeg summed over its
    segments' plans, against JAX."""
    from tpu_sparse.kernels import spmv as jspmv
    from tpu_sparse.sparse.cwell import csr_to_cwell_segments as jsegments

    S = _scipy_csr(600, 1500, 5, np.float32, 16)
    Aj, At = _both_csr(S)
    x = np.random.default_rng(3).standard_normal(1500).astype(np.float32)
    Wj = jcsr_to_cwell(Aj, group=4)
    W = tconvert.cwell_from_numpy(np.asarray(Wj.vals), np.asarray(Wj.idx2),
                                  np.asarray(Wj.srow), Wj.shape, nnz=Wj.nnz,
                                  fill=Wj.fill, group=4, device="cpu")
    _check(W, torch.from_numpy(x),
           np.asarray(jref.cwell_spmv(Wj, jnp.asarray(x))), np.float32)
    Sj, St = jsegments(Aj, seg_cols=512), csr_to_cwell_segments(At,
                                                                seg_cols=512)
    assert len(St.segments) == 3
    y = _cwellseg_apply(St, torch.from_numpy(x), _compact_spmv)
    yj = np.asarray(jspmv(Sj, jnp.asarray(x)))
    assert np.abs(y.numpy() - yj).max() <= 1e-6 * np.abs(yj).max()


def test_block_cwell_repack_of_a_bell():
    rng = np.random.default_rng(5)
    nb, bs = 12, 8
    Ad = np.zeros((nb * bs, nb * bs))
    mask = rng.random((nb, nb)) < 0.3
    np.fill_diagonal(mask, True)
    for i, j in zip(*np.nonzero(mask)):
        Ad[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.standard_normal(
            (bs, bs))
    C = tconvert.dense_to_csr(torch.from_numpy(Ad))
    bell = bsr_to_bell(csr_to_bsr(C, bs), ell_width=int(mask.sum(1).max())
                       + 2)  # padding blocks too
    W = block_cwell(bell)
    x = rng.standard_normal(nb * bs)
    Bj = jbsr_to_bell(jcsr_to_bsr(jdense_to_csr(Ad), bs))
    _check(W, torch.from_numpy(x),
           np.asarray(jref.bell_spmv(Bj, jnp.asarray(x))), np.float64)
    assert torch.equal(_compact_spmv(W, torch.from_numpy(x)),
                       _compact_spmv(block_cwell(bell), torch.from_numpy(x)))


def test_poisson3d_27pt_32_slot_count():
    Cj = jto_csr(jgen.poisson3d_27pt(32, dtype=np.float64))
    Ct = tconvert.csr_from_arrays(np.asarray(Cj.data), np.asarray(Cj.indices),
                                  np.asarray(Cj.indptr), Cj.shape,
                                  device="cpu")
    W = csr_to_cwell(Ct)
    plan, cvals = cc.compact(W)
    assert plan.slots == 866_304 and W.planes == 40
    # the CSR's 866,110 entries hold in-band explicit zeros; the plan
    # keeps the nonzeros
    assert Ct.nnz == 866_110
    assert int(torch.count_nonzero(cvals)) == int(torch.count_nonzero(
        Ct.data)) < Ct.nnz
    x = np.random.default_rng(6).standard_normal(Ct.shape[1])
    _check(W, torch.from_numpy(x), np.asarray(
        jref.cwell_spmv(jcsr_to_cwell(Cj), jnp.asarray(x))), np.float64)


def test_with_data_reuses_the_plan_and_writes_regather():
    S = _scipy_csr(1000, 900, 6, np.float64, 8)
    W = csr_to_cwell(_both_csr(S)[1])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(900))
    tracing.reset()
    plan, cvals = cc.compact(W)
    assert cc.compact(W)[1] is cvals  # cached: no gather per SpMV
    W2 = W.with_data(W.vals * 2.0)
    plan2, cvals2 = cc.compact(W2)
    W32 = W.with_data(W.vals.float())  # a cast shares the structure
    plan3, _ = cc.compact(W32)
    assert plan2 is plan and plan3 is plan
    assert torch.equal(cvals2, 2.0 * cvals)
    assert cc.COUNTS == {"plan_builds": 1, "value_gathers": 3}
    # an in-place write to vals: new compact values, the same plan
    W.vals.mul_(3.0)
    plan4, cvals4 = cc.compact(W)
    assert plan4 is plan and torch.equal(cvals4, 3.0 * cvals)
    assert cc.COUNTS == {"plan_builds": 1, "value_gathers": 4}
    assert torch.allclose(_compact_spmv(W, x), tref.cwell_spmv(W, x),
                          rtol=0, atol=1e-13 * float(
                              tref.cwell_spmv(W, x).abs().max()))


def test_nonzero_in_a_dropped_slot_rebuilds_the_plan():
    S = _scipy_csr(500, 400, 5, np.float64, 9)
    W = csr_to_cwell(_both_csr(S)[1])
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(400))
    plan, _ = cc.compact(W)
    tracing.reset()
    vals = W.vals.clone()
    b, s, lane = (vals == 0).nonzero()[0].tolist()  # a padding slot
    vals[b, s, lane] = 5.0
    W2 = W.with_data(vals)
    plan2, cvals2 = cc.compact(W2)
    assert plan2 is not plan and plan2.slots >= plan.slots
    assert cc.COUNTS == {"plan_builds": 1, "value_gathers": 2}
    assert int(torch.count_nonzero(cvals2)) == int(torch.count_nonzero(vals))
    y, y0 = _compact_spmv(W2, x), tref.cwell_spmv(W2, x)
    assert float((y - y0).abs().max()) <= 1e-13 * float(y0.abs().max())
    assert cc.compact(W2.with_data(vals * 2.0))[0] is plan2  # kept since


def test_column_outside_the_matrix_raises():
    S = _scipy_csr(300, 200, 5, np.float32, 10)
    W = csr_to_cwell(_both_csr(S)[1])
    idx2 = W.idx2.clone()
    b, s, lane = (W.vals != 0).nonzero()[0].tolist()
    idx2[b, s, lane] = 200 - 128 * int(W.srow[b, s]) + 3  # column 203
    bad = type(W)(W.vals, idx2, W.srow, W.shape)
    with pytest.raises(ValueError, match="outside"):
        cc.compact(bad)


def test_nan_in_x_reaches_only_rows_that_gather_it():
    """A padding slot of the pack adds 0 * x[col]; the plan has none."""
    S = _scipy_csr(400, 300, 4, np.float64, 11)
    S[:, 0] = 0.0
    S.eliminate_zeros()  # column 0 is empty
    W = csr_to_cwell(_both_csr(S)[1])
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(300))
    x[0] = float("nan")
    # the plane reference skips padding slots too (JAX's fill rule would
    # add 0 * NaN there)
    assert bool(torch.isfinite(tref.cwell_spmv(W, x)).all())
    y = _compact_spmv(W, x)
    assert bool(torch.isfinite(y).all())
    x[0] = 0.0
    assert torch.equal(y, _compact_spmv(W, x))


def test_segments_past_any_cache_size_keep_their_plans():
    """A CWELLSeg of 20 segments: one plan and one value gather per
    segment over two SpMVs, and the plans go with the pack."""
    import gc

    S = _scipy_csr(600, 20 * 256, 8, np.float32, 12)
    Seg = csr_to_cwell_segments(_both_csr(S)[1], seg_cols=256)
    assert len(Seg.segments) == 20
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        20 * 256).astype(np.float32))
    tracing.reset()
    y1 = _cwellseg_apply(Seg, x, _compact_spmv)
    y2 = _cwellseg_apply(Seg, x, _compact_spmv)
    assert cc.COUNTS == {"plan_builds": 20, "value_gathers": 20}
    assert torch.equal(y1, y2)
    y0 = torch.from_numpy(S @ x.numpy())
    assert float((y1 - y0).abs().max()) <= 1e-5 * float(y0.abs().max())
    held = len(cc._PLANS), len(cc._VALUES)
    del Seg
    gc.collect()
    assert held[0] - len(cc._PLANS) == 20
    assert held[1] - len(cc._VALUES) == 20


@pytest.mark.parametrize("case", ["narrow, n not x128", "wide"])
def test_plan_built_in_steps_equals_one_step(case, monkeypatch):
    """The build in steps of one and three row blocks gives the plan of
    one step, byte for byte."""
    if case == "wide":
        S = _scipy_csr(300, 600, 4, np.float64, 13).tolil()
        S[5, :] = np.arange(1, 601, dtype=np.float64)
        S = S.tocsr()
        S.sort_indices()
    else:
        S = _scipy_csr(1001, 777, 7, np.float64, 14, zeros=300)
    W = csr_to_cwell(_both_csr(S)[1])
    whole = cc.build_plan(W)
    assert whole.wide == (case == "wide")
    for blocks in (1, 3):
        monkeypatch.setattr(cc, "BUILD_SLOTS", blocks * W.planes * 128)
        part = cc.build_plan(W)
        assert part.wide == whole.wide
        for k in ("boff", "idx", "src"):
            assert torch.equal(getattr(part, k), getattr(whole, k)), k


# ---- the compact SpMM (K6 / K7's plain version) ----------------------------


def _spmm_pack(case, dtype):
    """(pack, m) of one edge case: narrow, a group-2 pack, n and m not
    multiples of 128, and a wide plan (a row over 600 columns)."""
    if case == "wide":
        S = _scipy_csr(300, 600, 4, dtype, 21).tolil()
        S[5, :] = np.arange(1, 601, dtype=dtype)
        At = _both_csr(S.tocsr())[1]
        return csr_to_cwell(At), 600
    n, m, group = {"narrow": (700, 650, 1), "grouped": (700, 650, 2),
                   "n, m not x128": (1001, 777, 1)}[case]
    return csr_to_cwell(_both_csr(_scipy_csr(n, m, 6, dtype, 22))[1],
                        group=group), m


@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["narrow", "grouped", "n, m not x128",
                                  "wide"])
def test_compact_spmm_columns_equal_compact_spmv(case, dtype, k):
    """Column j of ``cwell_compact_spmm`` is ``cwell_compact_spmv`` of
    B[:, j] bit for bit (the order K6 / K7 and K4 / K5 share), and the
    product agrees with the plane reference (BOUND of max|Y|)."""
    W, m = _spmm_pack(case, dtype)
    plan, cv = cc.compact(W)
    assert plan.wide == (case == "wide")
    B = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (m, k)).astype(dtype))
    Y = tref.cwell_compact_spmm(plan, cv, B)
    assert Y.shape == (W.shape[0], k) and Y.dtype == B.dtype
    for j in range(k):
        assert torch.equal(Y[:, j], tref.cwell_compact_spmv(plan, cv,
                                                            B[:, j]))
    Yp = tref.cwell_spmm(W, B)
    assert float((Y - Yp).abs().max()) <= BOUND[dtype] * float(
        Yp.abs().max())


def test_compact_spmm_matches_pallas_k6_k7_interpret():
    """JAX K6 (the gather kernel) and K7 (the one-hot kernel) in interpret
    mode on a grouped pack with m not a multiple of 128: within 1e-5 of
    max|Y| (float32 sums in another order)."""
    from tpu_sparse.kernels import pallas_cwell

    S = _scipy_csr(300, 333, 16, np.float32, 23)
    Aj, At = _both_csr(S)
    Wj, Wt = jcsr_to_cwell(Aj, group=2), csr_to_cwell(At, group=2)
    B = np.random.default_rng(9).standard_normal((333, 8)).astype(np.float32)
    pallas_cwell._INTERPRET = True
    try:
        y6 = np.asarray(pallas_cwell.cwell_spmm_pallas_gather(
            Wj, jnp.asarray(B)))
        y7 = np.asarray(pallas_cwell._cwell_spmm_impl(
            Wj.vals, Wj.idx2, Wj.srow, jnp.asarray(B), shape=Wj.shape, rb=4,
            kt=8, group=Wj.group))
    finally:
        pallas_cwell._INTERPRET = False
    yt = tref.cwell_compact_spmm(*cc.compact(Wt), torch.from_numpy(B))
    for y in (y6, y7):
        assert np.abs(yt.numpy() - y).max() <= 1e-5 * np.abs(y).max()


# ---- one rule for zero slots: NaN read only by zero values ------------------


def _bell_with_zero_column():
    """A BELL whose scalar column 0 is zero in every stored block, with
    padding blocks (index 0) as well: only zero values read B's row 0."""
    rng = np.random.default_rng(24)
    nb, bs = 10, 4
    Ad = np.zeros((nb * bs, nb * bs))
    mask = rng.random((nb, nb)) < 0.3
    np.fill_diagonal(mask, True)
    mask[:, 0] = True  # block column 0 stored in every block row
    for i, j in zip(*np.nonzero(mask)):
        Ad[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.standard_normal(
            (bs, bs))
    Ad[:, 0] = 0.0
    C = tconvert.dense_to_csr(torch.from_numpy(Ad))
    S = csr_to_bsr(C, bs)
    bell = bsr_to_bell(S, ell_width=int(mask.sum(1).max()) + 2)
    return bell, Ad


@pytest.mark.parametrize("what", ["cwell_spmm", "bell_spmv", "bell_spmm"])
def test_nan_read_only_by_zero_values_stays_out(what):
    """A NaN in x or B at a column that only padding or zero values read
    leaves every output finite, and the output equals the one with 0 there
    (the port skips products whose matrix value is 0 on every path)."""
    if what == "cwell_spmm":
        S = _scipy_csr(400, 300, 4, np.float64, 11)
        S[:, 0] = 0.0
        S.eliminate_zeros()  # column 0 is empty; padding slots read it
        A = csr_to_cwell(_both_csr(S)[1])
        gc = A.gcols()
        assert bool(((gc == 0) & (A.vals == 0)).any())
        fn, dense = tref.cwell_spmm, S.toarray()
    else:
        A, dense = _bell_with_zero_column()
        assert bool((A.blocks[A.indices == 0][..., 0] == 0).all())
        fn = tref.bell_spmv if what == "bell_spmv" else tref.bell_spmm
    B = np.random.default_rng(25).standard_normal((dense.shape[1], 3))
    if what == "bell_spmv":
        B = B[:, 0]
    Bn = torch.from_numpy(B.copy())
    Bn[0] = float("nan")
    Y = fn(A, Bn)
    assert bool(torch.isfinite(Y).all())
    Bz = Bn.clone()
    Bz[0] = 0.0
    assert torch.equal(Y, fn(A, Bz))
    np.testing.assert_allclose(Y.numpy(), dense @ B, rtol=1e-12, atol=1e-12)


# ---- caches with one entry per live structure ------------------------------


def test_transpose_and_repack_caches_hold_every_live_structure(monkeypatch):
    """Six differentiated CWELL structures and eighteen BELL matvecs on the
    repack path, each visited twice in turn: one transpose, one repack and
    one plan build per structure (the caches used to empty completely at
    4 and 16 entries)."""
    import tpu_sparse_torch
    from tpu_sparse_torch.autodiff import implicit
    from tpu_sparse_torch.sparse import cwell as tcwell

    counts = {"transposes": 0, "repacks": {"cwell": 0, "bell": 0}}
    mode = ["cwell"]  # which loop repacks: the transposes' or the BELLs'
    real_t, real_p = implicit._transpose_plan, tcwell.csr_to_cwell

    def transpose_plan(A):
        counts["transposes"] += 1
        return real_t(A)

    def repack(*a, **kw):
        counts["repacks"][mode[0]] += 1
        return real_p(*a, **kw)

    monkeypatch.setattr(implicit, "_transpose_plan", transpose_plan)
    packs = [csr_to_cwell(_both_csr(_scipy_csr(
        60, 60, 3, np.float64, 30 + i) + 4.0 * sp.eye(60, format="csr"))[1])
        for i in range(6)]
    monkeypatch.setattr(tcwell, "csr_to_cwell", repack)
    bells = []
    for i in range(18):
        rng = np.random.default_rng(40 + i)
        Ad = np.kron(np.eye(6) + (rng.random((6, 6)) < 0.3),
                     rng.standard_normal((2, 2)))
        bells.append(bsr_to_bell(csr_to_bsr(
            tconvert.dense_to_csr(torch.from_numpy(Ad)), 2)))
    b = torch.ones(60, dtype=torch.float64)
    tracing.reset()
    for _ in range(2):
        mode[0] = "cwell"
        for W in packs:
            vals = W.vals.clone().requires_grad_()
            x, r = tpu_sparse_torch.solve(W.with_data(vals), b,
                                          method="bicgstab", tol=1e-10,
                                          precision="full")
            assert r.converged
            x.sum().backward()
            assert bool(torch.isfinite(vals.grad).all())
        mode[0] = "bell"
        for A in bells:
            x = torch.ones(A.shape[1], dtype=torch.float64)
            y = tref.cwell_compact_spmv(*cc.compact(block_cwell(A)), x)
            assert torch.allclose(y, tref.bell_spmv(A, x), rtol=1e-12,
                                  atol=1e-12)
    # a transpose plan repacks the transposed CSR once
    assert counts == {"transposes": 6, "repacks": {"cwell": 6, "bell": 18}}
    assert cc.COUNTS["plan_builds"] == 18
