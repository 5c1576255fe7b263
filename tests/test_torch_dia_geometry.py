"""Kernel 1's plain mode (``csrc/dia_spmv.cu``): the launch geometry its
host entry computes, as ``cuda_spmv.plain_geometry`` mirrors it, on the CPU.

* The interior [lo, hi): every row inside has all its columns in
  [0, n_cols), every row outside at least one outside.
* Rows a thread, design and CTAs at the 160^3 27-point shape and the
  lid-driven cavity's 256^2 5-point shape, in every build; one row a
  thread when the grid would keep fewer than two CTAs a SM.
* The vector design's rule: a data pointer and a row length aligned to
  its vector (min(R x value bytes, 16) bytes), else the scalar path.
* The plain version summed tile by tile over that split (tiles inside the
  interior without column tests, the others with them, diagonals in
  offsets order) equals ``reference.dia_spmv`` (``dia_spmv_wide`` for the
  bf16 builds) bit for bit, and JAX's reference DIA SpMV within 1e-14 /
  1e-6 of max|y| (f64 / f32: the same products and order; XLA may fuse).
  Complex builds: torch's complex product on the CPU rounds each
  operation in its vector loop but contracts to a multiply-add in its
  scalar tail, so its bits depend on where a slice starts; the tile split
  computes (ac - bd, ad + bc) with each operation rounded, as the kernel
  does, and equals the same sum without the split bit for bit, and
  ``reference.dia_spmv`` within 1e-6 (c64) / 1e-15 (c128) of max|y|.

The card tests (``tests/test_torch_cuda.py -k kernel1``) hold the C host
entry's geometry to this mirror and the kernel to v1 bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sparse.kernels import reference as jref
from tpu_sparse.sparse.convert import dia_from_offsets
from tpu_sparse_torch.kernels import cuda_spmv
from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse import generators as gen
from tpu_sparse_torch.sparse.containers import DIA
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

SMS = 132  # an H100's SMs
BUILDS = {"f32": (torch.float32, torch.float32),
          "f64": (torch.float64, torch.float64),
          "c64": (torch.complex64, torch.complex64),
          "c128": (torch.complex128, torch.complex128),
          "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16_f32": (torch.bfloat16, torch.float32)}
OFFSETS_27 = tuple(dz * 25600 + dy * 160 + dx for dz in (-1, 0, 1)
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1))


@pytest.mark.parametrize("offsets,n_rows,n_cols", [
    ((-1, 0, 1), 50, 50), ((-7, 0, 3, 11), 40, 33), ((-2, 5), 30, 60),
    ((0,), 10, 4), ((-45, 2), 40, 40), ((60,), 40, 40), ((), 12, 9),
    (tuple(range(-32, 32)), 200, 190), ((-3, 4, 0, -1), 5, 5)])
def test_interior_has_every_column_in_range(offsets, n_rows, n_cols):
    lo, hi = cuda_spmv.interior(offsets, n_rows, n_cols)
    assert 0 <= lo <= hi <= n_rows
    for i in range(n_rows):
        inside = all(0 <= i + o < n_cols for o in offsets)
        assert inside == (lo <= i < hi), (i, lo, hi)


# (rows a thread, design, CTAs) at 160^3 (4,096,000 rows, 27 diagonals) and
# at the LDC's 65,536 rows (5 diagonals), on an aligned contiguous data
EXPECTED = {
    "f32": ((2, "vector", 8000), (1, "strided", 256)),
    "f64": ((1, "strided", 16000), (1, "strided", 256)),
    "c64": ((1, "strided", 16000), (1, "strided", 256)),
    "c128": ((1, "strided", 16000), (1, "strided", 256)),
    "bf16": ((2, "vector", 8000), (1, "strided", 256)),
    "bf16_f32": ((2, "vector", 8000), (1, "strided", 256)),
}


@pytest.mark.parametrize("sfx", list(BUILDS))
@pytest.mark.parametrize("shape", ["160^3", "ldc"])
def test_geometry_at_the_main_path_shapes(sfx, shape):
    if shape == "160^3":
        offsets, n, (rows, design, grid) = OFFSETS_27, 160 ** 3, \
            EXPECTED[sfx][0]
        lo_hi = (25761, n - 25761)
    else:
        offsets, n, (rows, design, grid) = (-256, -1, 0, 1, 256), 256 ** 2, \
            EXPECTED[sfx][1]
        lo_hi = (256, n - 256)
    geo = cuda_spmv.plain_geometry(sfx, list(offsets), n, n, n, 1 << 20, SMS)
    assert (geo["lo"], geo["hi"]) == lo_hi
    assert (geo["rows"], geo["design"], geo["grid"]) == (rows, design, grid)
    assert geo["grid"] * cuda_spmv.BLOCK * geo["rows"] >= n
    assert (geo["grid"] - 1) * cuda_spmv.BLOCK * geo["rows"] < n


@pytest.mark.parametrize("sfx,rows,ptr,ld,fits", [
    ("bf16", 8, 1 << 20, 4096, True), ("bf16", 8, (1 << 20) + 2, 4096, False),
    ("bf16", 8, 1 << 20, 4100, False), ("bf16", 2, (1 << 20) + 4, 4098, True),
    ("bf16", 2, (1 << 20) + 2, 4098, False), ("bf16", 4, 1 << 20, 4100, True),
    ("f32", 4, (1 << 20) + 8, 4096, False), ("c64", 4, 1 << 20, 4098, True),
    ("c128", 2, (1 << 20) + 16, 7, True), ("f64", 2, (1 << 20) + 8, 4096,
                                           False)])
def test_vector_design_needs_aligned_rows(sfx, rows, ptr, ld, fits):
    assert cuda_spmv.vector_fits(sfx, rows, ptr, ld) == fits


def test_unaligned_data_and_small_grids_take_one_row_a_thread():
    n = 160 ** 3
    off = list(OFFSETS_27)
    aligned = cuda_spmv.plain_geometry("bf16", off, n, n, n, 1 << 20, SMS)
    assert (aligned["design"], aligned["rows"]) == \
        cuda_spmv.PLAIN_DESIGNS["bf16"] == ("vector", 2)
    for ptr, ld in (((1 << 20) + 2, n), (1 << 20, n + 1)):
        geo = cuda_spmv.plain_geometry("bf16", off, n, n, ld, ptr, SMS)
        assert (geo["rows"], geo["design"], geo["grid"]) == \
            (1, "strided", n // cuda_spmv.BLOCK)
    # two CTAs a SM at R rows a thread, or one row a thread
    for sfx, (design, r) in cuda_spmv.PLAIN_DESIGNS.items():
        edge = 2 * SMS * cuda_spmv.BLOCK * r
        big = cuda_spmv.plain_geometry(sfx, [-1, 0, 1], edge, edge, edge,
                                       1 << 20, SMS)
        small = cuda_spmv.plain_geometry(sfx, [-1, 0, 1],
                                         edge - cuda_spmv.BLOCK * r, edge,
                                         edge, 1 << 20, SMS)
        assert (big["rows"], big["design"]) == (r, design)
        assert (small["rows"], small["design"]) == (1, "strided")


def _operands(sfx, case, rng):
    vdt, xdt = BUILDS[sfx]
    if case == "poisson3d_27pt(9)":
        A = gen.poisson3d_27pt(9, dtype=np.float64, device="cpu")
        offsets, shape = A.offsets, A.shape
        data = rng.standard_normal(tuple(A.data.shape))
    elif case == "rectangular 3000 x 2100":
        offsets, shape = (-900, -5, 0, 7, 1500), (3000, 2100)
        data = rng.standard_normal((5, 3000))
    else:  # square, n not a multiple of any R, ld > n
        offsets, shape = (-40, -1, 0, 1, 40), (2999, 2999)
        data = rng.standard_normal((5, 3008))
    data = torch.from_numpy(data)
    x = torch.from_numpy(rng.standard_normal(shape[1]))
    if vdt.is_complex:
        data = data + 1j * torch.from_numpy(rng.standard_normal(
            tuple(data.shape)))
        x = x + 1j * torch.from_numpy(rng.standard_normal(shape[1]))
    return DIA(data.to(vdt), tuple(offsets), shape), x.to(xdt)


def _product(a, b):
    """a * b; complex as (ac - bd, ad + bc), each operation rounded."""
    if not a.is_complex():
        return a * b
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


def tiled_plain(A, x, geo):
    """The plain version summed tile by tile over the split the kernel
    makes: a tile wholly inside [lo, hi) sums every diagonal without
    tests, the others test each column; diagonals in offsets order, bf16
    widened to float32 and y rounded once. ``geo`` with lo == hi tests
    every column of every row."""
    n, m = A.shape
    data, xw = ref.widen(A.data), ref.widen(x)
    tile = geo["rows"] * (cuda_spmv.BLOCK if geo["design"] == "strided"
                          else 1)
    acc_dt = torch.promote_types(data.dtype, xw.dtype)
    y = torch.zeros(n, dtype=acc_dt)
    for t0 in range(0, n, tile):
        t1 = min(t0 + tile, n)
        rows = torch.arange(t0, t1)
        acc = torch.zeros(t1 - t0, dtype=acc_dt)
        inside = t0 >= geo["lo"] and t0 + tile <= geo["hi"]
        for d, o in enumerate(A.offsets):
            if inside:
                acc = acc + _product(data[d, t0:t1], xw[t0 + o:t1 + o])
            else:
                ok = (rows + o >= 0) & (rows + o < m)
                term = _product(data[d, t0:t1][ok], xw[(rows + o)[ok]])
                acc[ok] = acc[ok] + term
        y[t0:t1] = acc
    return y.to(torch.promote_types(A.data.dtype, x.dtype))


@pytest.mark.parametrize("sfx", list(BUILDS))
@pytest.mark.parametrize("case", ["poisson3d_27pt(9)",
                                  "rectangular 3000 x 2100",
                                  "n 2999, ld 3008"])
def test_tile_split_plain_equals_reference(sfx, case):
    A, x = _operands(sfx, case, np.random.default_rng(14))
    n, m = A.shape
    for sms in (SMS, 1):  # the main rule, and R rows a thread forced
        geo = cuda_spmv.plain_geometry(sfx, list(A.offsets), n, m,
                                       A.data.shape[1], 1 << 20, sms)
        y = tiled_plain(A, x, geo)
        y0 = (ref.dia_spmv_wide if sfx.startswith("bf16") else
              ref.dia_spmv)(A, x)
        assert y.dtype == y0.dtype
        if sfx in ("c64", "c128"):
            untiled = tiled_plain(A, x, dict(geo, lo=0, hi=0))
            assert torch.equal(y, untiled), (sfx, case, geo)
            tol = 1e-6 if sfx == "c64" else 1e-15
            assert float((y - y0).abs().max()) <= \
                tol * float(y0.abs().max())
        else:
            assert torch.equal(y, y0), (sfx, case, geo)


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-14),
                                         (np.float32, 1e-6)])
@pytest.mark.parametrize("case", ["rectangular 3000 x 2100",
                                  "n 2999, ld 3008"])
def test_tile_split_plain_matches_jax_reference(case, dtype, bound):
    sfx = "f64" if dtype == np.float64 else "f32"
    A, x = _operands(sfx, case, np.random.default_rng(15))
    n, m = A.shape
    geo = cuda_spmv.plain_geometry(sfx, list(A.offsets), n, m,
                                   A.data.shape[1], 1 << 20, 1)
    y = tiled_plain(A, x, geo).numpy()
    Aj = dia_from_offsets(A.offsets, A.data[:, :n].numpy(), A.shape)
    yj = np.asarray(jref.dia_spmv(Aj, jnp.asarray(x.numpy())))
    assert y.dtype == yj.dtype
    assert np.max(np.abs(y - yj)) <= bound * np.max(np.abs(yj))
