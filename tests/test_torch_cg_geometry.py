"""Kernel 2 of the fused CG (``csrc/dia_cg.cu``, ``dia_cg_spmv_dot``): the
launch geometry its host entry computes, as ``cuda_cg.spmv_dot_geometry``
mirrors it, on the CPU.

* The instance: unrolled for 3, 5, 7, 9 and 27 diagonals, the generic loop
  for any other count.
* Rows a thread and CTAs (one a tile of 256 x rows rows) at the
  benchmark's 256^3 and the smoke run's 160^3 27-point shapes, a 3-D
  7-point and a 2-D 5-point shape; one row a thread when the grid would
  keep fewer than two CTAs a SM, or when the data pointer or the row length
  ``ld`` is not aligned to the vector loads (R x 4 bytes).
* The <p,Ap> slots: always ``grid_for(n)`` (what kernel 3 sums), each
  summing ``per_slot`` consecutive tiles, every tile in exactly one slot.
* The plain version summed tile by tile over that split (each neighbour's
  direction formed from r and p_prev, as the kernel forms it) gives the
  untiled plain version's p_new and ap bit for bit, and its <p,Ap> folded
  into the slots sums to the untiled one within 1e-12.

The card tests (``tests/test_torch_cuda.py -k kernel2``) hold the C host
entry's geometry to this mirror and the kernel to its plain version.
"""

import numpy as np
import pytest
import torch

from tpu_sparse_torch.kernels import cuda_cg, cuda_spmv
from tpu_sparse_torch.sparse import generators as gen
from tpu_sparse_torch.sparse.containers import DIA
from _cpu_threads import one_cpu_thread  # noqa: F401  (autouse)

SMS = 132  # an H100's SMs
ALIGNED = 1 << 20


def stencil(ndiag: int, nx: int, dims: int = 3) -> list:
    """Offsets of a 27- or 7-point 3-D stencil, a 5-point 2-D one, or (11)
    the 7-point one with +-2 and +-2 nx added."""
    if dims == 2:
        return [-nx, -1, 0, 1, nx]
    if ndiag == 27:
        return [dz * nx * nx + dy * nx + dx for dz in (-1, 0, 1)
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    seven = [-nx * nx, -nx, -1, 0, 1, nx, nx * nx]
    return seven if ndiag == 7 else sorted(seven + [-2 * nx, -2, 2, 2 * nx])


# name: (offsets, n, ld, data address) -> (rows a thread, CTAs, unrolled,
# slots, tiles a slot)
CASES = {
    "27-point 256^3": ((stencil(27, 256), 256 ** 3, 256 ** 3, ALIGNED),
                       (2, 32768, True, 1024, 32)),
    "27-point 160^3": ((stencil(27, 160), 160 ** 3, 160 ** 3, ALIGNED),
                       (2, 8000, True, 1024, 8)),
    "7-point 128^3": ((stencil(7, 128), 128 ** 3, 128 ** 3, ALIGNED),
                      (2, 4096, True, 1024, 4)),
    "5-point 1024^2": ((stencil(5, 1024, 2), 1024 ** 2, 1024 ** 2, ALIGNED),
                       (2, 2048, True, 1024, 2)),
    "11 diagonals 64^3": ((stencil(11, 64), 64 ** 3, 64 ** 3, ALIGNED),
                          (2, 512, False, 1024, 1)),
    "5-point 256^2 (two CTAs a SM need 135,168 rows)": (
        (stencil(5, 256, 2), 256 ** 2, 256 ** 2, ALIGNED),
        (1, 256, True, 256, 1)),
    "160^3, odd ld": ((stencil(27, 160), 160 ** 3, 160 ** 3 + 1, ALIGNED),
                      (1, 16000, True, 1024, 16)),
    "160^3, data 4 bytes off": ((stencil(27, 160), 160 ** 3, 160 ** 3,
                                 ALIGNED + 4),
                                (1, 16000, True, 1024, 16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_geometry_at_the_shapes(case):
    (offsets, n, ld, ptr), expected = CASES[case]
    geo = cuda_cg.spmv_dot_geometry(n, offsets, ld, ptr, SMS)
    assert (geo["rows"], geo["grid"], geo["unrolled"], geo["n_pap"],
            geo["per_slot"]) == expected
    tile = cuda_cg.BLOCK * geo["rows"]
    assert (geo["grid"] - 1) * tile < n <= geo["grid"] * tile
    # every tile in one slot, and no more slots than kernel 3 sums
    assert geo["n_pap"] == cuda_cg.grid_for(n) <= cuda_cg.MAX_GRID
    used = -(-geo["grid"] // geo["per_slot"])
    assert (used - 1) * geo["per_slot"] < geo["grid"]
    assert used <= geo["n_pap"]


@pytest.mark.parametrize("ndiag", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                   26, 27, 28, 64])
def test_instance_by_diagonal_count(ndiag):
    geo = cuda_cg.spmv_dot_geometry(10 ** 6, [0] * ndiag, 10 ** 6, ALIGNED,
                                    SMS)
    assert geo["unrolled"] == (ndiag in (3, 5, 7, 9, 27))
    assert cuda_cg.UNROLLED_DIAGS == (3, 5, 7, 9, 27)


def test_rows_a_thread_need_two_ctas_a_sm_and_aligned_loads():
    rows = cuda_cg.SPMV_DOT_ROWS
    edge = 2 * SMS * cuda_cg.BLOCK * rows
    for n, ld, ptr, want in (
            (edge, edge, ALIGNED, rows),
            (edge - cuda_cg.BLOCK * rows, edge, ALIGNED, 1),
            (edge, edge + 1, ALIGNED, 1),
            (edge, edge + 2, ALIGNED, rows),
            (edge, edge, ALIGNED + 4, 1),
            (edge, edge, ALIGNED + 8, rows)):
        geo = cuda_cg.spmv_dot_geometry(n, [-1, 0, 1], ld, ptr, SMS)
        assert geo["rows"] == want, (n, ld, ptr)
        assert geo["grid"] == -(-n // (cuda_cg.BLOCK * geo["rows"]))


def _state(ndiag, n, jacobi, seed):
    """A float32 extended operator of ``ndiag`` random diagonals on n rows
    of a 3-D grid and a mid-solve state (r, p_prev random, beta 0.37)."""
    nx = round(n ** (1 / 3))
    offsets = stencil(ndiag, nx)
    g = torch.Generator().manual_seed(seed)
    data = torch.randn(len(offsets), n, generator=g)
    op = cuda_spmv.ExtendedStencilOperator(DIA(data, tuple(offsets),
                                               (n, n)))

    def vec():
        v = torch.zeros(op.E)
        v[op.Wl:op.Wl + n] = torch.randn(n, generator=g)
        return v

    dinv = (op.extend_diag(0.5 + torch.rand(n, generator=g)) if jacobi
            else None)
    scal = torch.tensor([1.0, 0.37], dtype=torch.float64)
    return op, vec(), dinv, vec(), scal


def tiled_plain(op, r, dinv, p_prev, scal, geo):
    """p_new, ap and the <p,Ap> slots formed tile by tile over ``geo``'s
    split, each neighbour's direction formed from r and p_prev."""
    beta = scal[1].to(torch.float32)
    Wl, n = op.Wl, op.n
    tile = cuda_cg.BLOCK * geo["rows"]
    p_new, ap = torch.zeros_like(r), torch.zeros_like(r)
    slots = torch.zeros(geo["n_pap"], dtype=torch.float64)

    def pdir(a, b):
        z = r[a:b] if dinv is None else dinv[a:b] * r[a:b]
        return z + beta * p_prev[a:b]

    for k, a in enumerate(range(0, n, tile)):
        b = min(a + tile, n)
        acc = None
        for d, o in enumerate(op.offsets):
            term = op.data[d, a:b] * pdir(Wl + a + o, Wl + b + o)
            acc = term if acc is None else acc + term
        p_new[Wl + a:Wl + b] = pdir(Wl + a, Wl + b)
        ap[Wl + a:Wl + b] = acc
        slots[k // geo["per_slot"]] += torch.dot(
            p_new[Wl + a:Wl + b].double(), acc.double())
    return p_new, ap, slots


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "jacobi"])
@pytest.mark.parametrize("ndiag,n,ld_pad,sms", [
    (27, 82 ** 3, 0, SMS),   # 1,077 tiles of 512 rows: 2 a slot
    (27, 82 ** 3, 1, SMS),   # odd ld: 2,154 tiles of 256 rows, 3 a slot
    (7, 40 ** 3, 0, 1),      # 125 tiles, one a slot, 125 of 250 slots
    (11, 30 ** 3, 0, SMS),   # the generic loop, one row a thread
])
def test_tile_split_plain_equals_untiled(ndiag, n, ld_pad, sms, jacobi):
    op, r, dinv, p_prev, scal = _state(ndiag, n, jacobi, seed=ndiag + n)
    geo = cuda_cg.spmv_dot_geometry(op.n, op.offsets, op.n + ld_pad,
                                    ALIGNED, sms)
    p_t, ap_t, slots_t = tiled_plain(op, r, dinv, p_prev, scal, geo)
    p_new, ap = torch.zeros_like(r), torch.zeros_like(r)
    whole = torch.zeros(geo["n_pap"], dtype=torch.float64)
    cuda_cg.dia_cg_spmv_dot_plain(op, r, dinv, p_prev, p_new, ap, scal,
                                  whole)
    assert torch.equal(p_t, p_new) and torch.equal(ap_t, ap)
    slots = torch.zeros(geo["n_pap"], dtype=torch.float64)
    p2, ap2 = torch.zeros_like(r), torch.zeros_like(r)
    cuda_cg.dia_cg_spmv_dot_plain(op, r, dinv, p_prev, p2, ap2, scal,
                                  slots, geometry=geo)
    assert torch.equal(p2, p_new) and torch.equal(ap2, ap)
    used = -(-geo["grid"] // geo["per_slot"])
    assert int((slots_t[used:] != 0).sum()) == 0
    assert int((slots[used:] != 0).sum()) == 0
    scale = float(slots_t.abs().sum())
    assert float((slots - slots_t).abs().max()) <= 1e-12 * scale
    assert abs(float(slots.sum() - whole[0])) <= 1e-12 * scale
    assert float(whole[1:].abs().sum()) == 0.0


def test_fused_state_on_the_cpu_has_no_workspace():
    A = gen.poisson3d_27pt(6, dtype=np.float32, device="cpu")
    op = cuda_spmv.ExtendedStencilOperator(A)
    state = cuda_cg.FusedCGState(op, op.extend(torch.ones(op.n)))
    assert state.work is None
    state.run(torch.empty(3))
    assert bool(torch.isfinite(state.x).all())
