"""CWELL — column-window ELL, the pack of general (non-stencil) matrices.

Counterpart of ``tpu_sparse/sparse/cwell.py`` with the same arrays, so a
JAX pack carries across unchanged (``convert.cwell_from_numpy``):

  vals:  (n_blocks, S, 128) — slot values, 0 in padding slots
  idx2:  (n_blocks, S, 128) int32 — column offset inside the plane's
         256-column window: global column = srow * 128 + idx2
  srow:  (n_blocks, S) int32 — window start row of ``x.reshape(-1, 128)``,
         clamped to [0, m_pad / 128 - 2]

Rows are grouped in blocks of 128 (row i of a block sits in lane i % 128).
Within each (row block, 256-column window) a row's nonzeros take
consecutive planes; every block is padded to the common plane count S, and
``fill`` = nnz / slots. ``group=Q`` pads every (block, window) run of
planes to a multiple of Q, each plane of a run carrying the run's window
row; the SpMV kernel reads ``srow`` per plane, so it runs every pack alike.

The packer runs as torch ops on the CSR's own device (one stable sort of a
composite int64 key, then scans and scatters), so a 110M-nnz matrix packs
on the card. Its result is byte-equal to the JAX numpy packer for the same
CSR and group. Not ported: ``group="auto"`` (a TPU tuning heuristic) and
``unroll_cap`` (Mosaic compile time), both under ROADMAP "Not to port".
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch.sparse.containers import CSR, SPARSE_TYPES, _matvec

LW = 128   # lanes per row block
WIN = 256  # window width in columns (two rows of x.reshape(-1, 128))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _starts(key: torch.Tensor) -> torch.Tensor:
    """Where a sorted key changes: True at 0 and where key[i] != key[i-1]."""
    out = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    out[1:] = key[1:] != key[:-1]
    return out


def coo_arrays_to_csr(rows, cols, vals, shape) -> CSR:
    """CSR from COO arrays on their device: columns sorted within rows,
    duplicate entries summed in the order they are given."""
    n, m = shape
    key = rows.long() * max(m, 1) + cols.long()
    order = torch.argsort(key, stable=True)
    key, vals = key[order], vals[order]
    uniq, inv = torch.unique_consecutive(key, return_inverse=True)
    if uniq.numel() < key.numel():
        vals = vals.new_zeros(uniq.numel()).index_add_(0, inv, vals)
    r = uniq // max(m, 1)
    indptr = torch.searchsorted(r, torch.arange(n + 1, device=r.device))
    return CSR(vals, (uniq % max(m, 1)).to(torch.int32),
               indptr.to(torch.int32), (n, m))


class CWELL:
    """Column-window ELL matrix (see the module docstring)."""

    def __init__(self, vals, idx2, srow, shape, nnz=None, fill=None,
                 group=1):
        self.vals = vals
        self.idx2 = idx2
        self.srow = srow
        self.shape = tuple(int(s) for s in shape)
        self._nnz = None if nnz is None else int(nnz)
        self.fill = None if fill is None else float(fill)
        self.group = int(group) if group else 1

    @property
    def n_blocks(self) -> int:
        return int(self.idx2.shape[0])

    @property
    def planes(self) -> int:
        return int(self.idx2.shape[1])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.idx2.device

    @property
    def nnz(self) -> int:
        if self._nnz is not None:
            return self._nnz
        return int(torch.count_nonzero(self.vals))

    def with_data(self, vals) -> "CWELL":
        return CWELL(vals, self.idx2, self.srow, self.shape, nnz=self._nnz,
                     fill=self.fill, group=self.group)

    def to(self, device) -> "CWELL":
        return CWELL(self.vals.to(device), self.idx2.to(device),
                     self.srow.to(device), self.shape, nnz=self._nnz,
                     fill=self.fill, group=self.group)

    def gcols(self) -> torch.Tensor:
        """Global column per slot, (n_blocks, S, 128) int64."""
        return self.srow[:, :, None].long() * LW + self.idx2

    def tocsr(self) -> CSR:
        """Back to CSR on the pack's device. Slots of value 0 are dropped,
        so padding and explicit zeros go, as in the JAX conversion."""
        n, _ = self.shape
        b, s, lane = (self.vals != 0).nonzero(as_tuple=True)
        rows = b * LW + lane
        keep = rows < n
        b, s, lane, rows = b[keep], s[keep], lane[keep], rows[keep]
        cols = self.srow[b, s].long() * LW + self.idx2[b, s, lane]
        return coo_arrays_to_csr(rows, cols, self.vals[b, s, lane],
                                 self.shape)

    def todense(self) -> torch.Tensor:
        return self.tocsr().todense()

    @property
    def T(self) -> "CWELL":
        """Transpose: a repack of the transposed CSR on the pack's device."""
        return csr_to_cwell(self.tocsr().T)

    def __matmul__(self, x):
        return _matvec(self, x)

    def __repr__(self):
        return (f"CWELL(shape={self.shape}, blocks={self.n_blocks}, "
                f"S={self.planes}, fill={self.fill})")


def csr_to_cwell(A: CSR, *, plane_pad: int = 8, group: int = 1) -> CWELL:
    """Pack a CSR matrix into CWELL on the CSR's device.

    Window w covers columns [256 w, 256 w + 256); within each (row block,
    window) a row's k nonzeros take planes base .. base + k - 1, in CSR
    order, where base is the window's plane offset in the block.
    ``group=Q`` (Q in 2, 4, 8) pads every (block, window) run to a multiple
    of Q planes. Index arithmetic is int64 throughout: the sort key
    ``(block * nwin + window) * 128 + lane`` passes 2^31 near 10^8 nnz.
    """
    if group == "auto":
        raise ValueError(
            "group='auto' is a TPU tuning heuristic and is not ported "
            "(ROADMAP, 'Not to port'); pass group=1, 2, 4 or 8")
    if group not in (1, 2, 4, 8):
        raise ValueError("group quantum must be 1, 2, 4, or 8")
    if group > 1 and plane_pad % 8 != 0:
        raise ValueError("grouped packing requires plane_pad % 8 == 0")
    dev = A.indices.device
    n, m = A.shape
    nnz = int(A.indices.shape[0])
    nb = max(_round_up(n, LW) // LW, 1)
    m_pad = max(_round_up(m, LW), 2 * LW)
    rmax = m_pad // LW - 2  # largest srow for which srow + 1 is a row of x
    i64 = dict(dtype=torch.int64, device=dev)

    if nnz == 0:
        return CWELL(torch.zeros((nb, plane_pad, LW), dtype=A.data.dtype,
                                 device=dev),
                     torch.zeros((nb, plane_pad, LW), dtype=torch.int32,
                                 device=dev),
                     torch.zeros((nb, plane_pad), dtype=torch.int32,
                                 device=dev),
                     (n, m), nnz=0, fill=0.0, group=group)

    cols = A.indices.long()
    rows = torch.repeat_interleave(torch.arange(n, **i64),
                                   torch.diff(A.indptr.long()),
                                   output_size=nnz)
    nwin = m // WIN + 2
    # one stable sort by (block, window, lane): CSR order, hence column
    # order, survives inside each (block, window, row) group
    key = ((rows // LW) * nwin + cols // WIN) * LW + rows % LW
    del rows
    order = torch.argsort(key, stable=True)
    key = key[order]
    c_s, v_s = cols[order], A.data[order]
    del cols, order
    r_s = key % LW
    key_bw = key // LW
    b_s = key_bw // nwin
    w_s = key_bw % nwin

    # rank of each entry within its (block, window, row) group
    idx = torch.arange(nnz, **i64)
    first = torch.cummax(torch.where(_starts(key), idx, 0), 0).values
    rank = idx - first
    del key, idx, first

    # planes per (block, window): the largest rank + 1 in the window
    win_start = _starts(key_bw)
    del key_bw
    win_ids = torch.cumsum(win_start, 0) - 1
    n_wins = int(win_ids[-1]) + 1
    ppw = torch.zeros(n_wins, **i64).scatter_reduce_(0, win_ids, rank + 1,
                                                     "amax")
    if group > 1:
        ppw = (ppw + group - 1) // group * group
    win_first = win_start.nonzero().squeeze(1)
    del win_start
    win_block = b_s[win_first]
    csum = torch.zeros(n_wins + 1, **i64)
    csum[1:] = torch.cumsum(ppw, 0)
    blk_base = torch.cummax(torch.where(_starts(win_block), csum[:-1], 0),
                            0).values
    win_base = csum[:-1] - blk_base  # the window's first plane in its block

    plane = win_base[win_ids] + rank
    del win_ids, rank
    s_blk = torch.zeros(nb, **i64).scatter_reduce_(0, b_s, plane + 1, "amax")
    S = _round_up(max(int(s_blk.max()), 1), plane_pad)

    sr = torch.clamp_max(w_s * 2, rmax)  # window start row
    vals = torch.zeros((nb, S, LW), dtype=A.data.dtype, device=dev)
    idx2 = torch.zeros((nb, S, LW), dtype=torch.int32, device=dev)
    srow = torch.zeros((nb, S), dtype=torch.int32, device=dev)
    vals[b_s, plane, r_s] = v_s
    idx2[b_s, plane, r_s] = (c_s - sr * LW).to(torch.int32)
    srow[b_s, plane] = sr.to(torch.int32)

    if group > 1:
        # every plane of a padded run, padding included, carries the run's
        # window row
        total = int(csum[-1])
        run_start = win_block * S + win_base
        offs = torch.arange(total, **i64) - torch.repeat_interleave(
            csum[:-1], ppw, output_size=total)
        sr_win = torch.clamp_max(w_s[win_first] * 2, rmax)
        srow.view(-1)[torch.repeat_interleave(run_start, ppw,
                                              output_size=total) + offs] = \
            torch.repeat_interleave(sr_win, ppw,
                                    output_size=total).to(torch.int32)

    fill = nnz / float(nb * S * LW)
    return CWELL(vals, idx2, srow, (n, m), nnz=nnz, fill=fill, group=group)


class CWELLSeg:
    """CWELL in column segments: ``y = sum_seg W_seg @ x[start:start+width]``,
    each segment covering only the 128-aligned row range its columns touch.

    The JAX package splits wide matrices this way because its kernel keeps
    x in VMEM. The card's kernel gathers x from device memory at any width,
    so ``to_gpu_operator`` never builds one; the class is here so that JAX
    packs and code written for them carry across.
    """

    def __init__(self, segments, starts, widths, shape, nnz=None,
                 rstarts=None):
        self.segments = tuple(segments)
        self.starts = tuple(int(s) for s in starts)
        self.widths = tuple(int(w) for w in widths)
        self.shape = tuple(int(s) for s in shape)
        self._nnz = None if nnz is None else int(nnz)
        self.rstarts = (tuple(int(r) for r in rstarts)
                        if rstarts is not None
                        else (0,) * len(self.segments))

    @property
    def dtype(self):
        return self.segments[0].dtype

    @property
    def device(self):
        return self.segments[0].device

    @property
    def nnz(self) -> int:
        if self._nnz is not None:
            return self._nnz
        return sum(W.nnz for W in self.segments)

    @property
    def fill(self) -> float:
        slots = sum(W.n_blocks * W.planes * LW for W in self.segments)
        return self.nnz / max(slots, 1)

    def with_data(self, vals) -> "CWELLSeg":
        """Replace the values: ``vals`` is the flat concatenation of the
        segments' values (``containers.values``), or None."""
        segs, k = [], 0
        for W in self.segments:
            size = W.idx2.numel()
            segs.append(W.with_data(
                None if vals is None
                else vals[k:k + size].reshape(W.idx2.shape)))
            k += size
        return CWELLSeg(segs, self.starts, self.widths, self.shape,
                        nnz=self._nnz, rstarts=self.rstarts)

    def to(self, device) -> "CWELLSeg":
        return CWELLSeg([W.to(device) for W in self.segments], self.starts,
                        self.widths, self.shape, nnz=self._nnz,
                        rstarts=self.rstarts)

    def tocsr(self) -> CSR:
        rows, cols, vals = [], [], []
        for W, j0, r0 in zip(self.segments, self.starts, self.rstarts):
            C = W.tocsr().tocoo()
            rows.append(C.row.long() + r0)
            cols.append(C.col.long() + j0)
            vals.append(C.data)
        return coo_arrays_to_csr(torch.cat(rows), torch.cat(cols),
                                 torch.cat(vals), self.shape)

    def todense(self) -> torch.Tensor:
        return self.tocsr().todense()

    @property
    def T(self) -> "CWELLSeg":
        return csr_to_cwell_segments(
            self.tocsr().T, seg_cols=_round_up(max(self.widths), WIN))

    def __matmul__(self, x):
        return _matvec(self, x)

    def __repr__(self):
        return (f"CWELLSeg(shape={self.shape}, "
                f"segments={len(self.segments)}, nnz={self.nnz})")


def csr_to_cwell_segments(A: CSR, *, seg_cols: int = 1 << 20,
                          plane_pad: int = 8, group: int = 1) -> CWELLSeg:
    """Split A into 256-aligned column segments and pack each as CWELL
    (slicing on the host through scipy, packing on A's device)."""
    from tpu_sparse_torch.sparse.convert import csr_from_arrays, to_scipy_csr

    if seg_cols % WIN != 0:
        raise ValueError("segment width must be 256-aligned")
    n, m = A.shape
    dev = A.device
    S = to_scipy_csr(A).tocsc()
    segments, starts, widths, rstarts = [], [], [], []
    for j0 in range(0, m, seg_cols):
        j1 = min(j0 + seg_cols, m)
        sub = S[:, j0:j1].tocsr()
        if sub.nnz == 0:
            continue
        # only the 128-aligned row range with nonzeros in these columns
        rnz = np.flatnonzero(np.diff(sub.indptr))
        r0 = int(rnz[0]) // LW * LW
        r1 = min(_round_up(int(rnz[-1]) + 1, LW), n)
        sub = sub[r0:r1]
        segments.append(csr_to_cwell(
            csr_from_arrays(sub.data, sub.indices, sub.indptr,
                            (r1 - r0, j1 - j0), device=dev),
            plane_pad=plane_pad, group=group))
        starts.append(j0)
        widths.append(j1 - j0)
        rstarts.append(r0)
    if not segments:  # all-zero matrix: keep one empty segment
        segments = [csr_to_cwell(A, plane_pad=plane_pad, group=group)]
        starts, widths, rstarts = [0], [m], [0]
    return CWELLSeg(segments, starts, widths, (n, m),
                    nnz=int(A.indptr[-1]), rstarts=rstarts)


def rcm_permutation(A: CSR) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering (scipy, on the host) that restores
    column locality, so that scrambled matrices pack at high fill."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from tpu_sparse_torch.sparse.convert import to_scipy_csr

    return np.asarray(reverse_cuthill_mckee(to_scipy_csr(A),
                                            symmetric_mode=False))


SPARSE_TYPES.append(CWELL)
SPARSE_TYPES.append(CWELLSeg)

__all__ = ["CWELL", "CWELLSeg", "LW", "WIN", "coo_arrays_to_csr",
           "csr_to_cwell", "csr_to_cwell_segments", "rcm_permutation"]
