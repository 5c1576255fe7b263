"""ILU(0) on the card: the port of ``ilu0_factor`` and
``ilu0_preconditioner`` of ``tpu_sparse/precond/poly.py``.

The JAX package factors and substitutes with n-step ``lax.scan``s over a
(w, 2w + 1) band carry; on the 27-point stencil at 160^3 (w = 25,761)
that carry holds 1.3 G entries, and a literal port would make millions of
dependent launches per apply. The port keeps JAX's arithmetic and
schedules the substitutions by levels instead:

* **factor (host, once per matrix).** ``csrc/host/ilu0.cc`` through
  ``_native.ilu0``: JAX's row-by-row IKJ elimination on A's stored
  diagonals, in A's dtype (float, double or their complex types; a
  complex pivot of 0 counts as 1, as a real one), and in the same pass
  the level of every row in each substitution, computed from the
  factors' nonzeros. Stored zeros (a stencil's grid wrap-around
  entries) chain no rows: the 27-point stencil on an nx^3 grid has
  7 (nx - 1) + 1 levels each way (the wavefronts i + 2j + 4k), a 5-point
  one on nx^2 has 2 nx - 1.
* **level packs (on A's device).** The rows are put in level order once
  per sweep; each level's rows of the strictly triangular part, with
  their columns in that order, pack as one rectangular CWELL by the
  port's ``csr_to_cwell`` on the device, from slices of the factor's
  level-ordered CSR copied to the device once. One pack a level: the
  supernodal LU splits a level into row groups of similar plane counts
  (``direct.supernodal._row_groups``), but a stencil's wavefront is one
  group (at 160^3 each of the 2 x 1,113 levels with entries was). Zero
  entries are not packed, as the kernels skip them anyway. A level's
  rows are independent, so its diagonal is a vector: none for L (unit),
  U's diagonal with JAX's zero -> 1 rule for U.
* **apply.** Per level, y[l] = (v[l] - N_l y) / d[l]: one
  ``kernels.spmv`` per pack (K4 in float32, K5 in float64) for a vector,
  one ``kernels.spmm`` (K6/K7) for an (n, k) block (their complex builds
  for a complex factor); the forward sweep over L's levels, then the
  backward sweep over U's, v permuted in once and x out once. On CPU
  tensors the products take the plain versions.

``.to(torch.float32)`` casts the factors' values (JAX casts a
``Partial``'s float leaves for the mixed-precision sweeps); it does not
refactor in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_sparse_torch.precond.amg import _op_to, _product
from tpu_sparse_torch.sparse.containers import CSR, DIA
from tpu_sparse_torch.sparse.cwell import csr_to_cwell

_NOT_DIA = ("ilu0 preconditioner requires a DIA (stencil) matrix; for "
            "general SPD patterns use 'fsai' (parallel apply) instead")


_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _check(A) -> None:
    """What the host factor needs: JAX's ValueError for a non-DIA
    operand, a square matrix, float32, float64, complex64 or complex128
    values (``_native.ilu0`` raises JAX's ValueError for a missing main
    diagonal)."""
    if not isinstance(A, DIA):
        raise ValueError(_NOT_DIA)
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"ILU(0) needs a square matrix, got {A.shape}")
    if A.dtype not in _DTYPES:
        raise TypeError(f"ILU(0) factors float32, float64, complex64 or "
                        f"complex128 values, got {A.dtype}")


def factor_host(A: DIA):
    """The factored band of A on the host and the levels of both sweeps:
    ``_native.ilu0`` on A's values (see the module docstring)."""
    from tpu_sparse_torch.precond import _native

    _check(A)
    return _native.ilu0(A.offsets, A.data.detach().cpu().numpy())


def _diag_index(offsets: Sequence[int]) -> dict:
    """offset -> row of the DIA data (the last one for a repeated offset,
    as the JAX band keeps it)."""
    return {o: d for d, o in enumerate(offsets)}


def ilu0_factor(A: DIA) -> Tuple[DIA, DIA]:
    """ILU(0) of a DIA matrix: L (unit lower, offsets ``neg + [0]``) and U
    (offsets ``[0] + pos``) on A's own pattern, as DIA on A's device in
    A's dtype, equal to the JAX factor's arithmetic."""
    band = factor_host(A)[0]
    at = _diag_index(A.offsets)
    n = A.shape[0]
    neg = sorted(o for o in A.offsets if o < 0)
    pos = sorted(o for o in A.offsets if o > 0)
    L = np.stack([band[at[o]] for o in neg] + [np.ones(n, band.dtype)])
    U = np.stack([band[at[0]]] + [band[at[o]] for o in pos])
    dev = A.device
    return (DIA(torch.from_numpy(L).to(dev), tuple(neg) + (0,), A.shape),
            DIA(torch.from_numpy(U).to(dev), (0,) + tuple(pos), A.shape))


class LevelSweep:
    """One substitution in level order: ``ranges[l]`` = (start, end) of
    level l's rows, ``packs[l]`` None (no dependencies) or the CWELL of
    its rows' strictly triangular entries (columns in level order), and
    ``diag`` the divisor in level order (None: unit diagonal)."""

    def __init__(self, ranges, packs, diag: Optional[torch.Tensor]):
        self.ranges = tuple(ranges)
        self.packs = tuple(packs)
        self.diag = diag

    @property
    def n_levels(self) -> int:
        return len(self.ranges)

    def operators(self):
        """Every pack of the sweep, in launch order."""
        return [N for N in self.packs if N is not None]

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """Solve T y = v for v in level order, (n,) or (n, k)."""
        y = torch.zeros_like(v)
        for (a, b), N in zip(self.ranges, self.packs):
            seg = v[a:b]
            if N is not None:
                seg = seg - _product(N, y)
            if self.diag is not None:
                d = self.diag[a:b]
                seg = seg / (d[:, None] if seg.dim() == 2 else d)
            y[a:b] = seg
        return y

    def to(self, target) -> "LevelSweep":
        return LevelSweep(self.ranges,
                          tuple(_op_to(N, target) for N in self.packs),
                          None if self.diag is None
                          else self.diag.to(target))


def _level_order(lev: np.ndarray, n_levels: int):
    """(order: level position -> row, pos: row -> level position, the
    (start, end) row range of each level)."""
    order = np.argsort(lev, kind="stable")
    pos = np.empty_like(order)
    pos[order] = np.arange(order.size)
    counts = np.bincount(lev, minlength=n_levels)
    ends = np.cumsum(counts)
    ranges = tuple((int(e - c), int(e)) for e, c in zip(ends, counts))
    return order, pos, ranges


def _level_csr(band: np.ndarray, offsets: Sequence[int], order: np.ndarray,
               pos: np.ndarray, lower: bool):
    """The strictly lower (``lower``) or strictly upper part of the
    factored band as CSR arrays in level order: row i is ``order[i]``,
    columns are level positions (in a row, in the order of the matrix
    columns, which the packer does not need sorted), in-range entries
    whose value is not 0. Returns (indptr (n + 1,), indices, values)."""
    n = band.shape[1]
    sel = [(o, d) for o, d in sorted(_diag_index(offsets).items())
           if o != 0 and (o < 0) == lower]
    offs = np.array([o for o, _ in sel], np.int64)
    vals = band[[d for _, d in sel]][:, order].T   # (n, diagonals)
    cols = order[:, None] + offs[None, :]
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return indptr, pos[cols[keep]], vals[keep]


def _sweep(band, offsets, lev, n_levels, lower: bool, dtype, device):
    """The level order and the ``LevelSweep`` of one factor: the level
    CSR goes to the device once, each level's rows pack from slices of
    it."""
    n = band.shape[1]
    order, pos, ranges = _level_order(lev, n_levels)
    indptr, cols, vals = _level_csr(band, offsets, order, pos, lower)
    ptr_d = torch.from_numpy(indptr).to(device)
    cols_d = torch.from_numpy(cols.astype(np.int32)).to(device)
    vals_d = torch.from_numpy(vals).to(device, dtype)
    packs = []
    for a, b in ranges:
        e0, e1 = int(indptr[a]), int(indptr[b])
        packs.append(None if e1 == e0 else csr_to_cwell(CSR(
            vals_d[e0:e1], cols_d[e0:e1],
            (ptr_d[a:b + 1] - e0).to(torch.int32), (b - a, n))))
    diag = None
    if not lower:
        d = band[_diag_index(offsets)[0]][order]
        diag = torch.from_numpy(np.where(d != 0, d, 1).astype(d.dtype)
                                ).to(device)
    return order, pos, LevelSweep(ranges, packs, diag)


class ILU0Preconditioner:
    """M v = U^-1 L^-1 v by level-scheduled substitutions (see the module
    docstring): ``__call__`` for a vector, ``matmat`` for an (n, k) block,
    ``.to(device or dtype)``. ``order`` takes v into the forward sweep's
    level order, ``mid`` the forward result into the backward sweep's,
    ``out`` the backward result back to rows."""

    def __init__(self, fwd: LevelSweep, bwd: LevelSweep, order: torch.Tensor,
                 mid: torch.Tensor, out: torch.Tensor, dtype: torch.dtype):
        self.fwd, self.bwd = fwd, bwd
        self.order, self.mid, self.out = order, mid, out
        self.dtype = dtype

    @staticmethod
    def from_factor(A: DIA, band: np.ndarray, lev_f: np.ndarray,
                    lev_b: np.ndarray, n_levels: Tuple[int, int]
                    ) -> "ILU0Preconditioner":
        """Level packs of a factored band (``factor_host``) on A's
        device."""
        dev, dt = A.device, A.dtype
        order_f, pos_f, fwd = _sweep(band, A.offsets, lev_f, n_levels[0],
                                     True, dt, dev)
        order_b, pos_b, bwd = _sweep(band, A.offsets, lev_b, n_levels[1],
                                     False, dt, dev)

        def idx(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return ILU0Preconditioner(fwd, bwd, idx(order_f),
                                  idx(pos_f[order_b]), idx(pos_b), dt)

    @property
    def levels(self) -> Tuple[int, int]:
        """Levels of the forward and the backward sweep."""
        return self.fwd.n_levels, self.bwd.n_levels

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        x = self.bwd(self.fwd(v.to(self.dtype)[self.order])[self.mid])
        return x[self.out].to(v.dtype)

    matmat = __call__

    def to(self, target) -> "ILU0Preconditioner":
        if isinstance(target, torch.dtype):
            return ILU0Preconditioner(self.fwd.to(target),
                                      self.bwd.to(target), self.order,
                                      self.mid, self.out, target)
        return ILU0Preconditioner(self.fwd.to(target), self.bwd.to(target),
                                  self.order.to(target), self.mid.to(target),
                                  self.out.to(target), self.dtype)


def ilu0_preconditioner(A: DIA) -> ILU0Preconditioner:
    """M ~ A^-1 from the ILU(0) factors of a DIA (stencil) matrix; its
    packs live on A's device."""
    return ILU0Preconditioner.from_factor(A, *factor_host(A))


__all__ = ["ILU0Preconditioner", "LevelSweep", "factor_host",
           "ilu0_factor", "ilu0_preconditioner"]
