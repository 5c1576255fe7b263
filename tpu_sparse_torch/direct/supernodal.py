"""Supernodal level-scheduled sparse LU: general direct solves on the card.

The port of ``tpu_sparse/direct/supernodal.py``. The cuDSS capability class
(any square CSR, n in the hundreds of thousands, repeat solves in tens of
ms):

* **factor (host, once per matrix).** Nested-dissection ordering
  (``direct/ordering.py``), scipy SuperLU in NATURAL column order (the ND
  order is the fill-reducing order) in float64, then a block-aligned
  layout: ND parts pad to 128-row blocks so that independent subtrees
  never share a block, the block dependency DAG of each triangular factor
  collapses to ~tree height levels, and blocks sort by level. All of that
  is the JAX package's host code, unchanged, so both give the same
  levels, groups and index maps.
* **level packs (on the factor's device).** Each level's off-diagonal
  rows split into row groups of similar plane counts (``_row_groups``),
  and each group packs as one rectangular CWELL (rows_g x n_pad) by the
  port's ``csr_to_cwell`` on the card. The TPU's format choice (VMEM
  budgets, column segments, a CSR fallback, ``unroll_cap``) is gone: every
  group is one CWELL, so every level runs K4 / K5.
* **solve.** A level-scheduled substitution: per level, one ``kernels.spmv``
  per row group (K4 in float32, K5 in float64, on the cached row-compact
  plan) and one batched triangular solve of the level's 128 x 128
  diagonal blocks (``torch.linalg.solve_triangular``). An (n, k)
  right-hand side runs natively: one ``kernels.spmm`` per group (K6/K7)
  and the same triangular solve with k columns. Factors of a float64
  matrix are float64, those of a float32 matrix float32; a complex
  matrix is factored by SuperLU in complex128 and its factors, packs and
  diagonal blocks take its complex dtype (the level solve then runs the
  complex builds of K4 / K5 and K6/K7).

The JAX package applies explicit inverses of the diagonal blocks (one
matmul a level), because the TPU's batched triangular solve was
latency-bound. An explicit inverse is not backward stable: on the
general system poisson2d(512) + 0.1 triu (condition ~4e23, pivots down
to 5e-10) the inverses gave a float64 residual of 3e-2 on an NVIDIA
H100, the triangular solves 1.6e-9, what SuperLU's own solve with the
same factors gives. So the port solves with the blocks themselves.

``supernodal_solve_diff`` differentiates in b by one ``solve_transpose``
on the same factors; ``factored_solve`` adds the gradient in A's values
(-v x^T on A's pattern) and an optional refinement step, for the router.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_sparse_torch.direct.banded import full_fp32_matmul
from tpu_sparse_torch.kernels import spmm, spmv, spmv_reference
from tpu_sparse_torch.sparse.containers import CSR, values, with_values
from tpu_sparse_torch.sparse.cwell import WIN, csr_to_cwell

_BLOCK = 128  # = CWELL lane width; one diagonal block per 128 rows


def _compute_levels(bi, bj, B: int, ascending: bool):
    """Longest-path level of every block in the dependency DAG (edges
    bj -> bi). Blocks are processed in substitution order: ascending
    block index for lower-triangular factors, descending for upper."""
    level = np.zeros(B, dtype=np.int64)
    order = np.argsort(bi, kind="stable")
    bi_s, bj_s = bi[order], bj[order]
    starts = np.searchsorted(bi_s, np.arange(B))
    ends = np.searchsorted(bi_s, np.arange(B) + 1)
    rng = range(B) if ascending else range(B - 1, -1, -1)
    for i in rng:
        js = bj_s[starts[i]:ends[i]]
        if len(js):
            level[i] = 1 + level[js].max()
    return level


def _pack_operator(off, dtype: torch.dtype, device):
    """One level group's off-diagonal rows (a rows_g x n_pad scipy matrix)
    as a CWELL on ``device``, or None when the group has no entries."""
    off = off.tocsr()
    off.sort_indices()
    if off.nnz == 0:
        return None
    csr = CSR(torch.from_numpy(off.data).to(device, dtype),
              torch.from_numpy(off.indices.astype(np.int32)).to(device),
              torch.from_numpy(off.indptr.astype(np.int32)).to(device),
              off.shape)
    return csr_to_cwell(csr)


def _block_plane_est(ro, co, s):
    """Estimated CWELL planes per row block for entry lists (slot
    coordinates): per (block, 256-column window) the most entries of a
    row, summed per block. Mirrors the packer's S accounting."""
    blk = ro // s
    if len(blk) == 0:
        return np.zeros(0, np.int64)
    nwin_max = int(co.max()) // WIN + 1
    key = (blk * nwin_max + co // WIN) * s + ro % s
    uk, cnt = np.unique(key, return_counts=True)
    bw = uk // s
    grp = np.flatnonzero(np.r_[True, bw[1:] != bw[:-1]])
    maxc = np.maximum.reduceat(cnt, grp)
    ub = bw[grp] // nwin_max
    S_b = np.zeros(int(blk.max()) + 1, np.int64)
    np.add.at(S_b, ub, maxc)
    return S_b


def _row_groups(S_b, ratio: float = 4.0, max_groups: int = 6):
    """Split a level's blocks (slot order) into runs of similar plane
    counts. A new group starts when the within-group max/min plane ratio
    would exceed ``ratio``; the split is kept only when the estimated
    slot saving is > 1.7x (each group pads to its own max instead of the
    level max), which bounds both padding and kernel launches."""
    nb = len(S_b)
    Sb = np.maximum(S_b, 1)
    bounds = [0]
    mx = mn = Sb[0]
    for i in range(1, nb):
        v = Sb[i]
        if max(mx, v) > ratio * min(mn, v) and len(bounds) < max_groups:
            bounds.append(i)
            mx = mn = v
        else:
            mx = max(mx, v)
            mn = min(mn, v)
    bounds.append(nb)
    groups = [(bounds[i], bounds[i + 1] - bounds[i])
              for i in range(len(bounds) - 1)]
    if len(groups) == 1:
        return groups
    whole = nb * int(Sb.max())
    split = sum(g_nb * int(Sb[g0:g0 + g_nb].max()) for g0, g_nb in groups)
    return groups if whole > 1.7 * split else [(0, nb)]


def _grouped_packs(ro, co, vo, row_lev, ranges, n_levels, n_pad, dtype,
                   device, skip_level: int):
    """Per-level operators from level-mapped entries: for each level None
    (no dependencies) or a tuple of CWELLs (None for an empty group), one
    per row group, with the groups' ``(row_offset, rows)`` in ``metas``.
    ``skip_level`` is the level with no incoming dependencies (0 forward,
    n_levels - 1 reverse)."""
    import scipy.sparse as sp

    order_e = np.argsort(row_lev, kind="stable")
    ro, co, vo, row_lev = (ro[order_e], co[order_e], vo[order_e],
                           row_lev[order_e])
    lv_starts = np.searchsorted(row_lev, np.arange(n_levels))
    lv_ends = np.searchsorted(row_lev, np.arange(n_levels) + 1)
    s = _BLOCK
    packs = []
    metas = []
    for lv in range(n_levels):
        a, b = ranges[lv]
        e0, e1 = int(lv_starts[lv]), int(lv_ends[lv])
        if lv == skip_level or e1 <= e0:
            packs.append(None)
            metas.append(None)
            continue
        ro_l = ro[e0:e1] - a
        co_l, vo_l = co[e0:e1], vo[e0:e1]
        S_b = _block_plane_est(ro_l, co_l, s)
        nb_lv = (b - a) // s
        if len(S_b) < nb_lv:  # trailing blocks with no entries
            S_b = np.r_[S_b, np.zeros(nb_lv - len(S_b), np.int64)]
        ops = []
        shapes = []
        for g0, g_nb in _row_groups(S_b):
            r0, r1 = g0 * s, (g0 + g_nb) * s
            m = (ro_l >= r0) & (ro_l < r1)
            shapes.append((r0, r1 - r0))
            if not m.any():
                ops.append(None)
                continue
            sub = sp.csr_matrix((vo_l[m], (ro_l[m] - r0, co_l[m])),
                                shape=(r1 - r0, n_pad))
            ops.append(_pack_operator(sub, dtype, device))
        packs.append(tuple(ops))
        metas.append(tuple(shapes))
    return tuple(packs), tuple(metas)


def _layout_and_packs(T_coo, row_map, n_pad: int, s: int, ascending: bool,
                      dtype, device, unit_lower: bool,
                      with_transpose: bool = False):
    """Level-sort a mapped triangular factor and build its solve plan.

    Returns (diag, (packs, meta), (packs_t, meta_t), ranges, slot):
      diag     — (B, s, s) diagonal blocks in level order (triangular;
                 identity on padding slots), on ``device``
      packs    — one entry per level: None or a tuple of CWELLs (one per
                 row group) whose rows are the level's rows and whose
                 columns index the level-ordered padded vector
      packs_t  — the transpose solve's packs in the same layout (or ()):
                 the levels run in reverse with these packs and the
                 transposed diagonal blocks to solve T^T
      ranges   — (start_row, end_row) per level
      slot     — (n_pad,) int64: padded row -> level-ordered slot
    """
    B = n_pad // s
    r = row_map[T_coo.row]
    c = row_map[T_coo.col]
    v = T_coo.data
    same = (r // s) == (c // s)

    # levels on the block DAG of the off-diagonal part
    bi, bj = r[~same] // s, c[~same] // s
    level = _compute_levels(bi, bj, B, ascending)
    n_levels = int(level.max()) + 1 if B else 1

    # blocks sorted by (level, index): per-level contiguous ranges
    block_order = np.lexsort((np.arange(B), level))   # new_pos -> old_blk
    block_slot = np.empty(B, np.int64)                # old_blk -> new_pos
    block_slot[block_order] = np.arange(B)
    slot = block_slot[np.arange(n_pad) // s] * s + np.arange(n_pad) % s
    lev_sorted = level[block_order]
    counts = np.bincount(lev_sorted, minlength=n_levels)
    ends = np.cumsum(counts) * s
    starts = ends - counts * s
    ranges = tuple((int(a), int(b)) for a, b in zip(starts, ends))

    # dense diagonal blocks in level order (the order of rows inside a
    # block is kept, so each block stays triangular), in the factor's
    # dtype (float64 or complex128)
    diag = np.zeros((B, s, s), dtype=v.dtype)
    rs, cs, vs = slot[r[same]], slot[c[same]], v[same]
    diag[rs // s, rs % s, cs % s] = vs
    all_slots = np.ones(n_pad, bool)
    all_slots[slot[row_map]] = False
    pad_ids = np.nonzero(all_slots)[0]  # identity on padding slots
    diag[pad_ids // s, pad_ids % s, pad_ids % s] = 1.0
    if unit_lower:
        # real rows whose diagonal entry is implicit-unit in the factor
        real = np.zeros(n_pad, bool)
        real[slot[row_map]] = True
        have = np.zeros(n_pad, bool)
        have[rs[rs == cs]] = True
        fix = np.nonzero(real & ~have)[0]
        diag[fix // s, fix % s, fix % s] = 1.0
    diag_t = torch.from_numpy(diag).to(device, dtype)

    # per-level off-diagonal packs (rows and columns in level order)
    ro, co, vo = slot[r[~same]], slot[c[~same]], v[~same]
    packs, meta = _grouped_packs(ro, co, vo, lev_sorted[ro // s], ranges,
                                 n_levels, n_pad, dtype, device,
                                 skip_level=0)
    packs_t, meta_t = (), ()
    if with_transpose:
        packs_t, meta_t = _grouped_packs(
            co, ro, vo, lev_sorted[co // s], ranges, n_levels, n_pad,
            dtype, device, skip_level=n_levels - 1)
    return diag_t, (packs, meta), (packs_t, meta_t), ranges, slot


def _apply(A, x: torch.Tensor) -> torch.Tensor:
    """A @ x for a vector (``kernels.spmv``) or an (m, k) block
    (``kernels.spmm``)."""
    return spmv(A, x) if x.dim() == 1 else spmm(A, x)


def _level_solve(diag, packs, meta, ranges, bp, *, lower: bool,
                 transpose: bool, reverse: bool = False):
    """Level-scheduled triangular solve: y[level l] = D_l^{-1} (bp -
    N_l y)[level l], one SpMV (SpMM for an (n_pad, k) bp) per row group
    and one batched triangular solve of the level's diagonal blocks
    (``lower``: unit lower, else upper) per level; every factor entry is
    read once. ``reverse=True`` runs the levels last to first: with the
    transpose packs and ``transpose=True`` it solves T^T in the same
    layout."""
    s = diag.shape[1]
    y = torch.zeros_like(bp)
    sched = zip(ranges, packs, meta)
    if reverse:
        sched = zip(reversed(ranges), reversed(packs), reversed(meta))
    with full_fp32_matmul():
        for (a, b), groups, shapes in sched:
            if b <= a:
                continue
            seg = bp[a:b]
            if groups is not None:
                # groups partition the level's rows; an empty group
                # contributes no correction
                corr = [bp.new_zeros((rows_g,) + tuple(bp.shape[1:]))
                        if N is None else _apply(N, y)
                        for N, (_, rows_g) in zip(groups, shapes)]
                seg = seg - (corr[0] if len(corr) == 1
                             else torch.cat(corr))
            D = diag[a // s:b // s]
            if transpose:
                D = D.transpose(1, 2)
            y[a:b] = torch.linalg.solve_triangular(
                D, seg.reshape(D.shape[0], s, -1), upper=lower == transpose,
                unitriangular=lower).reshape(seg.shape)
    return y


class SupernodalLU:
    """Level-scheduled LU factors on a device (see the module docstring).
    Build with :meth:`factor`. Transpose solves reuse the forward layouts:
    the level schedule runs in reverse with the transposed packs and the
    transposed diagonal blocks (no second copy of the blocks)."""

    def __init__(self, diagL, diagU, packsL, packsU, packsLT, packsUT,
                 in_idx, mid_idx, out_idx, in_idx_t, mid_idx_t, out_idx_t,
                 rangesL, rangesU, metaL, metaU, metaLT, metaUT,
                 shape: Tuple[int, int], block: int = _BLOCK):
        self.diagL, self.diagU = diagL, diagU
        self.packsL, self.packsU = packsL, packsU
        self.packsLT, self.packsUT = packsLT, packsUT
        self.in_idx, self.mid_idx, self.out_idx = in_idx, mid_idx, out_idx
        self.in_idx_t, self.mid_idx_t = in_idx_t, mid_idx_t
        self.out_idx_t = out_idx_t
        self.rangesL, self.rangesU = rangesL, rangesU
        self.metaL, self.metaU = metaL, metaU
        self.metaLT, self.metaUT = metaLT, metaUT
        self.shape = tuple(int(x) for x in shape)
        self.block = int(block)

    @property
    def n_pad(self) -> int:
        return self.diagL.shape[0] * self.diagL.shape[1]

    @property
    def n_levels(self) -> int:
        return max(len(self.rangesL), len(self.rangesU))

    @property
    def has_transpose(self) -> bool:
        return len(self.packsUT) > 0

    # -- set-up (host) -----------------------------------------------------

    @staticmethod
    def factor(A, block: int = _BLOCK, leaf: int = 896,
               with_transpose: bool = True) -> "SupernodalLU":
        """Factor a square sparse matrix; the factors live on A's device.
        ``with_transpose=False`` skips the transpose solve's packs (half
        the off-diagonal pack memory; ``solve_transpose`` then raises).
        Raises scipy's RuntimeError for a singular matrix."""
        import scipy.sparse.linalg as spl

        from tpu_sparse_torch.direct.ordering import (aligned_row_map,
                                                      nested_dissection)
        from tpu_sparse_torch.sparse.convert import to_scipy_csr

        n, m = A.shape
        if n != m:
            raise ValueError("SupernodalLU requires a square system")
        device = A.device
        dtype = A.dtype
        if not (dtype.is_floating_point or dtype.is_complex):
            dtype = torch.float64
        A_sp = to_scipy_csr(A).astype(np.complex128 if dtype.is_complex
                                      else np.float64)
        sigma, part_sizes = nested_dissection(A_sp, leaf=leaf)
        Ap = A_sp[sigma][:, sigma].tocsc()
        lu = spl.splu(Ap, permc_spec="NATURAL", diag_pivot_thresh=0.1,
                      options=dict(SymmetricMode=True))

        s = block
        row_map, n_pad = aligned_row_map(part_sizes, s)
        Lc, Uc = lu.L.tocoo(), lu.U.tocoo()
        perm_r = np.asarray(lu.perm_r, dtype=np.int64)
        perm_c = np.asarray(lu.perm_c, dtype=np.int64)

        diagL, (packsL, metaL), (packsLT, metaLT), rangesL, slotL = \
            _layout_and_packs(Lc, row_map, n_pad, s, True, dtype, device,
                              unit_lower=True, with_transpose=with_transpose)
        diagU, (packsU, metaU), (packsUT, metaUT), rangesU, slotU = \
            _layout_and_packs(Uc, row_map, n_pad, s, False, dtype, device,
                              unit_lower=False,
                              with_transpose=with_transpose)

        # index plumbing. The permuted system is Ap x' = b' with
        # b'_i = b[sigma_i], x[sigma_i] = x'_i; splu wants
        # bp[perm_r[i]] = b'_i and returns x'_i = z[perm_c[i]]. With sigma
        # folded in: bp_L[in_idx[k]] = b[k] and x[k] = z_U[out_idx[k]].
        in_scatter = np.empty(n, np.int64)
        in_scatter[sigma] = slotL[row_map[perm_r]]
        mid = np.zeros(n_pad, np.int64)
        mid[slotU[row_map]] = slotL[row_map]
        out_scatter = np.empty(n, np.int64)
        out_scatter[sigma] = slotU[row_map[perm_c]]
        # transpose solve: U^T first (U layout), then L^T (L layout)
        in_scatter_t = np.empty(n, np.int64)
        in_scatter_t[sigma] = slotU[row_map[perm_c]]
        mid_t = np.zeros(n_pad, np.int64)
        mid_t[slotL[row_map]] = slotU[row_map]
        out_scatter_t = np.empty(n, np.int64)
        out_scatter_t[sigma] = slotL[row_map[perm_r]]

        def idx(a):
            return torch.from_numpy(a).to(device)

        return SupernodalLU(
            diagL, diagU, packsL, packsU, packsLT, packsUT,
            idx(in_scatter), idx(mid), idx(out_scatter),
            idx(in_scatter_t), idx(mid_t), idx(out_scatter_t),
            rangesL, rangesU, metaL, metaU, metaLT, metaUT, (n, n), block=s)

    # -- solves (device) ---------------------------------------------------

    def _scatter(self, b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        bp = self.diagL.new_zeros((self.n_pad,) + tuple(b.shape[1:]))
        bp[idx] = b.to(bp.dtype)
        return bp

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^-1 b for b of shape (n,) or (n, k)."""
        y = _level_solve(self.diagL, self.packsL, self.metaL, self.rangesL,
                         self._scatter(b, self.in_idx), lower=True,
                         transpose=False)
        z = _level_solve(self.diagU, self.packsU, self.metaU, self.rangesU,
                         y[self.mid_idx], lower=False, transpose=False)
        return z[self.out_idx].to(b.dtype)

    def solve_transpose(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^-T b with the same factors (the adjoint solve)."""
        if not self.has_transpose:
            raise ValueError("factored with with_transpose=False: adjoint "
                             "solves unavailable")
        w = _level_solve(self.diagU, self.packsUT, self.metaUT, self.rangesU,
                         self._scatter(b, self.in_idx_t), lower=False,
                         transpose=True, reverse=True)
        y = _level_solve(self.diagL, self.packsLT, self.metaLT, self.rangesL,
                         w[self.mid_idx_t], lower=True, transpose=True,
                         reverse=True)
        return y[self.out_idx_t].to(b.dtype)


def supernodal_solve(lu: SupernodalLU, b: torch.Tensor) -> torch.Tensor:
    """Functional alias: x = A^-1 b."""
    return lu.solve(b)


def _solve_adjoint(lu, g: torch.Tensor) -> torch.Tensor:
    """A^-H g by the factors' transpose solve: conj(A^-T conj(g)) for a
    complex g (torch's gradient convention), A^-T g for a real one."""
    if g.is_complex():
        return lu.solve_transpose(g.conj()).conj()
    return lu.solve_transpose(g)


class _FactoredSolve(torch.autograd.Function):
    """x = lu.solve(b), plus with ``refine`` one refinement step
    x += lu.solve(b - A x). Backward: v = A^-H x_bar by the factors'
    transpose solve (refined on A^H likewise), b_bar = v and, when A's
    values require grad, A_bar = -v x^H on A's pattern (the plain SpMV's
    vector-Jacobian product, as ``autodiff.implicit``)."""

    @staticmethod
    def forward(ctx, lu, A, refine, a_vals, b):
        b = b.detach()
        if a_vals is not None:
            A = with_values(A, a_vals.detach())
        x = lu.solve(b)
        if refine:
            x = x + lu.solve(b - _apply(A, x))
        ctx.lu, ctx.A, ctx.refine = lu, A, refine
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        from tpu_sparse_torch.autodiff.implicit import _adjoint_matrix

        (x,) = ctx.saved_tensors
        g = x_bar.contiguous()
        v = _solve_adjoint(ctx.lu, g)
        if ctx.refine:
            At = _adjoint_matrix(ctx.A, False)
            v = v + _solve_adjoint(ctx.lu, g - _apply(At, v))
        grad_a = None
        if ctx.needs_input_grad[3]:
            with torch.enable_grad():
                a = values(ctx.A).detach().requires_grad_()
                y = spmv_reference(with_values(ctx.A, a), x)
                (grad_a,) = torch.autograd.grad(y, a, grad_outputs=-v)
        return (None, None, None, grad_a,
                v if ctx.needs_input_grad[4] else None)


def factored_solve(lu, A, b: torch.Tensor, refine: bool = False
                   ) -> torch.Tensor:
    """x = A^-1 b by the factors ``lu`` of A (any object with ``solve`` and
    ``solve_transpose``), differentiable in b and A's values (each
    backward one transpose solve; two with ``refine``). ``refine`` adds
    one iterative-refinement step on A (one SpMV and one solve)."""
    a_vals = values(A) if A is not None else None
    return _FactoredSolve.apply(lu, A, refine, a_vals, b)


def supernodal_solve_diff(lu: SupernodalLU, b: torch.Tensor
                          ) -> torch.Tensor:
    """x = A^-1 b, differentiable in b: the backward runs one adjoint
    solve with the same factors (reference contract
    cudss_solver.py:115-148)."""
    return factored_solve(lu, None, b)


__all__ = ["SupernodalLU", "factored_solve", "supernodal_solve",
           "supernodal_solve_diff"]
