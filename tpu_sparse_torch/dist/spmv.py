"""Distributed SpMV over a ``RowMesh``: explicit halo exchange, or an
all_gather of x, then the hand-written local kernel on the rank's rows.

Counterpart of ``tpu_sparse/dist/spmv.py`` (shard_map + ppermute there).
Every SpMV takes this rank's rows of x (an (s,) vector, or an (s, k)
block for block CG) and returns this rank's rows of A x:

* **DIA halo** (``make_halo_spmv``): the w-wide boundary strips go to the
  ranks r - 1 and r + 1 in one ``batch_isend_irecv`` (the edge ranks post
  fewer ops and keep zeros) and land in the margins of the extended
  vector of ``cuda_spmv.ExtendedStencilOperator``'s layout
  ``[margin | x_local | margin]`` (margins ``Wl = roundup(w, 32)``, each
  strip next to the local segment, the rest of the margin zero); kernel 1
  in extended mode computes the rank's rows on the card, its plain
  version (``apply_plain``) on the CPU. An (s, k) block takes the plain
  DIA SpMM (``reference.dia_spmm``, which JAX left to XLA) on the
  extended block.
* **DIA all_gather** (``make_allgather_spmv``, bandwidth above the shard):
  x is gathered, the window ``[i0 - Wl, i0 + s + Wl)`` cut out (zero past
  the ends) and the same kernel run.
* **CWELL halo** (``make_cwell_halo_spmv``): multi-hop strips (hop k sends
  ``min(s, wl - (k - 1) s)`` entries, so the receive volume is the
  partition cut ``wl + wr``) into ``[left | x_local | right]``, then K4 /
  K5 (SpMV) or K6 / K7 (SpMM) on the rank's pack, whose srow was shifted
  into that local frame (``plan_halo_host``).
* **CWELL all_gather** (``make_cwell_allgather_spmv``): x gathered, then
  the same kernels on the rank's blocks of the global pack.

The halo exchange runs before the local product; overlapping it with the
interior rows is ROADMAP queue 2c's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpu_sparse_torch.dist.mesh import RowMesh
from tpu_sparse_torch.dist.partition import ShardedCWELL, ShardedDIA
from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.kernels.cuda_spmv import (MARGIN_ALIGN,
                                                ExtendedStencilOperator,
                                                _round_up)
from tpu_sparse_torch.sparse.containers import DIA
from tpu_sparse_torch.sparse.cwell import LW, CWELL


class LocalExtendedOperator(ExtendedStencilOperator):
    """Kernel 1's extended mode on one rank's rows: ``data`` (ndiag, s),
    vectors of length ``2 Wl + s`` holding the neighbours' strips in
    their margins (the bandwidth may reach s, or pass it on the all_gather
    route, since the margins hold real values)."""

    def __init__(self, A_sh: ShardedDIA):
        if not A_sh.offsets:
            raise ValueError("a distributed DIA needs at least one diagonal")
        w = max(A_sh.bandwidth, 1)
        self.n = A_sh.rows
        self.offsets = A_sh.offsets
        self.Wl = _round_up(w, MARGIN_ALIGN)
        self.E = 2 * self.Wl + self.n
        self.data = A_sh.data.contiguous()
        self.dtype = A_sh.data.dtype
        self.device = A_sh.data.device

    def apply_block(self, X_ext: torch.Tensor) -> torch.Tensor:
        """(s, k) rows of A X from an extended (E, k) block: the plain DIA
        SpMM on the extended frame."""
        shifted = DIA(self.data, tuple(o + self.Wl for o in self.offsets),
                      (self.n, self.E))
        return ref.dia_spmm(shifted, X_ext)

    def product(self, x_ext: torch.Tensor) -> torch.Tensor:
        if x_ext.dim() == 2:
            return self.apply_block(x_ext)
        return self.extract(self(x_ext))


def _check_x(x: torch.Tensor, rows: int, mesh: RowMesh, dtype) -> None:
    mesh.check(x)
    if x.shape[0] != rows or x.dim() not in (1, 2):
        raise ValueError(f"expected this rank's {rows} rows (a vector or an "
                         f"(s, k) block), got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"x is {x.dtype}, the operator {dtype}")


def _halo_fill(ext: torch.Tensor, x: torch.Tensor, off: int, wl: int,
               wr: int, mesh: RowMesh) -> None:
    """Put x at ``ext[off:off + s]`` and the neighbours' strips around it:
    the left frame ``[off - wl, off)`` from ranks r - 1, r - 2, ... (hop k
    brings ``min(s, wl - (k - 1) s)`` entries: the tail of rank r - k's
    rows), the right frame ``[off + s, off + s + wr)`` likewise from the
    heads of ranks r + 1, r + 2, .... Entries no rank supplies stay zero.
    One ``batch_isend_irecv`` for all hops and both directions."""
    s = x.shape[0]
    r, nd = mesh.rank, mesh.world_size
    ext[off:off + s] = x
    sends, recvs, hops = [], [], []
    row_bytes = x[:1].numel() * x.element_size()
    for k in range(1, -(-wl // s) + 1):
        amt = min(s, wl - (k - 1) * s)
        hops.append((k, amt * row_bytes))
        if r + k < nd:
            sends.append((x[s - amt:], r + k))
        if r - k >= 0:
            end = off - (k - 1) * s
            recvs.append((ext[end - amt:end], r - k))
    for k in range(1, -(-wr // s) + 1):
        amt = min(s, wr - (k - 1) * s)
        hops.append((k, amt * row_bytes))
        if r - k >= 0:
            sends.append((x[:amt], r - k))
        if r + k < nd:
            start = off + s + (k - 1) * s
            recvs.append((ext[start:start + amt], r + k))
    mesh.exchange(sends, recvs, hops)


def make_halo_spmv(A_sh: ShardedDIA, mesh: RowMesh
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x_local -> this rank's rows of A x with a one-hop halo exchange of
    width ``bandwidth`` (which must not pass the shard)."""
    op = LocalExtendedOperator(A_sh)
    w = max(A_sh.bandwidth, 1)
    s = A_sh.rows
    if w > s:
        raise ValueError(f"bandwidth {w} passes the shard of {s} rows: use "
                         f"the all_gather SpMV")

    def spmv_fn(x: torch.Tensor) -> torch.Tensor:
        _check_x(x, s, mesh, op.dtype)
        ext = x.new_zeros((op.E,) + tuple(x.shape[1:]))
        _halo_fill(ext, x, op.Wl, w, w, mesh)
        return op.product(ext)

    return spmv_fn


def make_allgather_spmv(A_sh: ShardedDIA, mesh: RowMesh
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x_local -> this rank's rows of A x through an all_gather of x and
    the window ``[i0 - Wl, i0 + s + Wl)`` of it (for bandwidths above the
    shard)."""
    op = LocalExtendedOperator(A_sh)
    s, i0, n = A_sh.rows, A_sh.i0, A_sh.shape[1]

    def spmv_fn(x: torch.Tensor) -> torch.Tensor:
        _check_x(x, s, mesh, op.dtype)
        x_full = mesh.all_gather(x)
        ext = x.new_zeros((op.E,) + tuple(x.shape[1:]))
        lo, hi = max(0, i0 - op.Wl), min(n, i0 + s + op.Wl)
        ext[lo - (i0 - op.Wl):hi - (i0 - op.Wl)] = x_full[lo:hi]
        return op.product(ext)

    return spmv_fn


def halo_dia_spmv(A_sh: ShardedDIA, x: torch.Tensor,
                  mesh: RowMesh) -> torch.Tensor:
    """One-shot distributed SpMV (see ``make_halo_spmv``)."""
    return make_halo_spmv(A_sh, mesh)(x)


class HaloCWELL:
    """A rank's CWELL row blocks plus its halo-exchange plan: ``W`` is
    the local pack of shape ``(nb_loc * 128, wl + s + wr)`` whose srow is
    shifted into the local frame ``[i0 - wl, i0 + s + wr)``; ``shape`` the
    global (padded) shape, ``i0`` the rank's first row."""

    def __init__(self, W: CWELL, wl: int, wr: int, shape, i0: int):
        self.W = W
        self.wl = int(wl)
        self.wr = int(wr)
        self.shape = tuple(int(v) for v in shape)
        self.i0 = int(i0)

    @property
    def dtype(self):
        return self.W.dtype

    def __repr__(self):
        return (f"HaloCWELL(shape={self.shape}, wl={self.wl}, wr={self.wr}, "
                f"S={self.W.planes})")


def plan_halo_host(srow_np, used_np, shape, n_dev: int):
    """Pure host-side halo planner on CWELL pack metadata.

    ``srow_np``/``used_np`` are the (n_blocks, S) window-start and
    plane-has-nnz arrays of the UNSHARDED pack; every rank computes the
    identical plan from its own host copy (deterministic numpy). Returns
    ``(wl, wr, srow_local)`` or ``None`` when the exchange would not beat
    all_gather (hops spanning the whole ring, or cut volume ~n)."""
    n, m = shape
    n_blocks = srow_np.shape[0]
    if n != m or n_blocks % n_dev != 0 or not used_np.any():
        return None
    s = n // n_dev
    nb_loc = n_blocks // n_dev
    wl = wr = 0
    for d in range(n_dev):
        blk = slice(d * nb_loc, (d + 1) * nb_loc)
        u = used_np[blk]
        if not u.any():
            continue
        sr = srow_np[blk][u]
        lo = int(sr.min()) * LW
        hi = (int(sr.max()) + 2) * LW
        wl = max(wl, d * s - lo)
        wr = max(wr, hi - (d + 1) * s)
    wl = max(0, -(-wl // LW) * LW)
    wr = max(0, -(-wr // LW) * LW)
    # halo hops stay within the ring, and the exchange must actually be
    # cheaper than gathering the rest of x — otherwise keep all_gather
    hops_l, hops_r = -(-wl // s), -(-wr // s)
    if max(hops_l, hops_r) >= n_dev or wl + wr >= (n - s):
        return None
    # shift srow into each device's local frame [d*s - wl, (d+1)*s + wr)
    dev_of_block = np.repeat(np.arange(n_dev), nb_loc)
    shift = (dev_of_block * s - wl) // LW   # (n_blocks,)
    srow_l = srow_np - shift[:, None]
    hi_clamp = (wl + s + wr) // LW - 2
    srow_l = np.clip(srow_l, 0, max(hi_clamp, 0)).astype(srow_np.dtype)
    return wl, wr, srow_l


def plan_cwell_halo(W_sh: ShardedCWELL, mesh: RowMesh
                    ) -> Optional[HaloCWELL]:
    """Halo plan of an already-sharded CWELL: the ranks all_gather their
    blocks' srow and plane-use metadata, plan the whole pack as
    ``plan_halo_host`` does, and keep their own shifted srow. None when
    the exchange would not beat the all_gather."""
    W = W_sh.W
    srow = mesh.all_gather(W.srow).cpu().numpy()
    used = mesh.all_gather((W.vals != 0).any(dim=2).to(torch.uint8))
    plan = plan_halo_host(srow, used.cpu().numpy().astype(bool), W_sh.shape,
                          mesh.world_size)
    if plan is None:
        return None
    wl, wr, srow_l = plan
    nb_loc = W.n_blocks
    b0 = mesh.rank * nb_loc
    s = W_sh.shape[0] // mesh.world_size
    srow_own = torch.from_numpy(np.ascontiguousarray(
        srow_l[b0:b0 + nb_loc])).to(W.srow.device)
    W_l = CWELL(W.vals, W.idx2, srow_own, (nb_loc * LW, wl + s + wr),
                group=W.group)
    return HaloCWELL(W_l, wl, wr, W_sh.shape, W_sh.i0)


def _cwell_product(W: CWELL, x: torch.Tensor) -> torch.Tensor:
    """K4/K5 (vector) or K6/K7 (block) on the card, the plain versions on
    the CPU (``kernels.spmv`` / ``spmm``)."""
    from tpu_sparse_torch.kernels import spmm, spmv

    return spmm(W, x) if x.dim() == 2 else spmv(W, x)


def make_cwell_halo_spmv(H: HaloCWELL, mesh: RowMesh
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x_local -> this rank's rows of A x for a halo-planned CWELL: the
    multi-hop exchange of the partition cut, then the local kernel on
    ``[left | x_local | right]``."""
    s = H.shape[0] // mesh.world_size
    m_loc = H.wl + s + H.wr

    def spmv_fn(x: torch.Tensor) -> torch.Tensor:
        _check_x(x, s, mesh, H.dtype)
        ext = x.new_zeros((m_loc,) + tuple(x.shape[1:]))
        _halo_fill(ext, x, H.wl, H.wl, H.wr, mesh)
        return _cwell_product(H.W, ext)[:s]

    return spmv_fn


def make_cwell_allgather_spmv(W_sh: ShardedCWELL, mesh: RowMesh
                              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x_local -> this rank's rows of A x for a general matrix: all_gather
    x, then the local kernel on the rank's blocks of the global pack."""
    s = W_sh.shape[0] // mesh.world_size

    def spmv_fn(x: torch.Tensor) -> torch.Tensor:
        _check_x(x, s, mesh, W_sh.dtype)
        return _cwell_product(W_sh.W, mesh.all_gather(x))[:s]

    return spmv_fn


__all__ = ["LocalExtendedOperator", "make_halo_spmv", "make_allgather_spmv",
           "halo_dia_spmv", "HaloCWELL", "plan_halo_host", "plan_cwell_halo",
           "make_cwell_halo_spmv", "make_cwell_allgather_spmv"]
