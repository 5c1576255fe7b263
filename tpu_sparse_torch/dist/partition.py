"""Row partitioning of sparse operands over a ``RowMesh``.

Counterpart of ``tpu_sparse/dist/partition.py``. Every rank holds the
whole operand when it calls these functions (the same matrix, built the
same way: a generator, a file) and keeps its own rows:

* a DIA matrix pads with identity rows to a multiple of the world size,
  and rank r keeps the contiguous ``(ndiag, s)`` slice of ``data`` for its
  rows [r s, (r + 1) s) (``shard_dia``): its SpMV needs only a halo of
  width ``bandwidth`` from each neighbour;
* a general matrix pads to a multiple of ``world_size * 128`` (CWELL's
  row-block height) and is packed whole by the port's ``csr_to_cwell`` on
  every rank (deterministic, the same bytes everywhere); each rank
  computes the same halo plan from the whole pack and keeps only its own
  row blocks (``shard_general_planned``);
* vectors pad with zeros and rank r keeps its rows (``shard_vector``);
  ``gather_vector`` assembles the whole vector again.

The identity padding leaves the solution of the padded system zero on the
added coordinates (their right-hand side is zero), so the padded solve
gives the original solution on the original rows. The port packs CWELL
with ``group=1``; JAX's ``AUTO_GROUP`` is a TPU tuning heuristic the port
does not carry (ROADMAP "Not to port").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from tpu_sparse_torch.dist.mesh import RowMesh
from tpu_sparse_torch.sparse.containers import DIA
from tpu_sparse_torch.sparse.cwell import LW, CWELL, csr_to_cwell


def _pad_rows_to(n: int, n_dev: int) -> int:
    return ((n + n_dev - 1) // n_dev) * n_dev


def pad_dia(A: DIA, n_dev: int) -> DIA:
    """Pad a square DIA matrix with identity rows so n divides the world
    size (the padding rows keep only a unit diagonal)."""
    n, _ = A.shape
    n_pad = _pad_rows_to(n, n_dev)
    if n_pad == n:
        return A
    offsets = A.offsets if 0 in A.offsets else A.offsets + (0,)
    data = A.data.new_zeros((len(offsets), n_pad))
    for d, o in enumerate(offsets):
        if o in A.offsets:
            data[d, :n] = A.data[A.offsets.index(o), :n]
        if o == 0:
            data[d, n:] = 1.0
    return DIA(data, offsets, (n_pad, n_pad))


def pad_vector(b: torch.Tensor, n_dev: int, unit: int = 1) -> torch.Tensor:
    """Pad b (rows; an (n, k) block pads its rows) with zeros to a
    multiple of ``n_dev * unit`` (unit 128 for CWELL row blocks)."""
    n = b.shape[0]
    n_pad = _pad_rows_to(n, n_dev * unit)
    if n_pad == n:
        return b
    return torch.cat([b, b.new_zeros((n_pad - n,) + tuple(b.shape[1:]))])


def pad_csr_identity(A, n_pad: int):
    """Extend a square system to n_pad rows and columns with a unit
    diagonal: a CSR on A's device (built on the host by scipy when rows
    are added)."""
    from tpu_sparse_torch.sparse.containers import values
    from tpu_sparse_torch.sparse.convert import (csr_from_arrays, numpy_dtype,
                                                 to_csr, to_scipy_csr)

    n, m = A.shape
    if n != m:
        raise ValueError("distributed solves need a square system")
    if n_pad == n:
        return to_csr(A)
    A_sp = to_scipy_csr(A)
    pad = sp.identity(n_pad - n, dtype=A_sp.dtype, format="csr")
    A_sp = sp.block_diag([A_sp, pad], format="csr")
    dtype = A.dtype if isinstance(A, torch.Tensor) else values(A).dtype
    return csr_from_arrays(A_sp.data.astype(numpy_dtype(dtype), copy=False),
                           A_sp.indices, A_sp.indptr, (n_pad, n_pad),
                           device=A.device, dtype=dtype)


class ShardedDIA:
    """This rank's rows of a row-partitioned (padded) DIA matrix:
    ``data`` is the contiguous (ndiag, s) slice for rows [i0, i0 + s) of
    the global ``shape``."""

    def __init__(self, data: torch.Tensor, offsets, shape, i0: int):
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(v) for v in shape)
        self.i0 = int(i0)

    @property
    def rows(self) -> int:
        return int(self.data.shape[1])

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    @property
    def dtype(self):
        return self.data.dtype

    def __repr__(self):
        return (f"ShardedDIA(shape={self.shape}, rows=[{self.i0}, "
                f"{self.i0 + self.rows}), offsets={self.offsets})")


class ShardedCWELL:
    """This rank's row blocks of a row-partitioned CWELL pack: ``W`` is a
    (rows, m) CWELL of the rank's blocks whose srow indexes the global x
    (shape ``(nb_loc * 128, n)``), ``shape`` the global (padded) shape."""

    def __init__(self, W: CWELL, shape, i0: int):
        self.W = W
        self.shape = tuple(int(v) for v in shape)
        self.i0 = int(i0)

    @property
    def dtype(self):
        return self.W.dtype

    def __repr__(self):
        return (f"ShardedCWELL(shape={self.shape}, first row {self.i0}, "
                f"S={self.W.planes})")


def shard_dia(A: DIA, mesh: RowMesh) -> ShardedDIA:
    """This rank's rows of A (padded to the world size), contiguous on
    the mesh's device. No bandwidth constraint: when the bandwidth exceeds
    the shard the SpMV takes the all_gather route."""
    A = pad_dia(A, mesh.world_size)
    n = A.shape[0]
    s = n // mesh.world_size
    i0 = mesh.rank * s
    data = A.data[:, i0:i0 + s].to(mesh.device).contiguous()
    return ShardedDIA(data, A.offsets, A.shape, i0)


def shard_vector(b: torch.Tensor, mesh: RowMesh, unit: int = 1
                 ) -> torch.Tensor:
    """This rank's rows of b (zero-padded to ``world_size * unit``), a
    contiguous tensor on the mesh's device; b may be (n,) or (n, k)."""
    b = pad_vector(b, mesh.world_size, unit)
    s = b.shape[0] // mesh.world_size
    return b[mesh.rank * s:(mesh.rank + 1) * s].to(mesh.device).contiguous()


def local_rows(n: int, mesh: RowMesh, unit: int = 1) -> int:
    """Rows per rank of an n-row operand padded for ``unit``."""
    return _pad_rows_to(n, mesh.world_size * unit) // mesh.world_size


def own_rows(n: int, mesh: RowMesh, unit: int = 1) -> int:
    """How many of this rank's padded rows lie below n (the rows a solver
    returns)."""
    s = local_rows(n, mesh, unit)
    return max(0, min(s, n - mesh.rank * s))


def gather_vector(x_local: torch.Tensor, mesh: RowMesh, n: int
                  ) -> torch.Tensor:
    """The whole vector of length n from every rank's own rows, on every
    rank (an all_gather of the row counts, then of the padded rows)."""
    counts = mesh.all_gather(torch.tensor(
        [x_local.shape[0]], dtype=torch.int64, device=x_local.device))
    counts = [int(c) for c in counts.tolist()]
    s = max(counts)
    pad = x_local.new_zeros((s - x_local.shape[0],)
                            + tuple(x_local.shape[1:]))
    full = mesh.all_gather(torch.cat([x_local, pad]))
    parts = [full[r * s:r * s + c] for r, c in enumerate(counts)]
    out = torch.cat(parts)
    if out.shape[0] != n:
        raise ValueError(f"the ranks hold {out.shape[0]} rows, not {n}")
    return out


def _general_pack(A, mesh: RowMesh) -> CWELL:
    """The whole padded CWELL pack of a general square matrix on the
    mesh's device (A itself when it is a CWELL that already divides)."""
    n_dev = mesh.world_size
    if isinstance(A, CWELL):
        n, m = A.shape
        if n == m and n % (n_dev * LW) == 0 and A.n_blocks % n_dev == 0:
            return A.to(mesh.device)
    n_pad = _pad_rows_to(A.shape[0], n_dev * LW)
    Ac = pad_csr_identity(A, n_pad).to(mesh.device)
    return csr_to_cwell(Ac)


def _own_blocks(W: CWELL, mesh: RowMesh, srow: Optional[torch.Tensor],
                m: int) -> CWELL:
    nb_loc = W.n_blocks // mesh.world_size
    b0 = mesh.rank * nb_loc
    sl = slice(b0, b0 + nb_loc)
    srow = W.srow[sl] if srow is None else srow
    return CWELL(W.vals[sl].contiguous(), W.idx2[sl].contiguous(),
                 srow.contiguous(), (nb_loc * LW, m), group=W.group)


def shard_general(A, mesh: RowMesh) -> ShardedCWELL:
    """Row-shard a general square matrix as CWELL blocks (all_gather
    SpMV: no locality assumption)."""
    W = _general_pack(A, mesh)
    n = W.shape[0]
    s = n // mesh.world_size
    return ShardedCWELL(_own_blocks(W, mesh, None, n), W.shape,
                        mesh.rank * s)


def shard_general_planned(A, mesh: RowMesh):
    """Row-shard a general matrix and plan its halo exchange from the
    whole pack, which every rank holds and plans identically. Returns
    ``(W_sharded, HaloCWELL or None)``; the plan is None when the
    exchange would not beat the all_gather."""
    from tpu_sparse_torch.dist.spmv import HaloCWELL, plan_halo_host

    W = _general_pack(A, mesh)
    n = W.shape[0]
    s = n // mesh.world_size
    i0 = mesh.rank * s
    W_sh = ShardedCWELL(_own_blocks(W, mesh, None, n), W.shape, i0)
    srow_np = W.srow.cpu().numpy()
    used_np = (W.vals != 0).any(dim=2).cpu().numpy()
    plan = plan_halo_host(srow_np, used_np, W.shape, mesh.world_size)
    del W
    if plan is None:
        return W_sh, None
    wl, wr, srow_l = plan
    nb_loc = W_sh.W.n_blocks
    b0 = mesh.rank * nb_loc
    srow_own = torch.from_numpy(
        np.ascontiguousarray(srow_l[b0:b0 + nb_loc])).to(mesh.device)
    Wsh = W_sh.W
    W_l = CWELL(Wsh.vals, Wsh.idx2, srow_own, (nb_loc * LW, wl + s + wr),
                group=Wsh.group)
    return W_sh, HaloCWELL(W_l, wl, wr, W_sh.shape, i0)


__all__ = ["pad_dia", "pad_vector", "pad_csr_identity", "ShardedDIA",
           "ShardedCWELL", "shard_dia", "shard_vector", "local_rows",
           "own_rows", "gather_vector", "shard_general",
           "shard_general_planned"]
