"""Aggregation algebraic multigrid: the port of ``tpu_sparse/precond/amg.py``.

Capability target: the reference's Module B AMG configuration
(torch_amgx.py:47-99): AGGREGATION coarsening with the SIZE_4 selector,
the JACOBI_L1 smoother with 0 pre- / 3 post-sweeps, at most 50 levels and
a deterministic set-up.

* **Set-up on the host**, once per matrix: strength of connection, greedy
  aggregation, the tentative prolongator and the Galerkin products, in the
  port's host C++ (``csrc/host/amg_setup.cc`` through ``_native``) by
  default, or in scipy with ``use_native=False``. The scipy path copies
  JAX's, including its fault on 27-point stencils (ROADMAP R7: it merges
  singletons only with strength-graph neighbours, so with theta 0.08 it
  makes no coarse level there). The coarsest operator's pseudo-inverse is
  numpy's ``pinv`` on the host.
* **Level operators on the device**. On the card (JAX's device branch,
  ``_pack_level_op`` / ``_pack_tentative_p``): a level of at most 3072
  rows and columns is a dense matrix; a larger one goes through
  ``to_gpu_operator(..., min_cwell_fill=0.04)`` to DIA or CWELL, so its
  products run kernel 1 / K3 or K4 / K5 (K6 / K7 on a block); the
  tentative prolongator is a CWELL as well. Elsewhere the levels stay CSR
  and the tentative prolongator is a gather (``TentativeP``), as in JAX off
  the TPU. The finest level is the caller's operand.
* **Solve phase**: ``v_cycle`` on a vector or an (n, k) block (every
  level then runs one SpMM), ``AMGPreconditioner`` as an ``M=``,
  ``amg_stationary_solve`` and ``amg_solve`` (CG with the V-cycle).
  On the card an ``AMGPreconditioner`` replays its cycle as a CUDA graph
  kept on the hierarchy (``_cycle_on_card``): one launch from the host in
  place of the ~16 kernels and torch ops a level that ``v_cycle``
  enqueues, the same kernels in the same order.

The hierarchy is a plain object holding tensors; ``.to(device)`` moves it
and ``.to(dtype)`` casts its values (the mixed-precision solvers cast an
``M`` that has ``.to``). ``amg_hierarchy_from_numpy`` builds one from
another hierarchy's arrays, so a test can run the port's V-cycle on JAX's
levels.
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import as_matvec, spmm, spmv, spmv_reference
from tpu_sparse_torch.sparse.containers import (CSR, is_sparse, values,
                                                with_values)
from tpu_sparse_torch.sparse.convert import (csr_from_arrays, dia_from_numpy,
                                             numpy_dtype, to_scipy_csr)
from tpu_sparse_torch.utils.opcache import _leaves

# Applies on the card by how they ran: replaying a captured cycle,
# capturing one, or eager (``v_cycle``; a key's first apply included).
PRECOND = tracing.group("precond", {"graph_captures": 0,
                                    "graph_replays": 0, "graph_eager": 0})

# ---------------------------------------------------------------------------
# Host-side set-up
# ---------------------------------------------------------------------------


def _l1_row_sums(A_sp: sp.csr_matrix, use_native: bool) -> np.ndarray:
    """Row sums of |A| without materializing abs(A)."""
    if use_native and A_sp.data.dtype == np.float64 \
            and A_sp.indptr.dtype == np.int32:
        from tpu_sparse_torch.precond import _native

        return _native.l1_row_norms(A_sp.indptr, A_sp.data)
    absdata = np.abs(A_sp.data)
    counts = np.diff(A_sp.indptr)
    if absdata.size == 0:
        return np.zeros(A_sp.shape[0], dtype=np.float64)
    starts = np.minimum(A_sp.indptr[:-1], absdata.size - 1)
    dl1 = np.add.reduceat(absdata, starts)
    dl1[counts == 0] = 0.0
    return dl1


def _strength_graph(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength of connection: keep a_ij with
    |a_ij| >= theta * sqrt(|a_ii a_jj|)."""
    d = np.abs(A.diagonal())
    d_safe = np.where(d > 0, d, 1.0)
    coo = A.tocoo()
    scale = np.sqrt(d_safe[coo.row] * d_safe[coo.col])
    keep = (np.abs(coo.data) >= theta * scale) & (coo.row != coo.col)
    S = sp.csr_matrix(
        (np.ones(keep.sum()), (coo.row[keep], coo.col[keep])), shape=A.shape)
    return S.maximum(S.T)  # symmetrize


def _aggregate(S: sp.csr_matrix, target_size: int = 4) -> np.ndarray:
    """Greedy aggregation with a target aggregate size (SIZE_4-like).

    Deterministic: nodes visited in index order. Returns the aggregate id
    of every node."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    next_agg = 0
    # phase 1: seed aggregates from fully unaggregated neighbourhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        free = nbrs[agg[nbrs] == -1]
        agg[i] = next_agg
        agg[free[: target_size - 1]] = next_agg
        next_agg += 1
    # phase 2: merge singleton aggregates into a strength-graph neighbour's
    sizes = np.bincount(agg, minlength=next_agg)
    for i in range(n):
        if sizes[agg[i]] == 1:
            nbrs = indices[indptr[i]:indptr[i + 1]]
            if len(nbrs) > 0:
                tgt = agg[nbrs[0]]
                if sizes[tgt] < 2 * target_size and tgt != agg[i]:
                    sizes[agg[i]] -= 1
                    agg[i] = tgt
                    sizes[tgt] += 1
    _, agg = np.unique(agg, return_inverse=True)  # compact ids
    return agg


def _rho_dinv_a(A_sp: sp.csr_matrix, iters: int = 10) -> float:
    """Spectral-radius estimate of D^-1 A by power iteration (host)."""
    d = A_sp.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(A_sp.shape[0])
    v /= np.linalg.norm(v)
    rho = 1.0
    for _ in range(iters):
        v = dinv * (A_sp @ v)
        nv = np.linalg.norm(v)
        if nv == 0:
            break
        rho, v = nv, v / nv
    return float(max(rho, 1e-12))


def _smooth_prolongator(A_sp: sp.csr_matrix,
                        P_tent: sp.csr_matrix) -> sp.csr_matrix:
    """Jacobi-smoothed aggregation: P = (I - w D^-1 A) P_tent with
    w = 4 / (3 rho(D^-1 A))."""
    d = A_sp.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0)
    omega = 4.0 / (3.0 * _rho_dinv_a(A_sp))
    AP = (A_sp @ P_tent).tocsr()
    P = (P_tent - sp.diags(omega * dinv) @ AP).tocsr()
    P.sum_duplicates()
    return P


class TentativeP:
    """Tentative (unsmoothed) prolongator with one entry per row:
    ``P x = vals * x[agg]``, a gather; on an (nc, k) block every column is
    gathered. The level operator off the card (JAX ``TentativeP``)."""

    def __init__(self, vals: torch.Tensor, agg: torch.Tensor, shape):
        self.vals = vals          # (n,) entry values (1 for tentative)
        self.agg = agg            # (n,) int64 aggregate (column) per row
        self.shape = tuple(int(s) for s in shape)

    def apply(self, xc: torch.Tensor) -> torch.Tensor:
        if xc.dim() == 2:
            return self.vals[:, None] * xc[self.agg]
        return self.vals * xc[self.agg]

    def to(self, target) -> "TentativeP":
        if isinstance(target, torch.dtype):
            return TentativeP(self.vals.to(target), self.agg, self.shape)
        return TentativeP(self.vals.to(target), self.agg.to(target),
                          self.shape)

    def __repr__(self):
        return f"TentativeP(shape={self.shape}, dtype={self.vals.dtype})"


def _op_to(op, target):
    """A level operator moved to a device or with its values cast."""
    if op is None:
        return None
    if isinstance(target, torch.dtype) and is_sparse(op):
        return with_values(op, values(op).to(target))
    return op.to(target)


class AMGLevel(NamedTuple):
    """One multigrid level."""

    A: Any                  # system matrix (the caller's operand on level 0)
    P: Any                  # prolongator: a container or TentativeP
    R: Any                  # restriction P^T
    dinv_l1: torch.Tensor   # 1 / L1-Jacobi diagonal


class AMGHierarchy:
    """The levels and the coarsest operator's dense pseudo-inverse (pinv
    also covers the singular coarse matrices of pure-Neumann problems)."""

    def __init__(self, levels: Sequence[AMGLevel], coarse_inv: torch.Tensor):
        self.levels = tuple(levels)
        self.coarse_inv = coarse_inv
        # the cycles captured on the card (``_cycle_on_card``): key ->
        # _Captured, or None after the key's first apply; least recently
        # used first
        self.graphs: OrderedDict = OrderedDict()

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1

    def to(self, target) -> "AMGHierarchy":
        """Move every operator to a device, or cast every value to a
        dtype."""
        return AMGHierarchy(
            [AMGLevel(*(_op_to(op, target) for op in lvl))
             for lvl in self.levels], self.coarse_inv.to(target))

    def __repr__(self):
        sizes = [lvl.A.shape[0] for lvl in self.levels]
        sizes.append(self.coarse_inv.shape[0])
        return f"AMGHierarchy(sizes={sizes}, dtype={self.coarse_inv.dtype})"


# Levels of at most this many rows and columns are dense on the card: below
# it a V-cycle level costs launches, not arithmetic (JAX _DENSE_LEVEL_MAX).
_DENSE_LEVEL_MAX = 3072


def _pack_level_op(S_sp: sp.csr_matrix, dtype: torch.dtype,
                   device: torch.device):
    """Host scipy CSR -> the level operator on ``device``: CSR off the
    card; on the card dense when small, else ``to_gpu_operator`` with the
    relaxed CWELL fill bar of the JAX device branch (R and the coarse A are
    low-fill by construction, and even a 0.04-fill CWELL beats the plain
    CSR SpMV)."""
    np_dt = numpy_dtype(dtype)
    data = S_sp.data.astype(np_dt, copy=False)
    if device.type != "cuda":
        return csr_from_arrays(data, S_sp.indices, S_sp.indptr, S_sp.shape,
                               device=device, dtype=dtype)
    if max(S_sp.shape) <= _DENSE_LEVEL_MAX:
        return torch.from_numpy(S_sp.toarray().astype(np_dt)).to(device,
                                                                  dtype)
    from tpu_sparse_torch.sparse.optimize import to_gpu_operator

    return to_gpu_operator(csr_from_arrays(data, S_sp.indices, S_sp.indptr,
                                           S_sp.shape, device=device,
                                           dtype=dtype),
                           min_cwell_fill=0.04)


def _pack_tentative_p(P_sp: sp.csr_matrix, dtype: torch.dtype,
                      device: torch.device):
    """Tentative P (one entry per row): on the card a CWELL (K4 / K5)
    packed like the other level operators, unless promotion keeps it a
    CSR; otherwise, and off the card, the ``TentativeP`` gather."""
    if device.type == "cuda":
        op = _pack_level_op(P_sp, dtype, device)
        if not isinstance(op, CSR):
            return op
    return TentativeP(torch.from_numpy(P_sp.data).to(device, dtype),
                      torch.from_numpy(P_sp.indices.astype(np.int64)).to(
                          device), P_sp.shape)


def _operand_dtype_device(A) -> Tuple[torch.dtype, torch.device]:
    t = A if isinstance(A, torch.Tensor) else values(A)
    return t.dtype, t.device


def amg_setup(A, *, theta: float = 0.08, target_size: int = 4,
              max_levels: int = 50, coarse_size: int = 16,
              use_native: Optional[bool] = None, smoothed: bool = False,
              aggressive: int = 0) -> AMGHierarchy:
    """Build the AMG hierarchy of a matrix operand (a container or a dense
    tensor) on the operand's device, in its dtype.

    ``use_native=None`` or True runs the graph phase (aggregation, the
    Galerkin product, the L1 norms) in the host C++ kernels, which build
    at first use; a failed build raises. ``use_native=False`` runs the
    scipy path. ``smoothed=True`` selects Jacobi-smoothed aggregation
    (its Galerkin products run in scipy); ``aggressive=k`` re-aggregates
    the tentative coarse graph up to k times per level.
    """
    from tpu_sparse_torch.precond import _native

    use_native = True if use_native is None else bool(use_native)
    dtype, device = _operand_dtype_device(A)
    A_sp = to_scipy_csr(A)
    if A_sp.dtype != np.float64:
        A_sp = A_sp.astype(np.float64)
    levels: List[AMGLevel] = []

    current = A_sp
    current_dev = A  # the caller's operand is the finest level
    while (current.shape[0] > coarse_size
           and len(levels) < max_levels - 1):
        if use_native:
            agg, nc = _native.aggregate(current.indptr, current.indices,
                                        current.data, theta, target_size)
        else:
            agg = _aggregate(_strength_graph(current, theta), target_size)
            nc = int(agg.max()) + 1
        if nc >= current.shape[0]:  # no coarsening progress: stop
            break
        # aggressive coarsening: re-aggregate the tentative coarse graph
        # and compose, multiplying the coarsening ratio per level
        for _ in range(aggressive):
            if nc <= coarse_size * 4:
                break
            if use_native:
                ic1, jc1, vc1 = _native.rap_pc(
                    current.indptr, current.indices, current.data, agg, nc)
                A_c1 = sp.csr_matrix((vc1, jc1, ic1), shape=(nc, nc))
                agg2, nc2 = _native.aggregate(
                    A_c1.indptr, A_c1.indices, A_c1.data, theta, target_size)
            else:
                P1 = sp.csr_matrix(
                    (np.ones(current.shape[0]), agg.astype(np.int32),
                     np.arange(current.shape[0] + 1, dtype=np.int64)),
                    shape=(current.shape[0], nc))
                A_c1 = (P1.T @ current @ P1).tocsr()
                agg2 = _aggregate(_strength_graph(A_c1, theta), target_size)
                nc2 = int(agg2.max()) + 1
            if nc2 >= nc:
                break
            agg = agg2[agg]
            nc = nc2
        n = current.shape[0]
        # the tentative P has exactly one entry per row
        P_sp = sp.csr_matrix(
            (np.ones(n), agg.astype(np.int32),
             np.arange(n + 1, dtype=np.int64)), shape=(n, nc))
        if smoothed:
            P_sp = _smooth_prolongator(current, P_sp)
        R_sp = P_sp.T.tocsr()
        if use_native and not smoothed:
            ic, jc, vc = _native.rap_pc(current.indptr, current.indices,
                                        current.data, agg, nc)
            A_next = sp.csr_matrix((vc, jc, ic), shape=(nc, nc))
        else:
            A_next = (R_sp @ current @ P_sp).tocsr()
            A_next.sum_duplicates()

        dl1 = _l1_row_sums(current, use_native)
        dinv = torch.from_numpy(
            np.where(dl1 > 0, 1.0 / np.where(dl1 > 0, dl1, 1.0), 1.0)).to(
                device, dtype)
        P_dev = (_pack_level_op(P_sp, dtype, device) if smoothed
                 else _pack_tentative_p(P_sp, dtype, device))
        R_dev = _pack_level_op(R_sp, dtype, device)
        levels.append(AMGLevel(A=current_dev, P=P_dev, R=R_dev,
                               dinv_l1=dinv))
        current = A_next
        current_dev = _pack_level_op(A_next, dtype, device)

    coarse_inv = torch.from_numpy(
        np.linalg.pinv(current.toarray(), rcond=1e-12)).to(device, dtype)
    return AMGHierarchy(levels, coarse_inv)


def _op_from_numpy(spec, device):
    if spec is None:
        return None
    kind = spec["kind"]
    if kind == "dia":
        return dia_from_numpy(spec["data"], spec["offsets"], spec["shape"],
                              device=device)
    if kind == "csr":
        return csr_from_arrays(spec["data"], spec["indices"],
                               spec["indptr"], spec["shape"], device=device)
    if kind == "tentative":
        return TentativeP(
            torch.from_numpy(np.array(spec["vals"])).to(device),
            torch.from_numpy(np.asarray(spec["agg"], np.int64)).to(device),
            spec["shape"])
    if kind == "dense":
        return torch.from_numpy(np.array(spec["data"])).to(device)
    raise ValueError(f"unknown level operator kind {kind!r}")


def amg_hierarchy_from_numpy(levels, coarse_inv, device="cuda"
                             ) -> AMGHierarchy:
    """An ``AMGHierarchy`` from another hierarchy's arrays (for example a
    JAX hierarchy's, as numpy), on ``device`` (the card unless the caller
    asks for the CPU). ``levels`` is a sequence of (A, P, R, dinv_l1); each
    operator is a dict with ``kind`` "dia" (data, offsets, shape), "csr"
    (data, indices, indptr, shape), "tentative" (vals, agg, shape) or
    "dense" (data), and is built as given, without promotion."""
    out = []
    for A, P, R, dinv in levels:
        out.append(AMGLevel(
            A=_op_from_numpy(A, device), P=_op_from_numpy(P, device),
            R=_op_from_numpy(R, device),
            dinv_l1=torch.from_numpy(np.array(dinv)).to(device)))
    return AMGHierarchy(out, torch.from_numpy(np.array(coarse_inv)).to(
        device))


# ---------------------------------------------------------------------------
# Solve phase
# ---------------------------------------------------------------------------


def _product(A, x: torch.Tensor) -> torch.Tensor:
    """A @ x: one SpMV for a vector, one SpMM for an (n, k) block."""
    if isinstance(A, TentativeP):
        return A.apply(x)
    return spmm(A, x) if x.dim() == 2 else spmv(A, x)


def _product_plain(A, x: torch.Tensor) -> torch.Tensor:
    """A @ x of a vector through the plain PyTorch versions only."""
    if isinstance(A, TentativeP):
        return A.apply(x)
    return spmv_reference(A, x)


def _scale(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return d[:, None] * v if v.dim() == 2 else d * v


def _smooth(A, dinv, x, b, sweeps: int, omega: float, product=_product):
    for _ in range(sweeps):
        r = b - product(A, x)
        x = x + omega * _scale(dinv, r)
    return x


def _chebyshev_smooth(A, dinv, x, b, degree: int, lam_max: float,
                      lam_ratio: float = 8.0, product=_product):
    """Chebyshev polynomial smoother on the D^-1 A spectrum interval
    [lam_max / lam_ratio, lam_max]: SpMVs and axpys, no inner products."""
    lo = lam_max / lam_ratio
    theta = 0.5 * (lam_max + lo)
    delta = 0.5 * (lam_max - lo)
    r = b - product(A, x)
    z = _scale(dinv, r)
    alpha = 1.0 / theta
    d = alpha * z
    x = x + d
    rho = delta / theta
    for _ in range(degree - 1):
        r = b - product(A, x)
        z = _scale(dinv, r)
        rho_new = 1.0 / (2.0 * theta / delta - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


@tracing.traced("tsp.precond.vcycle")
def v_cycle(hier: AMGHierarchy, b: torch.Tensor, *, pre_sweeps: int = 0,
            post_sweeps: int = 3, omega: float = 1.0,
            smoother: str = "l1_jacobi", plain: bool = False,
            product=None) -> torch.Tensor:
    """One V-cycle applied to b (x0 = 0), b of shape (n,) or (n, k).

    The default sweeps are the reference's AMGX configuration (0 pre / 3
    post L1-Jacobi sweeps). smoother: 'l1_jacobi' or 'chebyshev' (sweeps
    are then the polynomial degree). ``plain=True`` runs every product of
    a vector b through the plain PyTorch versions (``spmv_reference``),
    the yardstick for the same cycle on the card's kernels. ``product``
    (op, x) -> op @ x replaces both for every level operator, and for a
    ``coarse_inv`` that is not a tensor: the distributed hierarchy's
    (``dist.amg``) operators are row-sharded objects it applies."""
    if product is None:
        product = _product_plain if plain else _product

    def smooth(lvl, x, rhs, sweeps):
        if sweeps <= 0:
            return x
        if smoother == "chebyshev":
            # L1-scaled SPD operators have spec(D_l1^-1 A) in (0, 1]
            return _chebyshev_smooth(lvl.A, lvl.dinv_l1, x, rhs,
                                     degree=sweeps, lam_max=1.0,
                                     product=product)
        return _smooth(lvl.A, lvl.dinv_l1, x, rhs, sweeps, omega, product)

    def descend(level_idx: int, rhs: torch.Tensor) -> torch.Tensor:
        if level_idx == len(hier.levels):
            with tracing.span("tsp.precond.coarse"):
                ci = hier.coarse_inv
                if not isinstance(ci, torch.Tensor):
                    return product(ci, rhs)
                return (ci @ rhs.to(ci.dtype)).to(rhs.dtype)
        with tracing.span(tracing.level_name(level_idx)):
            lvl = hier.levels[level_idx]
            x = torch.zeros_like(rhs)
            x = smooth(lvl, x, rhs, pre_sweeps)
            r = rhs - product(lvl.A, x) if pre_sweeps > 0 else rhs
            xc = descend(level_idx + 1, product(lvl.R, r))
            x = x + product(lvl.P, xc)
            return smooth(lvl, x, rhs, post_sweeps)

    try:
        return descend(0, b)
    finally:
        # descend refers to itself: without this the cycle would keep the
        # hierarchy (and its CUDA graphs) alive until the collector runs
        del descend


# Captured cycles a hierarchy keeps, least recently used out: one for each
# width, dtype, stream and sweep options its applies see.
GRAPHS_PER_HIERARCHY = 4


class _Captured(NamedTuple):
    graph: Any          # torch.cuda.CUDAGraph of one v_cycle
    b: torch.Tensor     # the static input it reads
    y: torch.Tensor     # the static output it writes
    held: tuple         # the finest operand's tensors at capture, kept
                        # alive so that no other tensor takes their ids


def _capture(hier: AMGHierarchy, b: torch.Tensor, sweeps: dict,
             held: tuple) -> _Captured:
    """One ``v_cycle`` captured on a side stream. Unlike
    ``torch.cuda.graph`` this leaves the allocator's cache as it is (no
    ``empty_cache``: the caller's next allocations would pay cudaMalloc
    again), and the garbage collector is off meanwhile: a CUDA graph that
    it frees inside a capture invalidates the capture."""
    static_b = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    static_b.copy_(b)
    graph = torch.cuda.CUDAGraph()
    caller = torch.cuda.current_stream(b.device)
    side = torch.cuda.Stream(b.device)
    side.wait_stream(caller)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(b.device), torch.cuda.stream(side):
            graph.capture_begin()
            try:
                static_y = v_cycle(hier, static_b, **sweeps)
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    caller.wait_stream(side)
    return _Captured(graph, static_b, static_y, held)


def _cycle_on_card(hier: AMGHierarchy, b: torch.Tensor,
                   sweeps: dict) -> torch.Tensor:
    """One V-cycle of a CUDA b, replayed from a CUDA graph where it can be.

    The cycle runs eager (``v_cycle``) inside a caller's own capture,
    while autograd records (grad mode on and b or the finest operand
    requiring grad) and for a b whose dtype is not the hierarchy's (the
    levels' values are then cast, and K4's compact values gathered with a
    host read, on every apply). Otherwise the key is the sweep options,
    b's shape, dtype and device, the current stream, and the id and
    in-place version of each tensor of the finest operand (the caller's
    matrix; the other levels are the hierarchy's own). A key's first apply
    runs eager, building the lazy state (K4's plans, kernel attributes,
    cuBLAS handles) outside a capture; the second captures the cycle; each
    apply after copies b in, replays and returns a copy of the output,
    since a caller may keep a result past the next apply (the CG loop's
    first p is its z)."""
    held = _leaves(hier.levels[0].A) if hier.levels else ()
    if (torch.cuda.is_current_stream_capturing()
            or b.dtype != hier.coarse_inv.dtype
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in (b,) + held))):
        PRECOND["graph_eager"] += 1
        return v_cycle(hier, b, **sweeps)
    key = (tuple(sweeps.values()), tuple(b.shape), b.dtype, b.device,
           torch.cuda.current_stream(b.device).cuda_stream,
           tuple((id(t), t._version) for t in held))
    graphs = hier.graphs
    if key not in graphs:
        graphs[key] = None
        if len(graphs) > GRAPHS_PER_HIERARCHY:
            graphs.popitem(last=False)
        PRECOND["graph_eager"] += 1
        return v_cycle(hier, b, **sweeps)
    graphs.move_to_end(key)
    captured = graphs[key]
    if captured is None:
        captured = graphs[key] = _capture(hier, b, sweeps, held)
        PRECOND["graph_captures"] += 1
    else:
        PRECOND["graph_replays"] += 1
    with tracing.span("tsp.precond.vcycle", graph=True), \
            torch.cuda.device(b.device):
        captured.b.copy_(b)
        captured.graph.replay()
        return captured.y.clone()


class AMGPreconditioner:
    """M ~ A^-1 as one V-cycle: ``M(v)`` for a vector, ``M.matmat(V)`` for
    an (n, k) block (one SpMM per level operator), ``M.to(device or
    dtype)``. On the card an apply replays a captured CUDA graph of the
    cycle (``_cycle_on_card``); elsewhere it runs ``v_cycle``."""

    def __init__(self, hier: AMGHierarchy, pre_sweeps: int = 1,
                 post_sweeps: int = 1, omega: float = 0.9,
                 smoother: str = "l1_jacobi"):
        self.hier = hier
        self.pre_sweeps = int(pre_sweeps)
        self.post_sweeps = int(post_sweeps)
        self.omega = float(omega)
        self.smoother = smoother

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        sweeps = dict(pre_sweeps=self.pre_sweeps,
                      post_sweeps=self.post_sweeps, omega=self.omega,
                      smoother=self.smoother)
        if v.is_cuda:
            return _cycle_on_card(self.hier, v, sweeps)
        return v_cycle(self.hier, v, **sweeps)

    matmat = __call__

    def to(self, target) -> "AMGPreconditioner":
        return AMGPreconditioner(self.hier.to(target), self.pre_sweeps,
                                 self.post_sweeps, self.omega, self.smoother)

    def __repr__(self):
        return (f"AMGPreconditioner({self.hier!r}, V({self.pre_sweeps},"
                f"{self.post_sweeps}), omega={self.omega}, "
                f"{self.smoother})")


def amg_preconditioner(A, *, theta: float = 0.08, target_size: int = 4,
                       max_levels: int = 50, coarse_size: int = 16,
                       pre_sweeps: int = 1, post_sweeps: int = 1,
                       omega: float = 0.9, smoother: str = "l1_jacobi",
                       smoothed: bool = False, aggressive: int = 0,
                       use_native: Optional[bool] = None
                       ) -> AMGPreconditioner:
    """M ~ A^-1 as one AMG V-cycle, usable as ``M=`` in any solver.

    The default V(1,1) with weighted Jacobi is symmetric, which PCG needs;
    the reference's AMGX 0-pre / 3-post configuration is nonsymmetric and
    stays available as pre_sweeps=0, post_sweeps=3."""
    hier = amg_setup(A, theta=theta, target_size=target_size,
                     max_levels=max_levels, coarse_size=coarse_size,
                     use_native=use_native, smoothed=smoothed,
                     aggressive=aggressive)
    return AMGPreconditioner(hier, pre_sweeps, post_sweeps, omega, smoother)


# the keyword arguments of amg_preconditioner that shape the V-cycle, not
# the hierarchy
SWEEP_OPTIONS = ("pre_sweeps", "post_sweeps", "omega", "smoother")


def amg_stationary_solve(A, b, x0=None, *, tol: float = 1e-6,
                         atol: float = 0.0, maxiter: int = 100,
                         theta: float = 0.08, target_size: int = 4,
                         max_levels: int = 50, coarse_size: int = 16,
                         pre_sweeps: int = 0, post_sweeps: int = 3,
                         omega: float = 1.0,
                         precond: Optional[AMGPreconditioner] = None,
                         smoothed: bool = False):
    """Stationary AMG iteration x <- x + V(b - A x) with its own
    convergence loop (AMGX's amg-as-solver). Converged iff
    ||r|| <= max(tol ||b||, atol). Returns (x, info, iterations, ||r||),
    info 0 converged, -1 otherwise. The loop reads the host once per
    iteration."""
    M = precond if precond is not None else amg_preconditioner(
        A, theta=theta, target_size=target_size, max_levels=max_levels,
        coarse_size=coarse_size, pre_sweeps=pre_sweeps,
        post_sweeps=post_sweeps, omega=omega, smoothed=smoothed)
    matvec = as_matvec(A)
    thresh = torch.clamp_min(tol * torch.linalg.vector_norm(b), atol).to(
        b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    r_norm = torch.linalg.vector_norm(r)
    k = 0
    while k < maxiter and bool(tracing.host_read(
            (r_norm > thresh) & torch.isfinite(r_norm))):
        x = x + M(r)
        r = b - matvec(x)
        r_norm = torch.linalg.vector_norm(r)
        k += 1
    ok = torch.isfinite(r_norm) & (r_norm <= thresh)
    info = torch.where(ok, 0, -1).to(torch.int32)
    return x, info, torch.full((), k, dtype=torch.int32, device=b.device), \
        r_norm


def amg_solve(A, b, x0=None, *, tol: float = 1e-6, atol: float = 0.0,
              maxiter: int = 100, theta: float = 0.08,
              target_size: int = 4, max_levels: int = 50,
              coarse_size: int = 16, pre_sweeps: int = 1,
              post_sweeps: int = 1, omega: float = 0.9,
              precond: Optional[AMGPreconditioner] = None,
              smoothed: bool = False):
    """AMG-preconditioned CG (AMGX's AMG with CG acceleration), with the
    adjoint gradient of ``cg_diff``. Returns (x, info, iterations,
    residual_norm)."""
    from tpu_sparse_torch.autodiff import cg_diff

    M = precond if precond is not None else amg_preconditioner(
        A, theta=theta, target_size=target_size, max_levels=max_levels,
        coarse_size=coarse_size, pre_sweeps=pre_sweeps,
        post_sweeps=post_sweeps, omega=omega, smoothed=smoothed)
    return cg_diff(A, b, x0, tol=tol, atol=atol, maxiter=maxiter, M=M)
