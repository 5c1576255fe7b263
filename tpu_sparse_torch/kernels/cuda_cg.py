"""Fused CG on an extended stencil operator: kernels 2 and 3
(``csrc/dia_cg.cu``).

Counterpart of ``tpu_sparse/kernels/pallas_cg.py``. The TPU kernel ran K CG
iterations per launch with x, r, p resident in VMEM. Here one iteration is
two launches, ``dia_cg_spmv_dot`` (p = z + beta p_prev, Ap, partial <p,Ap>)
and ``dia_cg_update`` (alpha, x and r, partial <r,r> / <r,D^-1 r>, and in the
block that finishes last: the ||r||^2 history entry, gamma and beta). gamma,
beta and the history stay on the device; ``fused_cg_ext`` reads the (K,)
history once per block of K iterations and applies the first-crossing rule of
the JAX ``fused_cg_ext``. See the note in ``csrc/dia_cg.cu`` for the design.

Both wrappers launch their kernel for CUDA tensors and run their plain
PyTorch version (same buffers, same arithmetic order of operations) for CPU
tensors. ``fused_cg_block_reference`` is the plain version of one K-iteration
block in the JAX kernel's own state convention (x, r, p -> x, r, p, history).

The JAX E-cap / VMEM budget (``_FUSED_E_CAP``) was a TPU limit and is gone.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels.cuda_spmv import (ExtendedStencilOperator,
                                                make_extended_operator)
from tpu_sparse_torch.utils.tree import _final_check_relax

BLOCK = 256       # TS_BLOCK in csrc/ts_common.cuh
MAX_GRID = 1024   # TS_MAX_GRID

# Launches of kernels 2 and 3; counted where each kernel launches.
# ``dia_cg_spmv_dot_unrolled``: the launches of kernel 2 that took an
# instance unrolled for their diagonal count.
LAUNCHES = tracing.group("launches", {"dia_cg_spmv_dot": 0,
                                      "dia_cg_spmv_dot_unrolled": 0,
                                      "dia_cg_update": 0})

# Kernel 2's rows a thread (TS_CG_ROWS in csrc/dia_cg.cu): each diagonal's
# R values one vector load; 1 on the scalar path.
SPMV_DOT_ROWS = 2
# Diagonal counts with an unrolled instance of kernel 2
# (TS_DIA_FOR_EACH_ND); any other count runs the generic loop.
UNROLLED_DIAGS = (3, 5, 7, 9, 27)


def grid_for(n: int) -> int:
    """Blocks per launch of kernel 3 (ts_grid_for): also the number of
    <p,Ap> partials kernel 3 sums."""
    return max(1, min(-(-n // BLOCK), MAX_GRID))


def spmv_dot_geometry(n: int, offsets, ld: int, data_ptr: int,
                      sms: int) -> dict:
    """Kernel 2's launch for one call, as its host entry decides it
    (``ts_dia_cg_spmv_dot_geometry``): the instance (``unrolled`` for the
    diagonal counts of ``UNROLLED_DIAGS``), rows a thread, CTAs (one a tile
    of BLOCK x rows rows), the ``n_pap = grid_for(n)`` <p,Ap> slots kernel
    3 sums and the tiles each slot sums (``per_slot``). ``SPMV_DOT_ROWS``
    rows a thread when their vector loads fit (the data pointer and the
    row length ``ld`` aligned to R x 4 bytes) and the grid keeps two CTAs a
    SM; else one. The halo width plays no part: no load of the vectors is
    wider than a value."""
    rows = SPMV_DOT_ROWS
    vec = 4 * rows
    fits = data_ptr % vec == 0 and ld * 4 % vec == 0
    if not fits or -(-n // (BLOCK * rows)) < 2 * sms:
        rows = 1
    grid = -(-n // (BLOCK * rows))
    n_pap = grid_for(n)
    return dict(grid=grid, rows=rows, unrolled=len(offsets) in UNROLLED_DIAGS,
                n_pap=n_pap, per_slot=-(-grid // n_pap))


def spmv_dot_geometry_cuda(n: int, offsets, ld: int, data_ptr: int,
                           sms: int) -> dict:
    """``spmv_dot_geometry`` as the kernel library's host entry computes
    it (needs the built library, not a device)."""
    import ctypes

    from tpu_sparse_torch.kernels import _build

    out = (ctypes.c_longlong * 5)()
    _build.check(_build.library().ts_dia_cg_spmv_dot_geometry(
        len(offsets), n, ld, data_ptr, sms, ctypes.addressof(out)),
        "ts_dia_cg_spmv_dot_geometry")
    return dict(grid=out[0], rows=out[1], unrolled=bool(out[2]),
                n_pap=out[3], per_slot=out[4])


def operator_geometry(op, device) -> dict:
    """``spmv_dot_geometry`` of kernel 2's calls on ``op`` on ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return spmv_dot_geometry(op.n, op.offsets, op.data.shape[1],
                             op.data.data_ptr(), sms)


def spmv_dot_workspace(op, device) -> tuple:
    """Kernel 2's buffers on ``device`` for folding its tiles' <p,Ap> into
    the slots: (tile partials, float64 (grid,); slot tickets, int32 zeros
    (n_pap,)). The kernel reads them when a slot sums more than one
    tile and leaves the tickets zero."""
    geo = operator_geometry(op, device)
    return (torch.empty(geo["grid"], dtype=torch.float64, device=device),
            torch.zeros(geo["n_pap"], dtype=torch.int32, device=device))


def supports_fused_cg(op) -> bool:
    """The fused kernels take a float32 extended operator."""
    return (isinstance(op, ExtendedStencilOperator)
            and op.dtype == torch.float32)


def make_fused_operator(A) -> "ExtendedStencilOperator | None":
    """Extended operator for the fused CG kernels, or None when the matrix
    does not qualify (square, at least one diagonal, float32, bandwidth
    below n): bf16 data is refused, as JAX's fused kernels refuse it
    (``pallas_cg.py:275``), and takes the extended loop. The JAX
    ``precond`` argument sized a VMEM budget and has no counterpart
    here."""
    if A.data.dtype != torch.float32:
        return None
    return make_extended_operator(A)


def pick_block_iters(iters_estimate: int, default: int = 16) -> int:
    """Block size minimizing overshoot for a known iteration count:
    smallest K whose launch count matches K=32's."""
    it = int(iters_estimate)
    if it <= 0:
        return default
    launches = -(-it // 32)
    return min(max(-(-it // launches), 4), 64)


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _check_cg_buffers(op, vecs: dict, scal, parts: dict, counter=None):
    dev = scal.device
    if not supports_fused_cg(op):
        raise TypeError("fused CG kernels take a float32 "
                        "ExtendedStencilOperator")
    if op.data.device != dev:
        raise ValueError(f"operator on {op.data.device}, state on {dev}")
    for name, v in vecs.items():
        if v is None:
            continue
        if v.device != dev or v.dtype != torch.float32 or v.dim() != 1 \
                or v.shape[0] != op.E or not v.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 ({op.E},) "
                             f"tensor on {dev}")
    if scal.dtype != torch.float64 or scal.shape != (2,):
        raise ValueError("scal: need a float64 (2,) tensor [gamma, beta]")
    g = grid_for(op.n)
    for name, t in parts.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float64 or t.shape != (g,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a float64 ({g},) tensor on {dev}")
    if counter is not None and (counter.device != dev
                                or counter.dtype != torch.int32
                                or counter.numel() != 1):
        raise ValueError("counter: need a one-element int32 tensor")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def dia_cg_spmv_dot(op, r, dinv, p_prev, p_new, ap, scal, pap_part,
                    work=None) -> None:
    """p_new = z + beta*p_prev, ap = A p_new, pap_part = <p,Ap> in
    ``grid_for(op.n)`` slots.

    Kernel 2 for CUDA tensors, ``dia_cg_spmv_dot_plain`` for CPU tensors.
    ``work`` is ``spmv_dot_workspace(op, device)``, made here when not
    given."""
    if not scal.is_cuda:
        return dia_cg_spmv_dot_plain(op, r, dinv, p_prev, p_new, ap, scal,
                                     pap_part)
    _check_cg_buffers(op, dict(r=r, dinv=dinv, p_prev=p_prev, p_new=p_new,
                               ap=ap), scal, dict(pap_part=pap_part))
    tile_part, slot_count = (spmv_dot_workspace(op, scal.device)
                             if work is None else work)
    if (tile_part.device != scal.device or tile_part.dtype != torch.float64
            or slot_count.device != scal.device
            or slot_count.dtype != torch.int32
            or slot_count.numel() != grid_for(op.n)):
        raise ValueError("work: need spmv_dot_workspace's buffers")
    from tpu_sparse_torch.kernels import _build

    lib = _build.library()
    offs, offs_ptr = _build.int_array(op.offsets)
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ts_dia_cg_spmv_dot(
            op.data.data_ptr(), op.data.shape[1], offs_ptr, len(op.offsets),
            op.n, op.Wl, r.data_ptr(), _ptr(dinv), p_prev.data_ptr(),
            p_new.data_ptr(), ap.data_ptr(), scal.data_ptr(),
            pap_part.data_ptr(), grid_for(op.n), tile_part.data_ptr(),
            tile_part.numel(), slot_count.data_ptr(), stream)
    _build.check(rc, "dia_cg_spmv_dot")
    LAUNCHES["dia_cg_spmv_dot"] += 1
    if len(op.offsets) in UNROLLED_DIAGS:
        LAUNCHES["dia_cg_spmv_dot_unrolled"] += 1


def _fold(v: torch.Tensor, size: int) -> torch.Tensor:
    """Sums of ``v``'s consecutive runs of ``size`` (the last one short)."""
    pad = -v.numel() % size
    return torch.nn.functional.pad(v, (0, pad)).view(-1, size).sum(1)


def dia_cg_spmv_dot_plain(op, r, dinv, p_prev, p_new, ap, scal, pap_part,
                          geometry: "dict | None" = None) -> None:
    """Plain version of kernel 2. With ``geometry`` (``spmv_dot_geometry``)
    the <p,Ap> products are summed tile by tile over its split and the
    tiles folded into its slots, as the kernel folds them (the sums in
    another order); without it the whole <p,Ap> lands in pap_part[0]."""
    sl = slice(op.Wl, op.Wl + op.n)
    beta = scal[1].to(torch.float32)
    z = r if dinv is None else dinv * r
    p_new.copy_(z + beta * p_prev)
    ap[sl] = op.apply_plain(p_new)[sl]
    pap_part.zero_()
    if geometry is None:
        pap_part[0] = torch.dot(p_new[sl].double(), ap[sl].double())
        return
    tiles = _fold(p_new[sl].double() * ap[sl].double(),
                  BLOCK * geometry["rows"])
    slots = _fold(tiles, geometry["per_slot"])
    pap_part[:slots.numel()] = slots


def dia_cg_update(op, x, r, p, ap, dinv, pap_part, scal, rr_part, gz_part,
                  counter, hist, init: bool = False) -> None:
    """alpha = gamma/<p,Ap> (0 unless <p,Ap> > 0), x += alpha p,
    r -= alpha Ap, then gamma' = <r,z>, beta' = gamma'/gamma (0 unless
    gamma > 0) into ``scal`` and ||r||^2 into ``hist`` (a one-element view,
    or None). ``init`` skips the update and only sets gamma (beta 0).

    Kernel 3 for CUDA tensors, ``dia_cg_update_plain`` for CPU tensors."""
    if not scal.is_cuda:
        return dia_cg_update_plain(op, x, r, p, ap, dinv, pap_part, scal,
                                   rr_part, gz_part, counter, hist, init)
    _check_cg_buffers(op, dict(x=x, r=r, p=p, ap=ap, dinv=dinv), scal,
                      dict(pap_part=pap_part, rr_part=rr_part,
                           gz_part=gz_part), counter)
    if dinv is not None and gz_part is None:
        raise ValueError("a Jacobi update needs gz_part")
    if hist is not None and (hist.device != scal.device
                             or hist.dtype != torch.float32
                             or hist.numel() != 1):
        raise ValueError("hist: need a one-element float32 view")
    from tpu_sparse_torch.kernels import _build

    lib = _build.library()
    g = grid_for(op.n)
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ts_dia_cg_update(
            op.n, op.Wl, x.data_ptr(), r.data_ptr(), p.data_ptr(),
            ap.data_ptr(), _ptr(dinv), pap_part.data_ptr(), g,
            scal.data_ptr(), rr_part.data_ptr(), _ptr(gz_part),
            counter.data_ptr(), _ptr(hist), int(bool(init)), g, stream)
    _build.check(rc, "dia_cg_update")
    LAUNCHES["dia_cg_update"] += 1


def dia_cg_update_plain(op, x, r, p, ap, dinv, pap_part, scal, rr_part,
                        gz_part, counter, hist, init: bool = False) -> None:
    sl = slice(op.Wl, op.Wl + op.n)
    if not init:
        pap = pap_part.sum()
        alpha = torch.where(pap > 0, scal[0] / torch.where(pap > 0, pap, 1.0),
                            0.0).to(torch.float32)
        x[sl] += alpha * p[sl]
        r[sl] -= alpha * ap[sl]
    ri = r[sl].double()
    rr = torch.dot(ri, ri)
    rr_part.zero_()
    rr_part[0] = rr
    gz = rr
    if dinv is not None:
        gz = torch.dot(ri, (dinv[sl] * r[sl]).double())
        gz_part.zero_()
        gz_part[0] = gz
    g_old = scal[0].clone()
    scal[1] = torch.where(g_old > 0, gz / torch.where(g_old > 0, g_old, 1.0),
                          0.0)
    scal[0] = gz
    if hist is not None:
        hist.copy_(rr.to(torch.float32).reshape(1))


class FusedCGState:
    """Device state of one fused CG solve in the extended layout.

    ``x``, ``r`` and two ``p`` buffers (double-buffered: kernel 2 reads the
    previous direction and writes the new one), ``ap``, the per-block
    partials, ``scal = [gamma, beta]`` (float64), the integer ticket
    counter of kernel 3 and kernel 2's workspace (``work``). Margins of
    every vector are zero and stay zero. Construction runs kernel 3 once
    in init mode: gamma0 = <b, z0>, beta 0.
    """

    def __init__(self, op: ExtendedStencilOperator, b_ext: torch.Tensor,
                 dinv_ext: "torch.Tensor | None" = None):
        dev, E = b_ext.device, op.E
        g = grid_for(op.n)
        self.op = op
        self.dinv = dinv_ext
        self.x = torch.zeros(E, dtype=torch.float32, device=dev)
        self.r = b_ext.to(torch.float32).clone()
        self.p = [torch.zeros(E, dtype=torch.float32, device=dev)
                  for _ in range(2)]
        self.cur = 0
        self.ap = torch.zeros(E, dtype=torch.float32, device=dev)
        self.scal = torch.zeros(2, dtype=torch.float64, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        self.pap_part = torch.zeros(g, **f64)
        self.rr_part = torch.zeros(g, **f64)
        self.gz_part = None if dinv_ext is None else torch.zeros(g, **f64)
        self.counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self.work = (spmv_dot_workspace(op, dev) if b_ext.is_cuda
                     else None)
        self._update(None, init=True)

    @property
    def direction(self) -> torch.Tensor:
        """The last search direction p (kernel 2's output)."""
        return self.p[self.cur]

    def _update(self, hist, init=False):
        dia_cg_update(self.op, self.x, self.r, self.p[self.cur], self.ap,
                      self.dinv, self.pap_part, self.scal, self.rr_part,
                      self.gz_part, self.counter, hist, init=init)

    def step(self, hist: "torch.Tensor | None") -> None:
        """One CG iteration: kernel 2 then kernel 3."""
        dia_cg_spmv_dot(self.op, self.r, self.dinv, self.p[self.cur],
                        self.p[1 - self.cur], self.ap, self.scal,
                        self.pap_part, self.work)
        self.cur = 1 - self.cur
        self._update(hist)

    def run(self, hist: torch.Tensor) -> None:
        """``hist.numel()`` iterations; hist[k] = ||r||^2 after k+1."""
        for k in range(hist.numel()):
            self.step(hist[k:k + 1])


def fused_cg_block_reference(op: ExtendedStencilOperator, x, r, p, K: int,
                             dinv=None):
    """Plain version of one K-iteration block of the TPU kernel
    (``pallas_cg._fused_cg_block``): from extended (x, r, p), with p the
    current direction, run K iterations with the same alpha/beta guards and
    return (x, r, p, hist) with p the next direction and hist the (K,)
    ||r||^2 history. ``dinv`` (extended, unit margins) gives Jacobi-PCG."""

    def z_of(v):
        return v if dinv is None else dinv * v

    gamma = torch.dot(r, z_of(r))
    hist = []
    for _ in range(int(K)):
        ap = op.apply_plain(p)
        pap = torch.dot(p, ap)
        alpha = torch.where(pap > 0, gamma / torch.where(pap > 0, pap, 1.0),
                            0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rr = torch.dot(r, r)
        g_new = rr if dinv is None else torch.dot(r, z_of(r))
        beta = torch.where(gamma > 0,
                           g_new / torch.where(gamma > 0, gamma, 1.0), 0.0)
        p = z_of(r) + beta * p
        gamma = g_new
        hist.append(rr)
    return x, r, p, torch.stack(hist)


@tracing.traced("tsp.solver.fused_cg")
def fused_cg_ext(op: ExtendedStencilOperator, b: torch.Tensor, *,
                 tol: float = 1e-6, atol: float = 0.0,
                 maxiter: "int | None" = None, block_iters: int = 16,
                 dinv: "torch.Tensor | None" = None):
    """CG on the extended stencil operator with the fused kernels.

    Contract of cg_full: run until ``||r|| <= max(tol*||b||, atol)`` or
    maxiter, in blocks of ``block_iters`` iterations; the iteration count is
    the first crossing in the ||r||^2 history (global, since ||r|| is not
    monotone in CG); info and the residual come from the true residual
    with the float32 x10 relaxation. ``dinv`` (original space) gives
    Jacobi-PCG. Returns (x, info, iters, res) with x in the original space.
    """
    if not supports_fused_cg(op):
        raise ValueError("operator does not support the fused CG kernels")
    if maxiter is None:
        maxiter = 10 * op.n  # reference default (torch_sparse_linalg.py:982)
    b = b.to(torch.float32)
    b_norm = np.float32(
        tracing.host_read(torch.linalg.vector_norm(b)).item())
    thresh = np.maximum(np.float32(tol) * b_norm, np.float32(atol))
    thresh2 = thresh * thresh
    b_ext = op.extend(b)
    dinv_ext = (None if dinv is None
                else op.extend_diag(dinv.to(torch.float32)))
    K = int(block_iters)
    state = FusedCGState(op, b_ext, dinv_ext)
    hist = torch.empty(K, dtype=torch.float32, device=b.device)
    done, first_iter = 0, -1
    rr_last = np.float32(3.0e38)  # finite so the first pass runs
    while first_iter < 0 and done < maxiter and np.isfinite(rr_last):
        with tracing.span("tsp.solver.block"):
            state.run(hist)
            h = tracing.host_read(hist).numpy()  # the one read per block
        tracing.SOLVER["iterations_run"] += K
        crossed = h <= thresh2
        if crossed.any():
            first_iter = done + int(np.argmax(crossed)) + 1
        done += K
        rr_last = h[K - 1]
    iters = first_iter if first_iter >= 0 else done
    res = torch.linalg.vector_norm(b_ext - op(state.x))
    relax = np.float32(_final_check_relax(torch.float32))
    ok = (torch.isfinite(res) & (res <= float(thresh * relax))
          & torch.isfinite(torch.linalg.vector_norm(state.x)))
    info = torch.where(ok, 0, -1).to(torch.int32)
    # a fill, not a copy from the host: that would wait for the queue
    iters_t = torch.full((), iters, dtype=torch.int32, device=b.device)
    return op.extract(state.x), info, iters_t, res
