"""Fused BiCGStab on an extended stencil operator: K10
(``csrc/dia_bicgstab.cu``).

Counterpart of ``tpu_sparse/kernels/pallas_bicgstab.py``. The TPU kernel ran
K BiCGStab iterations per launch with the Krylov state resident in VMEM.
Here one iteration is three launches:

* ``dia_bicgstab_q``: p = r + beta (p_prev - omega q_prev) formed on the
  fly, q = A p, partial <r^, q>;
* ``dia_bicgstab_t``: alpha, s = r - alpha q formed on the fly, t = A s,
  partials <t,s>, <t,t>, ||s||^2; the last block sets omega and the -11
  codes;
* ``dia_bicgstab_update``: x += alpha p + omega s, r = s - omega t,
  partials <r,r>, <r^,r>; the last block sets rho', the -10 code, beta and
  the history entry.

rho, alpha, omega, beta and the breakdown code stay on the device
(``scal``); ``fused_bicgstab_ext`` reads the (K,) history once per block of
K iterations and applies the rules of the JAX ``fused_bicgstab_ext``. See
the note in ``csrc/dia_bicgstab.cu`` for the design and its bound.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (same buffers, same order of operations, dot products in
double) for CPU tensors. ``fused_bicgstab_block_reference`` is the plain
version of one K-iteration block in the JAX kernel's own state convention
(x, r, p, r^ -> x, r, p, history), with its float32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels.cuda_cg import _ptr, grid_for, supports_fused_cg
from tpu_sparse_torch.kernels.cuda_spmv import ExtendedStencilOperator
from tpu_sparse_torch.utils.tree import _final_check_relax

# Slots of ``scal`` and rows of the partials buffer (csrc/dia_bicgstab.cu).
RHO, ALPHA, OMEGA, BETA, CODE = range(5)
N_SCAL = 5
RHQ, TS, TT, SS, RR, RHON = range(6)
N_PART = 6

EPS = 1.1754944e-38      # float tiny: division guards
EPS_REL = 1.1920929e-07  # float eps: breakdown tests

# Launches of the three K10 kernels; counted where each kernel launches.
LAUNCHES = tracing.group("launches", {"dia_bicgstab_q": 0,
                                      "dia_bicgstab_t": 0,
                                      "dia_bicgstab_update": 0})


def supports_fused_bicgstab(op) -> bool:
    """The fused kernels take a float32 extended operator (the JAX VMEM
    budget was a TPU limit and is gone)."""
    return supports_fused_cg(op)


def _check(op, vecs: dict, scal, part, counter=None):
    dev = scal.device
    if not supports_fused_bicgstab(op):
        raise TypeError("fused BiCGStab kernels take a float32 "
                        "ExtendedStencilOperator")
    if op.data.device != dev:
        raise ValueError(f"operator on {op.data.device}, state on {dev}")
    for name, v in vecs.items():
        if v.device != dev or v.dtype != torch.float32 or v.dim() != 1 \
                or v.shape[0] != op.E or not v.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 ({op.E},) "
                             f"tensor on {dev}")
    if scal.dtype != torch.float64 or scal.shape != (N_SCAL,):
        raise ValueError(f"scal: need a float64 ({N_SCAL},) tensor")
    g = grid_for(op.n)
    if part.device != dev or part.dtype != torch.float64 \
            or part.shape != (N_PART, g) or not part.is_contiguous():
        raise ValueError(f"part: need a float64 ({N_PART}, {g}) tensor")
    if counter is not None and (counter.device != dev
                                or counter.dtype != torch.int32
                                or counter.numel() != 1):
        raise ValueError("counter: need a one-element int32 tensor")


def _lib_offsets(op):
    from tpu_sparse_torch.kernels import _build

    lib = _build.library()
    offs, offs_ptr = _build.int_array(op.offsets)
    return _build, lib, offs, offs_ptr


def _interior(op) -> slice:
    return slice(op.Wl, op.Wl + op.n)


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def dia_bicgstab_q(op, r, p_prev, q_prev, rhat, p_new, q_new, scal,
                   part) -> None:
    """p_new = r + beta (p_prev - omega q_prev), q_new = A p_new,
    part[RHQ] = per-block <r^, q_new>."""
    if not scal.is_cuda:
        return dia_bicgstab_q_plain(op, r, p_prev, q_prev, rhat, p_new,
                                    q_new, scal, part)
    _check(op, dict(r=r, p_prev=p_prev, q_prev=q_prev, rhat=rhat,
                    p_new=p_new, q_new=q_new), scal, part)
    _build, lib, offs, offs_ptr = _lib_offsets(op)
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ts_dia_bicgstab_q(
            op.data.data_ptr(), op.data.shape[1], offs_ptr, len(op.offsets),
            op.n, op.Wl, r.data_ptr(), p_prev.data_ptr(), q_prev.data_ptr(),
            rhat.data_ptr(), p_new.data_ptr(), q_new.data_ptr(),
            scal.data_ptr(), part.data_ptr(), grid_for(op.n), stream)
    _build.check(rc, "dia_bicgstab_q")
    LAUNCHES["dia_bicgstab_q"] += 1


def dia_bicgstab_q_plain(op, r, p_prev, q_prev, rhat, p_new, q_new, scal,
                         part) -> None:
    sl = _interior(op)
    beta, omega = _f32(scal[BETA]), _f32(scal[OMEGA])
    p_new.copy_(r + beta * (p_prev - omega * q_prev))
    q_new[sl] = op.apply_plain(p_new)[sl]
    part[RHQ].zero_()
    part[RHQ, 0] = torch.dot(rhat[sl].double(), q_new[sl].double())


def dia_bicgstab_t(op, r, q, s, t, scal, part, counter) -> None:
    """alpha = rho/<r^,q> (0 when |<r^,q>| <= eps or frozen), s = r - alpha
    q, t = A s, partials of <t,s>, <t,t>, ||s||^2; then omega and the -11
    codes into ``scal``."""
    if not scal.is_cuda:
        return dia_bicgstab_t_plain(op, r, q, s, t, scal, part, counter)
    _check(op, dict(r=r, q=q, s=s, t=t), scal, part, counter)
    _build, lib, offs, offs_ptr = _lib_offsets(op)
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ts_dia_bicgstab_t(
            op.data.data_ptr(), op.data.shape[1], offs_ptr, len(op.offsets),
            op.n, op.Wl, r.data_ptr(), q.data_ptr(), s.data_ptr(),
            t.data_ptr(), scal.data_ptr(), part.data_ptr(),
            counter.data_ptr(), grid_for(op.n), stream)
    _build.check(rc, "dia_bicgstab_t")
    LAUNCHES["dia_bicgstab_t"] += 1


def dia_bicgstab_t_plain(op, r, q, s, t, scal, part, counter) -> None:
    sl = _interior(op)
    rhq = part[RHQ].sum()
    code = scal[CODE]
    ok = (_f32(rhq).abs() > EPS) & (code == 0)
    alpha = _f32(torch.where(ok, scal[RHO] / torch.where(ok, rhq, 1.0), 0.0))
    s.copy_(r - alpha * q)
    t[sl] = op.apply_plain(s)[sl]
    td, sd = t[sl].double(), s[sl].double()
    ts, tt, ss = torch.dot(td, sd), torch.dot(td, td), torch.dot(sd, sd)
    part[TS:SS + 1].zero_()
    part[TS, 0], part[TT, 0], part[SS, 0] = ts, tt, ss
    code = torch.where(~ok & (code == 0), -11.0, code)
    ok_t = (_f32(tt) > EPS) & (code == 0)
    omega = _f32(torch.where(ok_t, ts / torch.where(ok_t, tt, 1.0), 0.0))
    omega_bad = (omega.abs() < EPS_REL) & (_f32(ss) > EPS)
    scal[ALPHA] = alpha
    scal[OMEGA] = omega
    scal[CODE] = torch.where((code == 0) & omega_bad, -11.0, code)


def dia_bicgstab_update(op, x, r, p, s, t, rhat, scal, part, counter, hist,
                        init: bool = False) -> None:
    """x += alpha p + omega s, r = s - omega t; then rho' = <r^,r>, the -10
    code, beta into ``scal`` and ||r||^2 (or the code once frozen) into
    ``hist`` (a one-element view, or None). ``init`` skips the update and
    only sets rho = <r^,r> with alpha, omega, beta and the code 0."""
    if not scal.is_cuda:
        return dia_bicgstab_update_plain(op, x, r, p, s, t, rhat, scal,
                                         part, counter, hist, init)
    _check(op, dict(x=x, r=r, p=p, s=s, t=t, rhat=rhat), scal, part,
           counter)
    if hist is not None and (hist.device != scal.device
                             or hist.dtype != torch.float32
                             or hist.numel() != 1):
        raise ValueError("hist: need a one-element float32 view")
    from tpu_sparse_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ts_dia_bicgstab_update(
            op.n, op.Wl, x.data_ptr(), r.data_ptr(), p.data_ptr(),
            s.data_ptr(), t.data_ptr(), rhat.data_ptr(), scal.data_ptr(),
            part.data_ptr(), counter.data_ptr(), _ptr(hist), int(bool(init)),
            grid_for(op.n), stream)
    _build.check(rc, "dia_bicgstab_update")
    LAUNCHES["dia_bicgstab_update"] += 1


def dia_bicgstab_update_plain(op, x, r, p, s, t, rhat, scal, part, counter,
                              hist, init: bool = False) -> None:
    sl = _interior(op)
    if not init:
        alpha, omega = _f32(scal[ALPHA]), _f32(scal[OMEGA])
        x[sl] = x[sl] + alpha * p[sl] + omega * s[sl]
        r[sl] = s[sl] - omega * t[sl]
    ri = r[sl].double()
    rr = torch.dot(ri, ri)
    rho_new = _f32(torch.dot(rhat[sl].double(), ri))
    part[RR:RHON + 1].zero_()
    part[RR, 0], part[RHON, 0] = rr, rho_new
    if init:
        scal.zero_()
        scal[RHO] = rho_new
        return
    rho, omega, alpha = _f32(scal[RHO]), _f32(scal[OMEGA]), scal[ALPHA]
    code = torch.where((scal[CODE] == 0)
                       & (rho_new.abs() < EPS_REL * rho.abs()),
                       -10.0, scal[CODE])
    ok = (code == 0) & (rho.abs() > EPS) & (omega.abs() > EPS)
    beta = torch.where(
        ok, (rho_new.double() / torch.where(ok, rho, 1.0).double())
        * (alpha / torch.where(ok, omega, 1.0).double()), 0.0)
    scal[BETA] = _f32(beta)
    scal[RHO] = rho_new
    scal[CODE] = code
    if hist is not None:
        hist.copy_(_f32(torch.where(code != 0, code, rr)).reshape(1))


class FusedBiCGStabState:
    """Device state of one fused BiCGStab solve in the extended layout.

    ``x``, ``r``, ``rhat`` (= b, read only), double-buffered ``p`` and
    ``q`` (kernel q reads the previous ones and writes the new ones),
    ``s``, ``t``, the per-block partials ``part`` (6, grid), ``scal`` =
    [rho, alpha, omega, beta, code] (float64) and the integer ticket
    counter. Margins of every vector are zero and stay zero. Construction
    runs the update kernel once in init mode: rho0 = <b, b>, beta 0, so
    the first direction is r.
    """

    def __init__(self, op: ExtendedStencilOperator, b_ext: torch.Tensor):
        dev, E = b_ext.device, op.E

        def vec():
            return torch.zeros(E, dtype=torch.float32, device=dev)

        self.op = op
        self.rhat = b_ext.to(torch.float32).contiguous()
        self.x = vec()
        self.r = self.rhat.clone()
        self.p = [vec(), vec()]
        self.q = [vec(), vec()]
        self.cur = 0
        self.s = vec()
        self.t = vec()
        self.scal = torch.zeros(N_SCAL, dtype=torch.float64, device=dev)
        self.part = torch.zeros((N_PART, grid_for(op.n)),
                                dtype=torch.float64, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self._update(None, init=True)

    @property
    def direction(self) -> torch.Tensor:
        """The last search direction p (kernel q's output)."""
        return self.p[self.cur]

    @property
    def aq(self) -> torch.Tensor:
        """The last q = A p."""
        return self.q[self.cur]

    def _update(self, hist, init=False):
        dia_bicgstab_update(self.op, self.x, self.r, self.p[self.cur],
                            self.s, self.t, self.rhat, self.scal, self.part,
                            self.counter, hist, init=init)

    def step(self, hist: "torch.Tensor | None") -> None:
        """One BiCGStab iteration: kernels q, t and update."""
        nxt = 1 - self.cur
        dia_bicgstab_q(self.op, self.r, self.p[self.cur], self.q[self.cur],
                       self.rhat, self.p[nxt], self.q[nxt], self.scal,
                       self.part)
        self.cur = nxt
        dia_bicgstab_t(self.op, self.r, self.q[self.cur], self.s, self.t,
                       self.scal, self.part, self.counter)
        self._update(hist)

    def run(self, hist: torch.Tensor) -> None:
        """``hist.numel()`` iterations; hist[k] = ||r||^2 after k+1, or the
        breakdown code once frozen."""
        for k in range(hist.numel()):
            self.step(hist[k:k + 1])


def fused_bicgstab_block_reference(op: ExtendedStencilOperator, x, r, p,
                                   rhat, K: int):
    """Plain version of one K-iteration block of the TPU kernel
    (``pallas_bicgstab._fused_bicgstab_block``) in its float32 arithmetic:
    from extended (x, r, p), with p the current direction and rho derived
    from <r^, r>, run K iterations with the kernel's guards and codes and
    return (x, r, p, hist) with p the next direction and hist the (K,)
    history (||r||^2, or the breakdown code once frozen)."""
    f32 = dict(dtype=torch.float32, device=x.device)
    zero, one = torch.zeros((), **f32), torch.ones((), **f32)
    rho = torch.dot(rhat, r)
    frozen = zero
    hist = []
    for _ in range(int(K)):
        q = op.apply_plain(p)
        rhq = torch.dot(rhat, q)
        ok = (rhq.abs() > EPS) & (frozen == 0)
        alpha = torch.where(ok, rho / torch.where(ok, rhq, one), zero)
        frozen = torch.where(~ok & (frozen == 0), -11.0 * one, frozen)
        s = r - alpha * q
        ss = torch.dot(s, s)
        t = op.apply_plain(s)
        ts, tt = torch.dot(t, s), torch.dot(t, t)
        ok_t = (tt > EPS) & (frozen == 0)
        omega = torch.where(ok_t, ts / torch.where(ok_t, tt, one), zero)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rr, rho_new = torch.dot(r, r), torch.dot(rhat, r)
        omega_bad = (omega.abs() < EPS_REL) & (ss > EPS)
        frozen = torch.where((frozen == 0) & omega_bad, -11.0 * one, frozen)
        rho_bad = rho_new.abs() < EPS_REL * rho.abs()
        frozen = torch.where((frozen == 0) & rho_bad, -10.0 * one, frozen)
        okb = (rho.abs() > EPS) & (omega.abs() > EPS)
        beta = torch.where(
            okb, (rho_new / torch.where(rho.abs() > EPS, rho, one))
            * (alpha / torch.where(omega.abs() > EPS, omega, one)), zero)
        beta = torch.where(frozen != 0, zero, beta)
        p = r + beta * (p - omega * q)
        rho = rho_new
        hist.append(torch.where(frozen != 0, frozen, rr))
    return x, r, p, torch.stack(hist)


@tracing.traced("tsp.solver.fused_bicgstab")
def fused_bicgstab_ext(op: ExtendedStencilOperator, b: torch.Tensor, *,
                       tol: float = 1e-6, atol: float = 0.0,
                       maxiter: "int | None" = None, block_iters: int = 12):
    """BiCGStab on the extended stencil operator with the fused kernels.

    Contract of the JAX ``fused_bicgstab_ext``: run blocks of
    ``block_iters`` iterations while the last history entry is finite and
    above ``max(tol*||b||, atol)^2`` and fewer than maxiter iterations ran;
    in the final block the first entry at or below that (breakdown codes
    are negative, so they count) gives ``iters = done - K + first + 1``;
    info is 0 if the true residual meets the threshold with the float32
    x10 relaxation, else the breakdown code, else -1. Returns (x, info,
    iters, res) with x in the original space.
    """
    if not supports_fused_bicgstab(op):
        raise ValueError("operator does not support the fused BiCGStab "
                         "kernels")
    if maxiter is None:
        maxiter = 10 * op.n
    b = b.to(torch.float32)
    b_norm = np.float32(
        tracing.host_read(torch.linalg.vector_norm(b)).item())
    thresh = np.maximum(np.float32(tol) * b_norm, np.float32(atol))
    thresh2 = thresh * thresh
    b_ext = op.extend(b)
    K = int(block_iters)
    state = FusedBiCGStabState(op, b_ext)
    hist = torch.empty(K, dtype=torch.float32, device=b.device)
    h = np.full(K, 3.0e38, dtype=np.float32)
    done, last = 0, np.float32(3.0e38)
    while last > thresh2 and done < maxiter and np.isfinite(last):
        with tracing.span("tsp.solver.block"):
            state.run(hist)
            h = tracing.host_read(hist).numpy()  # the one read per block
        tracing.SOLVER["iterations_run"] += K
        done += K
        last = h[K - 1]
    crossed = h <= thresh2
    first = int(np.argmax(crossed))
    iters = done - K + first + 1 if crossed.any() else done
    code = h[first]
    broke = bool(crossed.any()) and code < 0
    res = torch.linalg.vector_norm(b_ext - op(state.x))
    relax = np.float32(_final_check_relax(torch.float32))
    conv = (torch.isfinite(res) & (res <= float(thresh * relax))
            & torch.isfinite(torch.linalg.vector_norm(state.x)))
    info = torch.where(conv, 0, int(code) if broke else -1).to(torch.int32)
    iters_t = torch.full((), iters, dtype=torch.int32, device=b.device)
    return op.extract(state.x), info, iters_t, res
