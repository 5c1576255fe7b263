"""CWELL (general-structure) SpMV and SpMM on the H100: K4 / K5
(``csrc/cwell_spmv.cu``) and K6 / K7 (``csrc/cwell_spmm.cu``).

Counterpart of ``tpu_sparse/kernels/pallas_cwell.py``: ``cwell_spmv_cuda``
replaces ``cwell_spmv_pallas`` (K4, float32) and ``cwell_spmv_pallas_df``
(K5, float64 as double-f32 pairs on the TPU; here the native fp64 build of
the same kernel); ``cwell_spmm_cuda`` replaces ``cwell_spmm_pallas_gather``
(K6) and ``cwell_spmm_pallas`` (K7, the same SpMM through one-hot matrix
products), in float32 and float64. Both also take complex64 and
complex128 (the SpMV's complex builds in K5's design, plain loads), and
bf16 values with a float32 operand (output float32) or a bf16 one (output
bf16); the SpMM also float32 values with a bf16 B (output float32, as
JAX's K6 casts B to float32). A bf16 value streams at 2 bytes a slot
and is widened in registers, the sums run in float32, a bf16 output is
rounded once (the SpMV's bf16 builds in K4's design, the ring). They
take every pack, grouped ones included, and return no None: the TPU's
fallbacks for packs, operands or unrolls its VMEM could not hold are
gone.

All four stream the pack's row-compact plan (``sparse.cwell_compact``),
not its planes, and share it: one plan per pack structure, one value
gather per values tensor. Every path skips products whose matrix value
is 0, so a NaN or Inf in x or B reaches only the rows whose nonzeros
gather it; JAX's ``mode="fill"`` references multiply every padding slot,
which differs only where the operand is not finite. ``cwell_spmv`` /
``cwell_spmm`` launch the kernel for a CUDA operand and run the plain
PyTorch version (``reference.cwell_spmv`` / ``cwell_spmm``) for a CPU
one; nothing else selects between them. Launch counts are kept in
``LAUNCHES``, plan builds and value gathers in ``PLAN_COUNTS``.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.kernels.cuda_spmv import dtype_pairs
from tpu_sparse_torch.sparse import cwell_compact
from tpu_sparse_torch.sparse.cwell import CWELL, LW

# Launches of K4 (float32, complex64, bf16 values), K5 (float64,
# complex128) and K6/K7 (SpMM, every build), by build; counted where the
# kernel launches.
LAUNCHES = tracing.group("launches", {
    "cwell_spmv_f32": 0, "cwell_spmv_f64": 0, "cwell_spmv_c64": 0,
    "cwell_spmv_c128": 0, "cwell_spmv_bf16": 0, "cwell_spmv_bf16_f32": 0,
    "cwell_spmm_f32": 0, "cwell_spmm_f64": 0, "cwell_spmm_c64": 0,
    "cwell_spmm_c128": 0, "cwell_spmm_bf16": 0, "cwell_spmm_bf16_f32": 0,
    "cwell_spmm_f32_bf16": 0})
# Compact-plan builds and value gathers behind K4 - K7.
PLAN_COUNTS = cwell_compact.COUNTS

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128",
           torch.bfloat16: "bf16"}
# the builds, by (values dtype, operand dtype): each dtype with itself and
# bf16 values with a float32 operand; the SpMM also float32 values with a
# bf16 B
_SPMV_BUILDS = {**{(d, d): s for d, s in _SUFFIX.items()},
                (torch.bfloat16, torch.float32): "bf16_f32"}
_SPMM_BUILDS = {**_SPMV_BUILDS,
                (torch.float32, torch.bfloat16): "f32_bf16"}
# K6/K7's staged slot rows at most (csrc/cwell_spmm.cu: TS_SPMM_SMEM and
# ts_spmm_piece_cap)
_SPMM_SMEM = 46 * 1024


def _spmm_piece_cap(plan, value_bytes: int) -> int:
    slot = value_bytes + (4 if plan.wide else 2)
    window = 0 if plan.wide else plan.planes * 4
    return (_SPMM_SMEM - window) // (LW * slot)


def _check_operands(W: CWELL, x: torch.Tensor, what: str = "cwell_spmv_cuda",
                    ndim: int = 1) -> str:
    """Refuse what the kernels do not take; x is (m,) for the SpMV
    (ndim 1) and an (m, k) block for the SpMM (ndim 2). Returns the build's
    suffix."""
    builds = _SPMV_BUILDS if ndim == 1 else _SPMM_BUILDS
    n, m = W.shape
    tensors = (W.vals, W.idx2, W.srow, x)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what}: operands must be CUDA tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: operands on more than one device")
    sfx = builds.get((W.vals.dtype, x.dtype))
    if sfx is None:
        raise TypeError(
            f"{what}: the kernel takes values / operand dtypes "
            f"{dtype_pairs(builds)}; got {W.vals.dtype} values and a "
            f"{x.dtype} operand")
    if W.idx2.dtype != torch.int32 or W.srow.dtype != torch.int32:
        raise TypeError(f"{what}: idx2 and srow must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if (W.vals.dim() != 3 or W.vals.shape[2] != LW
            or W.idx2.shape != W.vals.shape
            or W.srow.shape != W.vals.shape[:2]):
        raise ValueError(
            f"{what}: vals and idx2 must be (n_blocks, S, {LW}) and srow "
            f"(n_blocks, S), got {tuple(W.vals.shape)}, "
            f"{tuple(W.idx2.shape)}, {tuple(W.srow.shape)}")
    nb = W.vals.shape[0]
    if n > nb * LW:
        raise ValueError(f"{what}: {nb} row blocks cannot hold {n} rows")
    if x.dim() != ndim or x.shape[0] != m:
        want = f"length {m}" if ndim == 1 else f"shape ({m}, k)"
        raise ValueError(f"{what}: the operand must have {want}, got "
                         f"{tuple(x.shape)}")
    return sfx


def cwell_spmv_cuda(W: CWELL, x: torch.Tensor) -> torch.Tensor:
    """y = W @ x by K4 (float32, complex64) or K5 (float64, complex128)
    for CUDA operands, on W's row-compact plan (``sparse.cwell_compact``:
    built once per pack structure, its values gathered once per values
    tensor). Slots of value 0 are skipped, so a NaN or Inf in x reaches
    only the rows whose nonzeros gather it. A conjugate view is read as
    its values."""
    from tpu_sparse_torch.kernels import _build

    x = x.resolve_conj()
    sfx = _check_operands(W, x)
    plan, cvals = cwell_compact.compact(W)
    n = W.shape[0]
    y = torch.empty(n, dtype=torch.promote_types(W.vals.dtype, x.dtype),
                    device=x.device)
    fn = getattr(_build.library(), "ts_cwell_spmv_" + sfx)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cvals.data_ptr(), plan.idx.data_ptr(), plan.srow.data_ptr(),
                plan.boff.data_ptr(), x.data_ptr(), y.data_ptr(),
                plan.n_blocks, plan.planes, n, int(plan.wide), stream)
    _build.check(rc, "cwell_spmv_cuda")
    LAUNCHES["cwell_spmv_" + sfx] += 1
    return y


def cwell_spmv(W: CWELL, x: torch.Tensor) -> torch.Tensor:
    """y = W @ x: K4/K5 for a CUDA ``x``; the plain version
    (``reference.cwell_spmv``) for a CPU ``x``."""
    if x.is_cuda:
        return cwell_spmv_cuda(W, x)
    return ref.cwell_spmv(W, x)


def cwell_spmm_cuda(W: CWELL, B: torch.Tensor) -> torch.Tensor:
    """Y = W @ B by K6/K7 (one CUDA kernel, real, complex or bf16) for
    CUDA operands, on the row-compact plan K4 / K5 use; B is a contiguous
    (m, k) block. Column j of Y equals ``cwell_spmv_cuda(W, B[:, j])`` bit
    for bit. A bf16 Y whose row blocks stage in more than one piece
    carries its sums through a float32 workspace, so it is rounded once,
    as K4's y is."""
    from tpu_sparse_torch.kernels import _build

    B = B.resolve_conj()
    sfx = _check_operands(W, B, "cwell_spmm_cuda", ndim=2)
    plan, cvals = cwell_compact.compact(W)
    n = W.shape[0]
    k = B.shape[1]
    Y = torch.empty((n, k), dtype=torch.promote_types(W.vals.dtype, B.dtype),
                    device=B.device)
    args = [cvals.data_ptr(), plan.idx.data_ptr(), plan.srow.data_ptr(),
            plan.boff.data_ptr(), B.data_ptr(), Y.data_ptr()]
    if sfx in ("bf16", "bf16_f32", "f32_bf16"):
        work = None
        if Y.dtype == torch.bfloat16 and plan.depth > _spmm_piece_cap(
                plan, cvals.element_size()):
            work = torch.empty((n, k), dtype=torch.float32, device=B.device)
        args.append(0 if work is None else work.data_ptr())
    fn = getattr(_build.library(), "ts_cwell_spmm_" + sfx)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, plan.n_blocks, plan.planes, n, k, plan.depth,
                int(plan.wide), stream)
    _build.check(rc, "cwell_spmm_cuda")
    LAUNCHES["cwell_spmm_" + sfx] += 1
    return Y


def cwell_spmm(W: CWELL, B: torch.Tensor) -> torch.Tensor:
    """Y = W @ B: K6/K7 for a CUDA ``B``; the plain version
    (``reference.cwell_spmm``) for a CPU ``B``."""
    if B.is_cuda:
        return cwell_spmm_cuda(W, B)
    return ref.cwell_spmm(W, B)
