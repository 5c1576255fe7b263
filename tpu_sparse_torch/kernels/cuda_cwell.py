"""CWELL (general-structure) SpMV on the H100: K4 and K5
(``csrc/cwell_spmv.cu``).

Counterpart of ``tpu_sparse/kernels/pallas_cwell.py``: ``cwell_spmv_cuda``
replaces ``cwell_spmv_pallas`` (K4, float32) and ``cwell_spmv_pallas_df``
(K5, float64 as double-f32 pairs on the TPU; here the native fp64 build of
the same kernel). It takes every pack, grouped ones included, and returns
no None: the TPU's fallbacks for packs its VMEM could not hold are gone.

``cwell_spmv`` launches the kernel for a CUDA ``x`` and runs the plain
PyTorch version (``reference.cwell_spmv``) for a CPU ``x``; nothing else
selects between them. Launch counts are kept in ``LAUNCHES``.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse.cwell import CWELL, LW

# Launches of K4 (float32) and K5 (float64); counted where the kernel
# launches.
LAUNCHES = {"cwell_spmv_f32": 0, "cwell_spmv_f64": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_operands(W: CWELL, x: torch.Tensor) -> str:
    what = "cwell_spmv_cuda"
    n, m = W.shape
    tensors = (W.vals, W.idx2, W.srow, x)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what}: operands must be CUDA tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: operands on more than one device")
    if W.vals.dtype not in _SUFFIX or x.dtype != W.vals.dtype:
        raise TypeError(
            f"{what}: the kernel takes float32 or float64 values and x of "
            f"the same dtype, got {W.vals.dtype} and {x.dtype}")
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
    if x.dim() != 1 or x.shape[0] != m:
        raise ValueError(f"{what}: x must have length {m}, got "
                         f"{tuple(x.shape)}")
    return _SUFFIX[x.dtype]


def cwell_spmv_cuda(W: CWELL, x: torch.Tensor) -> torch.Tensor:
    """y = W @ x by K4 (float32) or K5 (float64) for CUDA operands."""
    from tpu_sparse_torch.kernels import _build

    sfx = _check_operands(W, x)
    n, m = W.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    lib = _build.library()
    fn = lib.ts_cwell_spmv_f32 if sfx == "f32" else lib.ts_cwell_spmv_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(W.vals.data_ptr(), W.idx2.data_ptr(), W.srow.data_ptr(),
                x.data_ptr(), y.data_ptr(), W.vals.shape[0], W.vals.shape[1],
                n, m, stream)
    _build.check(rc, "cwell_spmv_cuda")
    LAUNCHES["cwell_spmv_" + sfx] += 1
    return y


def cwell_spmv(W: CWELL, x: torch.Tensor) -> torch.Tensor:
    """y = W @ x: K4/K5 for a CUDA ``x``; the plain version
    (``reference.cwell_spmv``) for a CPU ``x``."""
    if x.is_cuda:
        return cwell_spmv_cuda(W, x)
    return ref.cwell_spmv(W, x)
