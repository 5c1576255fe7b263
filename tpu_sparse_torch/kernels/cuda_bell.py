"""Block-ELL SpMM on the H100: K8 (``csrc/bell_spmm.cu``).

Counterpart of ``tpu_sparse/kernels/pallas_bell.py``: ``bell_spmm_cuda``
replaces ``bell_spmm_pallas`` (K8), in float32 (float FMAs, no TF32: the
TPU kernel multiplied at HIGHEST precision) and float64. The TPU's limits
are gone: no padding of k to 128, no VMEM cap on B, no ``bs % 8`` rule;
the kernel takes any block size up to 64 and refuses larger ones, whose
staged blocks would not fit its shared memory.

``bell_spmm`` launches the kernel for a CUDA ``B`` and runs the plain
PyTorch version (``reference.bell_spmm``) for a CPU ``B``; nothing else
selects between them. A BELL SpMV is K4 on the cached CWELL repack
(``kernels.spmv``), not this kernel. Launch counts are kept in
``LAUNCHES``.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse.bell import BELL

MAX_BLOCKSIZE = 64  # TS_BELL_STAGE / 64 ** 2 = one block staged at a time

# Launches of K8, by dtype; counted where the kernel launches.
LAUNCHES = {"bell_spmm_f32": 0, "bell_spmm_f64": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_operands(A: BELL, B: torch.Tensor) -> str:
    what = "bell_spmm_cuda"
    tensors = (A.blocks, A.indices, B)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what}: operands must be CUDA tensors")
    if any(t.device != B.device for t in tensors):
        raise ValueError(f"{what}: operands on more than one device")
    if A.blocks.dtype not in _SUFFIX or B.dtype != A.blocks.dtype:
        raise TypeError(
            f"{what}: the kernel takes float32 or float64 blocks and B of "
            f"the same dtype, got {A.blocks.dtype} and {B.dtype}")
    if A.indices.dtype != torch.int32:
        raise TypeError(f"{what}: indices must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if A.blocks.dim() != 4 or A.blocks.shape[2] != A.blocks.shape[3] \
            or A.indices.shape != A.blocks.shape[:2]:
        raise ValueError(
            f"{what}: blocks must be (n_block_rows, L, bs, bs) and indices "
            f"(n_block_rows, L), got {tuple(A.blocks.shape)} and "
            f"{tuple(A.indices.shape)}")
    bs = A.blocksize
    if bs > MAX_BLOCKSIZE:
        raise ValueError(f"{what}: block size {bs} exceeds the kernel's "
                         f"{MAX_BLOCKSIZE}")
    n, m = A.shape
    if n != A.n_block_rows * bs or m % bs:
        raise ValueError(f"{what}: shape {A.shape} does not match "
                         f"{A.n_block_rows} block rows of size {bs}")
    if B.dim() != 2 or B.shape[0] != m:
        raise ValueError(f"{what}: B must have shape ({m}, k), got "
                         f"{tuple(B.shape)}")
    return _SUFFIX[B.dtype]


def bell_spmm_cuda(A: BELL, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B by K8 for CUDA operands; B is a contiguous (m, k) block."""
    from tpu_sparse_torch.kernels import _build

    sfx = _check_operands(A, B)
    k = B.shape[1]
    Y = torch.empty((A.shape[0], k), dtype=B.dtype, device=B.device)
    lib = _build.library()
    fn = lib.ts_bell_spmm_f32 if sfx == "f32" else lib.ts_bell_spmm_f64
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(A.blocks.data_ptr(), A.indices.data_ptr(), B.data_ptr(),
                Y.data_ptr(), A.n_block_rows, A.ell_width, A.blocksize,
                A.shape[1], k, stream)
    _build.check(rc, "bell_spmm_cuda")
    LAUNCHES["bell_spmm_" + sfx] += 1
    return Y


def bell_spmm(A: BELL, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B: K8 for a CUDA ``B``; the plain version
    (``reference.bell_spmm``) for a CPU ``B``."""
    if B.is_cuda:
        return bell_spmm_cuda(A, B)
    return ref.bell_spmm(A, B)
