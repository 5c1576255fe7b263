"""Format promotion for the card: ``to_gpu_operator``.

Counterpart of ``tpu_sparse/sparse/optimize.py::to_tpu_operator``, with
its thresholds and its order:

1. few distinct diagonals (at most ``max_diags``)  -> DIA (kernel 1 and the
   fused Krylov kernels);
2. column locality (CWELL fill >= ``min_cwell_fill``) -> CWELL (K4 / K5);
3. dense 8 x 8 blocks (block fill >= ``min_block_fill``) -> BELL, which is
   not ported yet: NotImplementedError naming ROADMAP queue 1, item 11;
4. otherwise -> CSR (the plain scatter-add SpMV).

Two TPU workarounds are not carried over: the ``m > 1.5M`` column split
into ``CWELLSeg`` (the TPU kernel kept x in VMEM; K4 gathers x from device
memory at any width) and ``group="auto"`` (the packs here use ``group=1``).
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.sparse.containers import CSR, DIA
from tpu_sparse_torch.sparse.convert import csr_to_dia, to_csr
from tpu_sparse_torch.sparse.cwell import CWELL, CWELLSeg, csr_to_cwell


def _block_fill_ratio(A: CSR, bs: int) -> float:
    """nnz / (occupied bs x bs blocks * bs^2)."""
    rows = A.row_ids().long()
    keys = (rows // bs) * ((A.shape[1] + bs - 1) // bs) \
        + A.indices.long() // bs
    return A.nnz / (torch.unique(keys).numel() * bs * bs)


def to_gpu_operator(A, *, max_diags: int = 64, block_size: int = 8,
                    min_block_fill: float = 0.35,
                    min_cwell_fill: float = 0.25,
                    verbose: bool = False):
    """Promote ``A`` to the fastest format the port runs on the card: DIA,
    CWELL or CSR (the counterpart of JAX ``to_tpu_operator``)."""
    if isinstance(A, (DIA, CWELL, CWELLSeg)):
        return A
    Ac = to_csr(A)
    n, m = Ac.shape

    dia = csr_to_dia(Ac, max_diags=max_diags)
    if dia is not None:
        if verbose:
            print(f"[to_gpu_operator] DIA with {dia.ndiag} diagonals")
        return dia

    cw = csr_to_cwell(Ac)
    if cw.fill >= min_cwell_fill:
        if verbose:
            print(f"[to_gpu_operator] CWELL fill={cw.fill:.2f} "
                  f"S={cw.planes}")
        return cw

    if n % block_size == 0 and m % block_size == 0 \
            and _block_fill_ratio(Ac, block_size) >= min_block_fill:
        raise NotImplementedError(
            "this matrix promotes to BELL (dense blocks), which is not "
            "ported yet: ROADMAP queue 1, item 11 (BELL, K8)")

    if verbose:
        print(f"[to_gpu_operator] CSR general path "
              f"(CWELL fill below {min_cwell_fill})")
    return Ac
