"""Capability detection and reporting.

Counterpart of ``tpu_sparse/api/availability.py``: the ``krylov``,
``amg`` and ``direct`` backends, the CUDA kernels and the distributed
solvers (``tpu_sparse_torch.dist``, one process per card). No probe result
is cached, so a transient failure is never pinned for the life of the
process (the fault R1 that the JAX probes' ``lru_cache`` had).
"""

from __future__ import annotations

from typing import Dict, List

import torch


def check_krylov_available() -> bool:
    """Iterative solvers run on every device torch offers."""
    try:
        import tpu_sparse_torch.solvers  # noqa: F401
    except ImportError:
        return False
    return True


def check_amg_available() -> bool:
    """AMG: a live probe, as in the JAX package: the hierarchy of a
    16-unknown Poisson matrix on the CPU and one V-cycle. It builds the
    host C++ set-up on first use, so a missing compiler shows here."""
    try:
        from tpu_sparse_torch.precond.amg import amg_preconditioner
        from tpu_sparse_torch.sparse.generators import poisson2d

        A = poisson2d(4, device="cpu")
        M = amg_preconditioner(A, coarse_size=4)
        return bool(torch.all(torch.isfinite(M(torch.ones(16,
                                                          dtype=A.dtype)))))
    except Exception:
        return False


def check_direct_available() -> bool:
    """Direct solvers: a live probe, as in the JAX package: a 3 x 3
    tridiagonal solve on the CPU."""
    try:
        from tpu_sparse_torch.direct import banded_solve
        from tpu_sparse_torch.sparse.generators import tridiagonal

        A = tridiagonal(3, device="cpu")
        x = banded_solve(A, torch.ones(3, dtype=A.dtype))
        return bool(torch.all(torch.isfinite(x)))
    except Exception:
        return False


def check_cuda_available() -> bool:
    return torch.cuda.is_available()


def device_count() -> int:
    """The CUDA devices this process sees, or 1 (the host) without any."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def check_distributed_available() -> bool:
    """The distributed solvers need ``torch.distributed`` and more than one
    device (JAX: ``device_count() > 1``)."""
    return torch.distributed.is_available() and device_count() > 1


def get_available_backends() -> List[str]:
    out = ["krylov"] if check_krylov_available() else []
    if check_amg_available():
        out.append("amg")
    if check_direct_available():
        out.append("direct")
    return out


def availability_dict() -> Dict[str, bool]:
    return {
        "krylov": check_krylov_available(),
        "amg": check_amg_available(),
        "direct": check_direct_available(),
        "cuda": check_cuda_available(),
        "distributed": check_distributed_available(),
    }


def print_availability_report(verbose: bool = True) -> Dict[str, bool]:
    """Human-readable capability report."""
    avail = availability_dict()
    device = (torch.cuda.get_device_name(0) if avail["cuda"] else "cpu")
    lines = [
        "tpu_sparse_torch capability report",
        "=" * 40,
        f"  device             : {device}",
        f"  devices            : {device_count()}",
        f"  krylov solvers     : {'yes' if avail['krylov'] else 'NO'}",
        f"  AMG preconditioner : {'yes' if avail['amg'] else 'NO'}",
        f"  direct solvers     : {'yes' if avail['direct'] else 'NO'}",
        f"  CUDA kernels       : {'yes' if avail['cuda'] else 'no (plain CPU path)'}",
        f"  multi-device       : {'yes' if avail['distributed'] else 'no'}",
    ]
    if verbose:
        print("\n".join(lines))
    return avail
