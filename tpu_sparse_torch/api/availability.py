"""Capability detection and reporting.

Counterpart of ``tpu_sparse/api/availability.py``. This slice offers the
``krylov`` backend only; AMG and direct solvers are later queue items.
No probe result is cached, so a transient failure is never pinned for the
life of the process (the fault R1 that the JAX probes' ``lru_cache`` had).
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


def check_cuda_available() -> bool:
    return torch.cuda.is_available()


def get_available_backends() -> List[str]:
    return ["krylov"] if check_krylov_available() else []


def availability_dict() -> Dict[str, bool]:
    return {
        "krylov": check_krylov_available(),
        "amg": False,
        "direct": False,
        "cuda": check_cuda_available(),
        "distributed": False,
    }


def print_availability_report(verbose: bool = True) -> Dict[str, bool]:
    """Human-readable capability report."""
    avail = availability_dict()
    device = (torch.cuda.get_device_name(0) if avail["cuda"] else "cpu")
    lines = [
        "tpu_sparse_torch capability report",
        "=" * 40,
        f"  device             : {device}",
        f"  krylov solvers     : {'yes' if avail['krylov'] else 'NO'}",
        "  AMG preconditioner : not in this slice",
        "  direct solvers     : not in this slice",
        f"  CUDA kernels       : {'yes' if avail['cuda'] else 'no (plain CPU path)'}",
    ]
    if verbose:
        print("\n".join(lines))
    return avail
