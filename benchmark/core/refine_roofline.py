"""The least bytes of the mixed-precision refinement
(``tpu_sparse_torch.solvers.mixed``), and its sweeps as the program counts
them.

The bytes count the work the refinement needs, whatever runs it: each
reported inner iteration one float32 CG iteration on the matrix cast to
float32 (``roofline.cg_iteration_bytes`` at 4 bytes), and each sweep one
outer residual of its update in the matrix's dtype (``roofline.spmv_bytes``:
the diagonals and x read, the product written). x0 = 0 makes the first
residual b, which needs no product.
"""

from __future__ import annotations

from benchmark.core import roofline

INNER_ITEMSIZE = 4   # the sweeps run in float32


def refine_bytes(rows: int, ndiag: int, itemsize: int,
                 inner_iterations: int, sweeps: int) -> int:
    """Least bytes of refinements that ran ``inner_iterations`` float32
    iterations in all over ``sweeps`` sweeps, the outer residuals at
    ``itemsize`` bytes."""
    return (roofline.cg_iteration_bytes(rows, ndiag, INNER_ITEMSIZE)
            * inner_iterations
            + roofline.spmv_bytes(rows, ndiag, itemsize) * sweeps)


def sweeps(run) -> "list | None":
    """The ``refine.sweeps`` counter of each traced solve's ``tsp.solve``
    record (``tpu_sparse_torch.tracing``). None from a program without
    spans or without the refinement's counters."""
    try:
        from tpu_sparse_torch import tracing
    except ImportError:
        return None
    if "refine.sweeps" not in tracing.counters():
        return None
    roots = tracing.solves()[-len(run.solves):] if run.solves else []
    if not run.solves or len(roots) < len(run.solves):
        return None
    return [(r.counters or {}).get("refine.sweeps", 0) for r in roots]
