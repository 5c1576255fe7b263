"""Peaks of the card and the least bytes a kernel's work needs.

Peaks: NVIDIA's data sheet for one H100 SXM (80 GB HBM3) at its 700 W
limit. Bytes count each input read once and each output written once, at
the matrix's dtype, whatever a kernel reads again; work that depends on
the data (iterations) is counted as these inputs needed it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "tf32": 495e12,
              "bfloat16": 989e12}


def spmv_bytes(rows: int, ndiag: int, itemsize: int) -> int:
    """One DIA SpMV (kernel 1): the stored diagonals, x read, y written."""
    return (ndiag + 2) * rows * itemsize


def cg_iteration_bytes(rows: int, ndiag: int, itemsize: int) -> int:
    """One CG iteration on a DIA matrix: the stored diagonals read once,
    and each of x, r and p read once and written once."""
    return (ndiag + 6) * rows * itemsize


def share_pct(nbytes: float, seconds: float) -> "float | None":
    """Percent of the HBM roofline: the least time the bytes need over the
    time they took. None when there is no time to divide by."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
