"""The roofline byte formulas against PERF.md's kernel table."""

import _harness  # noqa: F401  (puts the checkout on sys.path)

from benchmark.core import roofline


def test_kernel1_bytes_at_160_cubed():
    # PERF.md's kernel table: kernel 1 on poisson3d_27pt(160) f32 moves
    # 475.1 MB (27 diagonals, x read, y written), bound 0.1418 ms
    b = roofline.spmv_bytes(160 ** 3, 27, 4)
    assert round(b / 1e6, 1) == 475.1
    assert abs(b / roofline.HBM_BYTES_PER_S * 1e3 - 0.1418) < 5e-5


def test_cg_iteration_bytes():
    # the diagonals once and x, r, p each read and written once
    n = 256 ** 3
    assert roofline.cg_iteration_bytes(n, 27, 4) == (27 + 6) * n * 4
    assert roofline.cg_iteration_bytes(n, 27, 4) - roofline.spmv_bytes(
        n, 27, 4) == 4 * n * 4


def test_share_pct():
    assert roofline.share_pct(3.35e12, 2.0) == 50.0
    assert roofline.share_pct(1.0, 0.0) is None
