"""The trace reduction on synthetic Chrome-trace events (times in us)."""

import _harness  # noqa: F401  (puts the checkout on sys.path)
import pytest

from benchmark.core import trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize():
    events = [
        _ev(trace.WINDOW, "user_annotation", 0.0, 100.0),
        _ev("k1", "kernel", 10.0, 20.0),
        _ev("k1", "kernel", 25.0, 10.0),          # overlaps the first
        _ev("ncclDevKernel_SendRecv", "kernel", 50.0, 20.0),
        _ev("Memcpy DtoH", "gpu_memcpy", 90.0, 20.0),   # runs past the end
        _ev("k0", "kernel", -10.0, 5.0),           # before the window
        _ev("aten::add", "cpu_op", 36.0, 10.0),     # inside the gap 35..50
        _ev("cudaLaunchKernel", "cuda_runtime", 40.0, 4.0),
    ]
    t = trace.summarize(events)
    assert t.window_s == pytest.approx(100e-6)
    # busy: 10..35, 50..70, 90..100 -> 55 us
    assert t.busy_s == pytest.approx(55e-6)
    # kernels without NCCL's: 10..35
    assert t.kernel_s == pytest.approx(25e-6)
    gaps = dict(t.idle_gaps)
    # 0..10 and 70..90 have no host op; 35..50 is inside aten::add, and the
    # innermost op at its midpoint (42.5) is cudaLaunchKernel
    assert gaps["cudaLaunchKernel"] == pytest.approx(15e-6)
    assert gaps["host: no traced op (Python)"] == pytest.approx(30e-6)
    ops = dict(t.device_ops)
    assert ops["k1"] == pytest.approx(30e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(10e-6)
    assert "k0" not in ops


def test_no_window_no_trace():
    assert trace.summarize([_ev("k", "kernel", 0.0, 1.0)]) is None
