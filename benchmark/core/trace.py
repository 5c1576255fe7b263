"""Profiler traces and CUDA-event timings, reduced to what the metrics read.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` inside a
``bench.window`` annotation, writes the Chrome trace under ``TMPDIR``,
reads it back and deletes it. ``summarize`` reduces the events to:

* ``window_s``: the annotation's length on the host clock;
* ``busy_s``: the union of device operations (kernels, copies, sets) that
  fall inside the window;
* ``kernel_s``: the union of kernels, leaving out those whose name starts
  with a prefix in ``exclude`` (NCCL's, which spin while they wait);
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the idle time between device operations, by the innermost
  host operation running at each gap's midpoint, the ten largest.

``cuda_ms`` and ``count_kernels`` serve the readers that time a layer
alone after the window.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import statistics
import tempfile
from collections import defaultdict
from dataclasses import dataclass

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list
    idle_gaps: list


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def _top(totals: dict, k: int = 10) -> list:
    return [[n, s] for n, s in sorted(totals.items(), key=lambda t: -t[1])
            [:k]]


def summarize(events: list, exclude=("nccl",)) -> "Trace | None":
    """The window's numbers from Chrome-trace events (times in us)."""
    spans = [e for e in events if e.get("ph") == "X"]
    window = [e for e in spans if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        return None
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev, kern, by_name = [], [], defaultdict(float)
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= w0 or a >= w1:
            continue
        dev.append((a, b))
        by_name[e["name"]] += (min(b, w1) - max(a, w0)) * 1e-6
        if e["cat"] == "kernel" and not e["name"].lower().startswith(
                tuple(exclude)):
            kern.append((a, b))
    busy = _union(_clip(dev, w0, w1))
    kernel = _union(_clip(kern, w0, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["name"]) for e in spans
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    gaps, edge = defaultdict(float), w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid = 0.5 * (a + edge)
            name = "host: no traced op (Python)"
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(-1, j - 5000), -1):
                if host[k][1] >= mid:
                    name = host[k][2]
                    break
            gaps[name] += (a - edge) * 1e-6
        edge = max(edge, b)
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernel_s=sum(b - a for a, b in kernel) * 1e-6,
                 device_ops=_top(by_name),
                 idle_gaps=_top(gaps))


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, events


def profiled(fn, exclude=("nccl",)):
    """(fn's result, Trace of its window)."""
    out, events = _profile(fn)
    return out, summarize(events, exclude)


def count_kernels(fn, calls: int) -> "float | None":
    """Device kernels per call of ``fn`` over ``calls`` calls, from the
    profiler (None without a card)."""
    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(calls):
            fn()

    _, events = _profile(body)
    n = sum(1 for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel")
    return n / calls


def cuda_ms(fn, inner: int = 10, reps: int = 5, warmup: int = 1
            ) -> "float | None":
    """Median device ms per call of ``fn``: ``reps`` rounds of ``inner``
    back-to-back calls between two CUDA events (None without a card)."""
    if not torch.cuda.is_available():
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)
