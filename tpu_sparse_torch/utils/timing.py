"""Timing and profiling.

Counterpart of ``tpu_sparse/utils/timing.py``:

* ``force(tree)``: wait for the device to finish ``tree`` and return a
  checksum of its first leaf.
* ``wall_time(fn, *args)``: median host-clock seconds per call, dispatch
  included, completion forced.
* ``chain_time(op, v, K)``: seconds for K dependent applications of
  ``op`` (CUDA events around them on the card, the host clock on the
  CPU), the least of ``reps``.
* ``per_iter_time(op, v)``: seconds per application of ``op``, the slope
  between two chains, so fixed costs cancel.
* ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace into ``log_dir`` (with the card's kernels when
  there is one).

``cuda_times_ms(fn)`` runs ``fn`` for warm-up, then times ``reps`` rounds
of ``inner`` back-to-back calls between two CUDA events and returns the
milliseconds per call of each round; ``cuda_time_ms`` returns their median.
``cuda_flushed_times_ms(fn, flush)`` times each of ``calls`` calls alone,
the L2 flushed (``flush`` zeroed) before each: a small kernel's device
time, where back-to-back calls would time the host's enqueue rate.
These three need a CUDA device and never time on the host clock: a
number they return is a device time.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


def _on_cuda(tree: Any) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in pytree.tree_leaves(tree))


def force(tree: Any) -> float:
    """Block until ``tree`` is computed; returns a checksum scalar."""
    leaf = pytree.tree_leaves(tree)[0]
    if _on_cuda(tree):
        torch.cuda.synchronize()
    return float(torch.as_tensor(leaf).abs().sum())


def wall_time(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall seconds per call, dispatch included, completion forced."""
    for _ in range(warmup):
        force(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def chain_time(op: Callable, v: Any, K: int, reps: int = 3) -> float:
    """Total seconds for K dependent applications of ``op`` starting from
    ``v`` (the least of ``reps``, after one untimed chain): between CUDA
    events for a CUDA ``v``, on the host clock otherwise."""
    def chain():
        y = v
        for _ in range(K):
            y = op(y)
        return y

    cuda = _on_cuda(v)
    force(chain())
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            force(chain())
            times.append(time.perf_counter() - t0)
    return min(times)


def per_iter_time(op: Callable, v: Any, K1: int = 5, K2: int = 50) -> float:
    """Per-application seconds of a (shape-preserving) operator, with fixed
    costs cancelled by the K2 - K1 slope."""
    t1 = chain_time(op, v, K1)
    t2 = chain_time(op, v, K2)
    return max((t2 - t1) / (K2 - K1), 1e-12)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(),
                                      "tpu_sparse_torch_trace")):
    """Profile the enclosed block and write its Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir``; CUDA activity is recorded
    when a card is present. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 2, reps: int = 5,
                 inner: int = 10) -> float:
    return float(statistics.median(
        cuda_times_ms(fn, warmup=warmup, reps=reps, inner=inner)))


def cuda_times_ms(fn: Callable[[], object], *, warmup: int = 2,
                  reps: int = 5, inner: int = 10) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
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
    return times


def cuda_flushed_times_ms(fn: Callable[[], object], flush: torch.Tensor, *,
                          calls: int = 20) -> list:
    """Device ms of each of ``calls`` calls of ``fn`` after one warm-up,
    ``flush`` (a CUDA tensor larger than the L2) zeroed before each and
    CUDA events around the call alone."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_flushed_times_ms needs a CUDA device")
    fn()
    out = []
    for _ in range(calls):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return out
