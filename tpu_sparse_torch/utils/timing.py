"""Device timing with CUDA events.

``cuda_times_ms(fn)`` runs ``fn`` for warm-up, then times ``reps`` rounds
of ``inner`` back-to-back calls between two CUDA events and returns the
milliseconds per call of each round; ``cuda_time_ms`` returns their median.
They need a CUDA device and never time on the host clock: a number they
return is a device time.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


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
