"""solver.refine_sweeps: the mean over the traced window's solves of the
``refine.sweeps`` counter of their ``tsp.solve`` records: the float32
sweeps of the mixed-precision refinement (``solvers.mixed``) that ran an
inner solve. None from a program without spans or without the
refinement's counters."""

import statistics

from benchmark.core import refine_roofline


def read(run):
    counts = refine_roofline.sweeps(run)
    return statistics.fmean(counts) if counts else None
