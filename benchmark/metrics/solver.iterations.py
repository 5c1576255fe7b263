"""solver.iterations: the mean of the iterations the program reports
(``SolverResult.iterations``; the ``iters`` of ``distributed_cg``) over the
traced window's solves."""

import statistics


def read(run):
    its = [s["iterations"] for s in run.solves if s["iterations"] is not None]
    return statistics.fmean(its) if its else None
