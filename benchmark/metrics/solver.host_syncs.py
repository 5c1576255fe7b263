"""solver.host_syncs: the mean over the traced window's solves of the
``solver.host_syncs`` counter of their ``tsp.solve`` records: the reads
of the solver's device state by the host (each drains the card's queue),
the result's read included. None from a program without spans."""

import statistics


def read(run):
    try:
        from tpu_sparse_torch import tracing
    except ImportError:
        return None
    roots = tracing.solves()[-len(run.solves):]
    if not run.solves or len(roots) < len(run.solves):
        return None
    return statistics.fmean(r.counters.get("solver.host_syncs", 0)
                            for r in roots)
