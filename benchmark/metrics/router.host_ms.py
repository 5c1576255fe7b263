"""router.host_ms: the host ms a solve spends in the router itself
(``SparseSolver.solve`` outside its solver loop and its cache builds):
the median over the traced window's solves of the self time of the
program's ``tsp.solve`` span (``tpu_sparse_torch.tracing``). None from a
program without spans."""

import statistics


def read(run):
    try:
        from tpu_sparse_torch import tracing
    except ImportError:
        return None
    roots = tracing.solves()[-len(run.solves):]
    if not run.solves or len(roots) < len(run.solves):
        return None
    return statistics.median(tracing.self_ns(r) / 1e6 for r in roots)
