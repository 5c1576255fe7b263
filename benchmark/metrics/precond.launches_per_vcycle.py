"""precond.launches_per_vcycle: device kernels per V-cycle of the router's
cached AMG hierarchy, counted by the profiler over 5 applies after the
window."""

from benchmark.core import trace


def read(run):
    M = run.program.amg_preconditioner(run.A)
    b = run.pool[0]
    if run.device.type != "cuda":
        M(b)   # the path runs in a rehearsal; no device number off the card
        return None
    return trace.count_kernels(lambda: M(b), calls=5)
