"""precond.vcycle_ms: device ms of one V-cycle of the router's cached AMG
hierarchy on a fine-level vector (the pool's first b), CUDA events around
the benchmark's own calls after the window, median of 5 rounds of 5."""

from benchmark.core import trace


def read(run):
    M = run.program.amg_preconditioner(run.A)
    b = run.pool[0]
    if run.device.type != "cuda":
        M(b)   # the path runs in a rehearsal; no device number off the card
        return None
    return trace.cuda_ms(lambda: M(b), inner=5, reps=5)
