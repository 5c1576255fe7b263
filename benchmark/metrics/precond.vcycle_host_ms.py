"""precond.vcycle_host_ms: the host's ms to enqueue one V-cycle: the
median wall time of the program's ``tsp.precond.vcycle`` spans inside the
traced window's solves (profiler on, so each torch op pays its record).
Beside ``precond.vcycle_ms`` (the device's ms of one V-cycle): above it,
the V-cycle is bound by its launches. None from a program without spans."""

import statistics


def read(run):
    try:
        from tpu_sparse_torch import tracing
    except ImportError:
        return None
    roots = tracing.solves()[-len(run.solves):] if run.solves else []
    ids = {r.solve_id for r in roots}
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in tracing.spans()
          if r.name == "tsp.precond.vcycle" and r.solve_id in ids]
    return statistics.median(ms) if ms else None
