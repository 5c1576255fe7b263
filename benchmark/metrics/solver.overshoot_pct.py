"""solver.overshoot_pct: iterations the solver loops ran past those the
solves report, in percent of the reported: 100 x (the sum of the
``solver.iterations_run`` counter over the traced window's ``tsp.solve``
records - the sum of their reported iterations) / the reported. A fused
block runs all its K iterations; a masked iteration of a torch-op loop
runs in full. None from a program without spans."""


def read(run):
    try:
        from tpu_sparse_torch import tracing
    except ImportError:
        return None
    roots = tracing.solves()[-len(run.solves):]
    if not run.solves or len(roots) < len(run.solves) or any(
            r.attrs.get("iterations") is None for r in roots):
        return None
    reported = sum(r.attrs["iterations"] for r in roots)
    ran = sum(r.counters.get("solver.iterations_run", 0) for r in roots)
    return 100.0 * (ran - reported) / reported if reported else None
