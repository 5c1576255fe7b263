"""solver.refine_fused_pct: the share of the mixed-precision refinement's
sweeps whose inner solve ran the fused CG kernels 2-3: 100 x
``refine.fused_sweeps`` / ``refine.sweeps``, the counters summed over the
traced window's ``tsp.solve`` records. None from a program without the
``refine.fused_sweeps`` counter, or with no sweep."""


def read(run):
    try:
        from tpu_sparse_torch import tracing
    except ImportError:
        return None
    if "refine.fused_sweeps" not in tracing.counters():
        return None
    roots = tracing.solves()[-len(run.solves):] if run.solves else []
    fused, sweeps = (
        sum((r.counters or {}).get(f"refine.{k}", 0) for r in roots)
        for k in ("fused_sweeps", "sweeps"))
    return 100.0 * fused / sweeps if sweeps else None
