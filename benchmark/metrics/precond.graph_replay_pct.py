"""precond.graph_replay_pct: the share of the AMG preconditioner's applies
on the card that replayed a captured CUDA graph of the V-cycle: 100 x
``precond.graph_replays`` / (``graph_replays`` + ``graph_captures`` +
``graph_eager``), the counters summed over the traced window's
``tsp.solve`` records. None from a program without those counters, or
with no apply on the card."""


def read(run):
    try:
        from tpu_sparse_torch import tracing
    except ImportError:
        return None
    roots = tracing.solves()[-len(run.solves):] if run.solves else []
    replays, captures, eager = (
        sum((r.counters or {}).get(f"precond.graph_{k}", 0) for r in roots)
        for k in ("replays", "captures", "eager"))
    applies = replays + captures + eager
    return 100.0 * replays / applies if applies else None
