"""solve_ms: the window's seconds x 1000 over the solves completed in it
(converged; a failed solve counts in ``attempted`` and ``failed`` only).
Host clock, the card synchronized after each solve."""


def read(run):
    done = sum(1 for s in run.solves if s["converged"])
    if not done or not run.window_s:
        return None
    return run.window_s * 1000.0 / done
