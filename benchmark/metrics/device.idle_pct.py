"""device.idle_pct: the share of the traced window (rank 0's on several
chips) in which no operation ran on the card. None off the card."""


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
