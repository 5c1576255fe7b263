"""solve_ms_p90: the 90th percentile (inclusive quantiles) of the wall
time of every solve in the window, each from its call to the synchronize
after x is back and its report read. Host clock."""

import statistics


def read(run):
    walls = [s["wall_s"] * 1000.0 for s in run.solves]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
