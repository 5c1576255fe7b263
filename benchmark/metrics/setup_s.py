"""setup_s: seconds from the start of the process (the launcher's, on
several chips) to the start of the window: imports, the kernels' build on
a checkout's first run, the matrix and pool, the program's set-up (AMG
hierarchy, shards) and the warm-up solves. Host clock."""


def read(run):
    return run.setup_s
