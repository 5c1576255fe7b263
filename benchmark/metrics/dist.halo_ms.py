"""dist.halo_ms: device ms of one halo exchange of this rank's rows on the
window's partition (``dist.spmv._halo_fill``, as ``dist.scaling_probe``
times it), CUDA events, median of 5 rounds of 20; rank 0's. Every rank
runs it (it is collective)."""

from benchmark.core import trace


def read(run):
    if run.world < 2:
        return None
    x = run.pool[0][run.rank * run.rows:(run.rank + 1) * run.rows].contiguous()
    exchange = run.program.halo_exchange(run.A, x)
    if run.device.type != "cuda":
        exchange()
        return None
    return trace.cuda_ms(exchange, inner=20, reps=5)
