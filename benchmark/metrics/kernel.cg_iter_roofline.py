"""kernel.cg_iter_roofline: the CG iteration's share of the HBM roofline.
The least bytes an iteration needs on this card's rows (the stored
diagonals once, x, r and p each read and written once, at the matrix's
dtype) times the iterations reported over the traced solves, against the
union of the device kernel intervals the profiler saw in the window
(NCCL's kernels left out: they spin while they wait). None off the card
or without a trace."""

from benchmark.core import roofline


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" or not t.kernel_s:
        return None
    iters = sum(s["iterations"] or 0 for s in run.solves)
    nbytes = roofline.cg_iteration_bytes(run.rows, run.ndiag,
                                         run.itemsize) * iters
    return roofline.share_pct(nbytes, t.kernel_s)
