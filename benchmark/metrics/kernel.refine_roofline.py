"""kernel.refine_roofline: the mixed-precision refinement's share of the
HBM roofline. Its least bytes (``core.refine_roofline``: the reported
inner iterations as float32 CG iterations, and one outer residual product
in the matrix's dtype a sweep, the sweeps read from the program's
``refine.sweeps`` counters) over the traced solves, against the union of
the device kernel intervals the profiler saw in the window. None off the
card, without a trace, or from a program without the refinement's
counters."""

from benchmark.core import refine_roofline, roofline


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" or not t.kernel_s:
        return None
    counts = refine_roofline.sweeps(run)
    if counts is None:
        return None
    iters = sum(s["iterations"] or 0 for s in run.solves)
    nbytes = refine_roofline.refine_bytes(run.rows, run.ndiag, run.itemsize,
                                          iters, sum(counts))
    return roofline.share_pct(nbytes, t.kernel_s)
